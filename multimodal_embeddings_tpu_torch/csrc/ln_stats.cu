// Row statistics of a LayerNorm for Hopper (sm_90a):
//
//   m    = sum(x[r, :]) / D,  m2 = sum(x[r, :]^2) / D      f32
//   var  = max(m2 - m * m, 0)
//   mean[r] = m,  rstd[r] = rsqrt(var + eps)                 f32 outputs
//
// over the rows of a (rows, D) array in bf16 or f32. Replaces the Pallas TPU
// kernel `_ln_stats_kernel` (ln_stats) of
// multimodal_embeddings_tpu/kernels/ln_stats.py: the statistics half of
// FastLayerNorm (flax's one-pass formula); the normalise and the affine stay
// elementwise tensor code.
//
// What bounds it on this card: it reads each input byte once and does 3
// flops per element, far below the H100's ~295 flops per HBM byte, so HBM
// bandwidth bounds it. The design is a pure streaming reduction: one warp a
// row, 16-byte loads (8 bf16 or 4 f32 per lane) in flight across the row,
// f32 sums reduced with warp shuffles, 8 rows (warps) a block so that tens of
// thousands of rows spread over every SM. The TPU kernel's row-block size and
// VMEM budget (pick_row_block) have no counterpart: a warp holds no row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one row each

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void add(float& s, float& s2, float v) {
  s += v;
  s2 = fmaf(v, v, s2);
}

__device__ __forceinline__ void add8(float& s, float& s2, uint4 u, const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    add(s, s2, __uint_as_float(w[j] << 16));
    add(s, s2, __uint_as_float(w[j] & 0xffff0000u));
  }
}

__device__ __forceinline__ void add8(float& s, float& s2, uint4 u, const float*) {
  add(s, s2, __uint_as_float(u.x));
  add(s, s2, __uint_as_float(u.y));
  add(s, s2, __uint_as_float(u.z));
  add(s, s2, __uint_as_float(u.w));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                    float* __restrict__ rstd, long long rows, int D, float eps,
                    bool vec) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const T* row = x + r * D;
  float s = 0.f, s2 = 0.f;
  constexpr int PER = 16 / sizeof(T);  // elements per 16-byte load
  if (vec) {
    for (int k = lane * PER; k < D; k += 32 * PER)
      add8(s, s2, *reinterpret_cast<const uint4*>(row + k), row);
  } else {
    for (int k = lane; k < D; k += 32) add(s, s2, to_f32(row[k]));
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float m = __fdiv_rn(s, (float)D), m2 = __fdiv_rn(s2, (float)D);
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.f);
    mean[r] = m;
    rstd[r] = 1.f / sqrtf(__fadd_rn(var, eps));
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x is (rows, D) contiguous; mean and rstd
// have rows f32 values. vec = 1 allows 16-byte loads (the caller checked
// that D * itemsize is a multiple of 16 and the base alignment). Returns the
// cudaError_t of the launch (0 = launched).
int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd, long long rows,
                    int D, float eps, int vec, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (dtype == 1)
    ln_stats_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), m, rs, rows, D, eps, vec != 0);
  else if (dtype == 0)
    ln_stats_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), m, rs, rows, D, eps, vec != 0);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
