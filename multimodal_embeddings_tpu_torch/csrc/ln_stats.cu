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
// bandwidth bounds it. At the path shapes (12-25 us of reads) a launch's
// fixed cost weighs as much as the rate: back to back, one warp a row
// already streams at ~91% of HBM rate, and an empty launch of 1,608 of its
// blocks takes ~2.8 us. So the design keeps loads fine-grained and cuts the
// fixed cost:
//
// - every launch is programmatic (programmatic stream serialization): the
//   grid may be placed while the previous kernel in the stream drains, and
//   each CTA waits for it (griddepcontrol.wait) before it reads or writes;
//   the previous grid lets it go as its blocks exit. An empty launch back
//   to back takes ~1.7 us;
// - one warp a row, 8 rows a block: where the row is a whole number of
//   16-byte words on a 16-byte-aligned base (every path shape; the
//   launcher decides), lane l loads words l, l + 32, ... one at a time and
//   sums them in f32; other rows are read an element at a time. A shuffle
//   reduction follows, and lane 0 writes the row's mean and rstd.
//
// The order of every sum is fixed: no atomics, and two calls give equal
// bits (equal to this kernel's earlier, stream-ordered launch). Issuing a lane's
// loads together (all of a row's, or in groups of 4, 8 or 16) gained ~1 us
// at the ViT shape and nothing, or lost, at the Mllama one; a ring of 1-D
// bulk copies through shared memory, one persistent CTA per SM, measured
// slower at every path shape: a completion per ~24-40 KB stage adds a ramp
// and a drain that ~250 KB per SM does not amortise
// (scripts/torch_k7_probe.py keeps each as a variant). The TPU kernel's
// row-block size and VMEM budget (pick_row_block) have no counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, ROWS = THREADS / 32;  // 8 warps, one row each

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

// nothing is read or written before the previous kernel in the stream has
// finished (the launch is programmatic: this grid may be placed before)
__device__ __forceinline__ void grid_dependency() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// vec: the row is a whole number of 16-byte words on a 16-byte boundary
template <typename T>
__global__ void __launch_bounds__(THREADS)
    ln_stats_kernel(const T* __restrict__ x, float* __restrict__ mean,
                    float* __restrict__ rstd, long long rows, int D, float eps,
                    bool vec) {
  grid_dependency();
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
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

// a programmatic launch of `grid` THREADS-thread blocks on `stream`
template <typename T>
int launch(const void* x, float* mean, float* rstd, long long rows, int D, float eps,
           cudaStream_t stream) {
  const long long grid = (rows + ROWS - 1) / ROWS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = ((long long)D * sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ln_stats_kernel<T>, static_cast<const T*>(x),
                                           mean, rstd, rows, D, eps, vec);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x is (rows, D) contiguous; mean and rstd
// have rows f32 values. Returns the cudaError_t of the launch (0 = launched).
int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd, long long rows, int D,
                    float eps, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  if (dtype == 1) return launch<__nv_bfloat16>(x, m, rs, rows, D, eps, s);
  if (dtype == 0) return launch<float>(x, m, rs, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
