// Stochastic-rounding int8 quantization (K8) for Hopper (sm_90a):
//
//   q[r, c] = int8( clip( floor( f32(w[r, c]) / scale[c] + u[r, c] ), -127, 127 ) )
//
// over a (rows, cols) weight w (f32 or bf16), a per-column f32 scale and
// uniforms u in [0, 1) passed in as f32. Replaces the Pallas TPU kernel
// `_sr_kernel` (`_sr_quantize_2d`, behind `stochastic_round_quantize`) of
// multimodal_embeddings_tpu/kernels/quantization.py, which also takes its
// uniforms as an input. E[q * scale] = w: floor(x + u) is ceil(x) with
// probability frac(x).
//
// Exactness: the division is the IEEE round-to-nearest one (__fdiv_rn, not a
// reciprocal multiply; the build passes no fast-math flag) and the add is
// __fadd_rn, so a w that is an exact multiple k of its scale gives x = k and
// floor(k + u) = k for every u < 1, and the kernel equals the plain PyTorch
// version bit for bit on the same u.
//
// What bounds it on this card: it is elementwise, ~3 operations per element
// against 9 bytes moved for f32 w (w 4, u 4, q 1) and 7 for bf16, so HBM
// bandwidth bounds it. Each thread moves 4 neighbouring elements of one row
// with one 16-byte load of w (8 bytes for bf16), one of u, one of the
// column's scales and one 4-byte store of q, where the columns are a
// multiple of 4 and the rows 16-byte aligned; elsewhere it takes them one by
// one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int8_t sr_one(float w, float s, float u) {
  const float y = floorf(__fadd_rn(__fdiv_rn(w, s), u));
  return (int8_t)fminf(fmaxf(y, -127.f), 127.f);
}

struct Four {
  float v[4];
};

__device__ __forceinline__ Four load4(const float* p) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  return {{a.x, a.y, a.z, a.w}};
}

__device__ __forceinline__ Four load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {{__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)}};
}

// four elements a thread: element group g covers flat indices 4g .. 4g + 3
template <typename T>
__global__ void __launch_bounds__(THREADS)
    sr_quantize_vec_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                           const float* __restrict__ u, int8_t* __restrict__ q,
                           long long groups, int cols) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x; g < groups; g += stride) {
    const long long i = 4 * g;
    const int c = (int)(i % cols);  // cols % 4 == 0: the four share a row
    const Four wv = load4(w + i);
    const Four uv = load4(u + i);
    const Four sv = load4(scale + c);
    char4 out;
    out.x = sr_one(wv.v[0], sv.v[0], uv.v[0]);
    out.y = sr_one(wv.v[1], sv.v[1], uv.v[1]);
    out.z = sr_one(wv.v[2], sv.v[2], uv.v[2]);
    out.w = sr_one(wv.v[3], sv.v[3], uv.v[3]);
    *reinterpret_cast<char4*>(q + i) = out;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sr_quantize_kernel(const T* __restrict__ w, const float* __restrict__ scale,
                       const float* __restrict__ u, int8_t* __restrict__ q, long long n,
                       int cols) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride)
    q[i] = sr_one(to_f32(w[i]), scale[i % cols], u[i]);
}

template <typename T>
cudaError_t launch(const void* w, const float* scale, const float* u, int8_t* q, int rows,
                   int cols, int vec, cudaStream_t stream) {
  const long long n = (long long)rows * cols;
  const long long work = vec ? n / 4 : n;
  // a grid-stride loop over at most 132 SMs x 16 blocks
  const long long need = (work + THREADS - 1) / THREADS;
  const int blocks = (int)(need < 132 * 16 ? need : 132 * 16);
  if (vec)
    sr_quantize_vec_kernel<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(w), scale, u, q, work, cols);
  else
    sr_quantize_kernel<T><<<blocks, THREADS, 0, stream>>>(
        static_cast<const T*>(w), scale, u, q, n, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (w). w (rows, cols), u (rows, cols) f32 and
// q (rows, cols) int8 are contiguous; scale holds cols f32 values. vec = 1:
// cols % 4 == 0 and w, u, scale and q start on 16-byte boundaries (the
// caller checked). Returns the cudaError_t of the launch (0 = launched).
int sr_quantize_launch(int dtype, const void* w, const void* scale, const void* u,
                       void* q, int rows, int cols, int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* uu = static_cast<const float*>(u);
  int8_t* out = static_cast<int8_t*>(q);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(w, sc, uu, out, rows, cols, vec, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(w, sc, uu, out, rows, cols, vec, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
