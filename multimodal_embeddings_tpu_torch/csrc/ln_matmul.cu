// LayerNorm fused into the following matrix product, for Hopper (sm_90a):
//
//   mu  = mean(x[m, :])                   f32
//   var = mean((x[m, :] - mu)^2)          f32, two passes
//   xn  = cast_T((x - mu) * rsqrt(var + eps) * gamma + beta)
//   y   = cast_T(xn @ w)                   f32 accumulation
//   y   = cast_T(y + bias)                 with a bias: added in T after the rounding
//
// x (M, K) and w (K, N) in T (bf16 or f32), gamma/beta f32, bias in T. Replaces
// the Pallas TPU kernels `_ln_mm_kernel` and `_ln_mm_bias_kernel` (ln_matmul)
// of multimodal_embeddings_tpu/kernels/ln_matmul.py: the pre-LN transformer
// blocks' ln1 -> [Wq|Wk|Wv] and ln2 -> fc1, without the normalised
// activations' round trip through device memory.
//
// What bounds it on this card: at the ViT page's (37632, 768) x (768, 2304)
// and the Mllama tower's (12864, 1280) x (1280, 5120) the product does 2*K
// flops per output on about 2 bytes per output, far above the H100's ~295
// bf16 flops per HBM byte, so the tensor cores bound it. The design is the
// repository's int8 weight matmul with a LayerNorm prologue: each block
// first computes the statistics of its 128 rows over the whole K (one warp a
// row, read once into registers, two passes over them), keeps them in shared
// memory, then streams K through the tensor cores, normalising each x chunk
// as it is stored into the shared A tile. The statistics are recomputed for
// every N tile, as the TPU kernel recomputes them per N block: 2 passes over
// 128 x K values against 128 x 128 x K multiply-adds. mma.sync m16n8k16
// (bf16 in, f32 accumulators) on 128x128 output tiles of 8 warps (each
// 64x32), K steps of 32 through a two-stage shared-memory ring filled from
// registers loaded one step ahead, ldmatrix reads (w transposed on the fly).
// wgmma and TMA would be the next step; this is the simple correct form.
//
// The normalisation rounds each step (no contraction into FMA) so that it is
// the plain version's arithmetic; sums are taken in another order.
//
// The f32 form is for checks only (the page program runs bf16): a CUDA-core
// tiled loop, 64x64 tiles, 4x4 outputs per thread, the same prologue.
//
// Ragged M, K and N are zero-filled at the tile edges; 16-byte vector loads
// are used where the wrapper says the rows are aligned (K % 8 == 0 and
// N % 8 == 0, 16-byte base addresses) and element loads elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int ROW_CHUNKS = 8;  // 16-byte chunks a lane holds: rows of K <= 2048 bf16

// Statistics of `rows` rows starting at m0, one warp a row; rows past M get
// zeros (their A chunks are zero-filled anyway). A bf16 row of K <= 2048
// with 16-byte chunks is read once into registers, all its loads in flight
// together, and both passes run from there; other rows loop over memory.
// (Four rows in flight per warp measured slower: 158 registers a thread,
// one block per SM instead of two.)
template <typename T>
__device__ void row_stats(const T* __restrict__ x, int M, int K, int m0, int rows,
                          float eps, float* s_mu, float* s_rstd, bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool held = vec && sizeof(T) == 2 && K <= 32 * 8 * ROW_CHUNKS;
  for (int r = warp; r < rows; r += warps) {
    const int gm = m0 + r;
    float mu = 0.f, rstd = 0.f;
    if (gm < M && held) {
      const uint4* row = reinterpret_cast<const uint4*>(x + (size_t)gm * K);
      uint4 v[ROW_CHUNKS];
#pragma unroll
      for (int i = 0; i < ROW_CHUNKS; ++i)
        if ((i * 32 + lane) * 8 < K) v[i] = row[i * 32 + lane];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < ROW_CHUNKS; ++i) {
        if ((i * 32 + lane) * 8 >= K) continue;
        const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s += __uint_as_float(w[j] << 16) + __uint_as_float(w[j] & 0xffff0000u);
      }
      mu = __fdiv_rn(warp_sum(s), (float)K);
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < ROW_CHUNKS; ++i) {
        if ((i * 32 + lane) * 8 >= K) continue;
        const uint32_t w[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = __fsub_rn(__uint_as_float(w[j] << 16), mu);
          const float hi = __fsub_rn(__uint_as_float(w[j] & 0xffff0000u), mu);
          q = __fadd_rn(q, __fmul_rn(lo, lo));
          q = __fadd_rn(q, __fmul_rn(hi, hi));
        }
      }
      rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), (float)K), eps));
    } else if (gm < M) {
      const T* row = x + (size_t)gm * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f32(row[k]);
      mu = __fdiv_rn(warp_sum(s), (float)K);
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float c = __fsub_rn(to_f32(row[k]), mu);
        v = __fadd_rn(v, __fmul_rn(c, c));
      }
      rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(v), (float)K), eps));
    }
    if (lane == 0) {
      s_mu[r] = mu;
      s_rstd[r] = rstd;
    }
  }
}

// ((x - mu) * rstd) * gamma + beta, each step rounded as the plain version's
__device__ __forceinline__ float normalise(float x, float mu, float rstd, float g,
                                           float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g), b);
}

// --------------------------------------------------------------------------
// bf16, tensor cores
// --------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;  // 8 warps: 2 along M (64 rows) x 4 along N (32 cols)
constexpr int A_LD = BK + 8;  // bf16 per shared x row: 80 B, 8 ldmatrix rows on distinct banks
constexpr int B_LD = BN + 8;  // bf16 per shared w row: 272 B, likewise

struct Stage {
  __nv_bfloat16 a[BM * A_LD];  // normalised x tile, [m][k]
  __nv_bfloat16 b[BK * B_LD];  // w tile, [k][n]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) . b (16x8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p, int n,
                                       bool vec) {
  // the first n (<= 8) elements at p, zeros after
  if (vec && n == 8) return *reinterpret_cast<const uint4*>(p);
  uint16_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = j < n ? __bfloat16_as_ushort(p[j]) : (uint16_t)0;
  return make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                    e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
}

// One tile's raw global loads, held in registers until the ring slot is
// free: two 8-element x chunks and two 8-element w chunks per thread.
struct Fetch {
  uint4 x[2];
  uint4 w[2];
};

__device__ __forceinline__ void fetch(Fetch& f, const __nv_bfloat16* __restrict__ x,
                                      const __nv_bfloat16* __restrict__ w, int M,
                                      int K, int N, int m0, int n0, int k0, bool vec,
                                      int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;  // 512 chunks: 128 rows x 4
    const int gm = m0 + (c >> 2), gk = k0 + (c & 3) * 8;
    f.x[i] = (gm < M && gk < K) ? load8(x + (size_t)gm * K + gk, min(8, K - gk), vec)
                                : make_uint4(0u, 0u, 0u, 0u);
    const int gr = k0 + (c >> 4), gn = n0 + (c & 15) * 8;  // 512 chunks: 32 rows x 16
    f.w[i] = (gr < K && gn < N) ? load8(w + (size_t)gr * N + gn, min(8, N - gn), vec)
                                : make_uint4(0u, 0u, 0u, 0u);
  }
}

// 8 bf16 x values at columns gk.. -> their normalised bf16 values (0 past K)
__device__ __forceinline__ uint4 norm_chunk(uint4 xin, int gk, int K, float mu, float rstd,
                                           const float* __restrict__ gamma,
                                           const float* __restrict__ beta, bool vec) {
  float g[8], b[8];
  if (vec && gk + 8 <= K) {
    const float4* gp = reinterpret_cast<const float4*>(gamma + gk);
    const float4* bp = reinterpret_cast<const float4*>(beta + gk);
    const float4 g0 = gp[0], g1 = gp[1], b0 = bp[0], b1 = bp[1];
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = gv[j];
      b[j] = bv[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[j] = gk + j < K ? gamma[gk + j] : 0.f;
      b[j] = gk + j < K ? beta[gk + j] : 0.f;
    }
  }
  const uint32_t in[4] = {xin.x, xin.y, xin.z, xin.w};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(in[j] << 16), hi = __uint_as_float(in[j] & 0xffff0000u);
    const float v0 = gk + 2 * j < K ? normalise(lo, mu, rstd, g[2 * j], b[2 * j]) : 0.f;
    const float v1 = gk + 2 * j + 1 < K ? normalise(hi, mu, rstd, g[2 * j + 1], b[2 * j + 1])
                                        : 0.f;
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    o[j] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void stage_store(Stage& s, const Fetch& f, const float* s_mu,
                                            const float* s_rstd,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta, int K,
                                            int k0, bool vec, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, kc = (c & 3) * 8;
    *reinterpret_cast<uint4*>(&s.a[r * A_LD + kc]) =
        norm_chunk(f.x[i], k0 + kc, K, s_mu[r], s_rstd[r], gamma, beta, vec);
    *reinterpret_cast<uint4*>(&s.b[(c >> 4) * B_LD + (c & 15) * 8]) = f.w[i];
  }
}

__global__ void __launch_bounds__(THREADS)
    ln_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ bias,
                      __nv_bfloat16* __restrict__ y, int M, int K, int N, float eps,
                      bool vec) {
  __shared__ __align__(16) Stage ring[2];
  __shared__ float s_mu[BM], s_rstd[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  row_stats(x, M, K, m0, BM, eps, s_mu, s_rstd, vec);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int steps = (K + BK - 1) / BK;
  Fetch f;
  fetch(f, x, w, M, K, N, m0, n0, 0, vec, tid);
  __syncthreads();  // statistics ready
  stage_store(ring[0], f, s_mu, s_rstd, gamma, beta, K, 0, vec, tid);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) fetch(f, x, w, M, K, N, m0, n0, (t + 1) * BK, vec, tid);
    const Stage& s = ring[t & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // ldmatrix row addresses: lane l names row (l % 16), column block l / 16
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &s.a[(wm + i * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)  // b[j] = {b0, b1} of n-tile 2j, then of 2j+1
        ldmatrix_x4_trans(b[j], &s.b[(kk + (lane & 15)) * B_LD + wn + j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    if (t + 1 < steps)
      stage_store(ring[(t + 1) & 1], f, s_mu, s_rstd, gamma, beta, K, (t + 1) * BK, vec,
                  tid);
    __syncthreads();
  }

  // epilogue: accumulator (row g or g + 8, columns 2*(lane % 4) + {0, 1})
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + c2;
    const float d0 = (bias && n < N) ? __bfloat162float(bias[n]) : 0.f;
    const float d1 = (bias && n + 1 < N) ? __bfloat162float(bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m >= M) continue;
        __nv_bfloat16 v0 = __float2bfloat16_rn(acc[i][j][2 * h]);
        __nv_bfloat16 v1 = __float2bfloat16_rn(acc[i][j][2 * h + 1]);
        if (bias) {  // round(acc) + bias, in bf16: rounded twice
          v0 = __float2bfloat16_rn(__bfloat162float(v0) + d0);
          v1 = __float2bfloat16_rn(__bfloat162float(v1) + d1);
        }
        __nv_bfloat16* out = y + (size_t)m * N + n;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __halves2bfloat162(v0, v1);
        } else {
          if (n < N) out[0] = v0;
          if (n + 1 < N) out[1] = v1;
        }
      }
    }
  }
}

// --------------------------------------------------------------------------
// f32, CUDA cores (checks only)
// --------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(256)
    ln_mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ w,
                     const float* __restrict__ bias, float* __restrict__ y, int M,
                     int K, int N, float eps) {
  __shared__ __align__(16) float sa[FK][FM];  // normalised x tile, transposed
  __shared__ __align__(16) float sb[FK][FN];  // w tile
  __shared__ float s_mu[FM], s_rstd[FM];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  row_stats(x, M, K, m0, FM, eps, s_mu, s_rstd, false);
  __syncthreads();
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e >> 4, kc = e & 15;  // x: 64 rows x 16
      const int gm = m0 + r, gk = k0 + kc;
      sa[kc][r] = (gm < M && gk < K)
                      ? normalise(x[(size_t)gm * K + gk], s_mu[r], s_rstd[r], gamma[gk], beta[gk])
                      : 0.f;
      const int kr = e >> 6, nc = e & 63;  // w: 16 rows x 64
      const int wk = k0 + kr, wn = n0 + nc;
      sb[kr][nc] = (wk < K && wn < N) ? w[(size_t)wk * N + wn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sb[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y). x (M, K), w (K, N) and
// y (M, N) are contiguous row-major; gamma and beta have K f32 values; bias
// has N values or is null. vec = 1 allows 16-byte loads (the caller checked
// K % 8, N % 8 and the base alignment). Returns the cudaError_t of the launch
// (0 = launched).
int ln_matmul_launch(int dtype, const void* x, const void* gamma, const void* beta,
                     const void* w, const void* bias, void* y, int M, int K, int N,
                     float eps, int vec, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (dtype == 1) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    ln_mm_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), M, K, N,
        eps, vec != 0);
  } else if (dtype == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    ln_mm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), M, K, N, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
