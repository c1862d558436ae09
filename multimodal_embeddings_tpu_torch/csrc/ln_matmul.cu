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
// bf16 flops per HBM byte, so the tensor cores bound the work; in practice
// the bytes each SM takes in from L2 per product come first (a 128 x 256
// tile streams 48 KB per 64-column chunk, 48 bytes per tensor-core cycle):
// the wgmma form's loads and stores alone take ~70% of its time at the
// path shapes (scripts/torch_k6_probe.py).
//
// Three forms (form_of; kernels/ln_matmul.py::ln_mm_form mirrors it):
//
// * bf16 where TMA can describe x and w (K % 8 == 0, N % 8 == 0, x, w and
//   the bias on 16-byte boundaries, K <= 8,384; every path shape): the wgmma
//   form, ln_mm_wgmma_kernel. Persistent CTAs, one per SM, each walking a
//   contiguous run of (128-row block, 256-column tile) units in
//   row-block-major order, so the statistics of a row block are computed
//   once per CTA that enters it, not once per N tile; a TMA ring of raw x
//   and w chunks; x normalised in registers, with the statistics and gamma
//   and beta, as wgmma's A operand (never written back to shared memory);
//   an epilogue through shared memory and TMA stores. What each part does
//   is written above the kernel.
// * bf16 otherwise (ragged K or N, a misaligned base): the mma.sync form,
//   ln_mm_bf16_kernel. Each 128 x 128 block first computes the statistics of
//   its 128 rows over the whole K (one warp a row, read once into registers,
//   two passes over them), keeps them in shared memory, then streams K
//   through mma.sync m16n8k16 (8 warps, each 64x32), K steps of 32 through a
//   two-stage shared-memory ring filled from registers loaded one step
//   ahead, normalising each x chunk as it is stored into the shared A tile;
//   the statistics are recomputed for every N tile.
// * f32, for checks only (the page program runs bf16): a CUDA-core tiled
//   loop, 64x64 tiles, 4x4 outputs per thread, the same prologue.
//
// The normalisation rounds each step (no contraction into FMA) so that it is
// the plain version's arithmetic; sums are taken in another order.
//
// Ragged M, K and N: TMA reads rows and columns past the edge as zero in the
// wgmma form (gamma and beta are zero past K there, so the padding columns
// normalise to 0), whose stores are masked; the other two zero-fill their
// tiles' edges, with 16-byte vector loads where the launcher finds the rows
// aligned (K % 8 == 0 and N % 8 == 0, 16-byte base addresses) and element
// loads elsewhere.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

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
// bf16, the mma.sync form
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

// --------------------------------------------------------------------------
// bf16 where TMA can describe x and w: persistent, warp-specialised wgmma
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // warps 0-7: two consumer warpgroups; warp 8: the loads
constexpr int TM = 128;          // rows of x per tile: 64 per consumer warpgroup
constexpr int TN = 256;          // columns of w per tile (wgmma m64n256k16)
constexpr int KC = 64;           // columns of x (rows of w) per chunk: one ring stage
constexpr int KG = 4;            // k-steps per product group (the next is normalised under it)
constexpr int X_BYTES = TM * KC * 2;            // 16 KB: one 128-byte-swizzled box
constexpr int W_ATOM = KC * 128;                // 8 KB: 64 rows x 64 columns of w
constexpr int W_BYTES = (TN / 64) * W_ATOM;     // 32 KB: four atoms
constexpr int STAGE = X_BYTES + W_BYTES;        // 48 KB
constexpr int STAGING = 8 * 16 * 128;           // per consumer warp 16 rows x 64 bf16
constexpr int BARS = 16 * 4;                    // the ring's full and empty barriers
constexpr int SMEM_LIMIT = 232448;
constexpr int MAX_STAGES = 4, MIN_STAGES = 3;

__host__ __device__ constexpr int k_pad(int K) { return (K + KC - 1) / KC * KC; }

// shared memory of the wgmma form: 1,024 bytes to align the base for the
// swizzle, the ring, the epilogue's staging, gamma and beta interleaved (8
// bytes per column, padded to whole chunks), the barriers
__host__ __device__ constexpr int wg_smem(int K, int stages) {
  return 1024 + stages * STAGE + STAGING + 8 * k_pad(K) + BARS;
}

// the ring's stages for rows of K: 4 where they fit, else 3; 0 where not
// even 3 fit (K > 8,384), and the launch takes the mma.sync form
int wg_stages(int K) {
  for (int s = MAX_STAGES; s >= MIN_STAGES; --s)
    if (wg_smem(K, s) <= SMEM_LIMIT) return s;
  return 0;
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (no integer division
// in the kernel); `divisor` finds mul and shr on the host.
struct Div {
  int d;
  uint32_t mul, shr;
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)(__umulhi((uint32_t)x, mul) >> shr);
  }
};

Div divisor(int d) {
  Div r{d, 0u, 0u};
  if (d > 1) {
    int log2d = 0;  // ceil(log2(d))
    while ((1ll << log2d) < d) ++log2d;
    const int p = 31 + log2d;
    r.mul = (uint32_t)(((1ull << p) + (uint64_t)d - 1) / (uint64_t)d);
    r.shr = (uint32_t)(p - 32);
  }
  return r;
}

// One launch: the TMA maps of x (boxes of 64 columns x 128 rows), w (64
// columns x 64 rows) and y (64 columns x 16 rows, stores), all at the
// 128-byte swizzle; the tile units are
// (row block, N tile), numbered row-block-major (u = rb * nt + nj), and CTA
// j takes the contiguous run [start(j), start(j + 1)).
struct WgParams {
  CUtensorMap xmap, wmap, ymap;
  const bf16* x;
  const float* gamma;
  const float* beta;
  const bf16* bias;
  bf16* y;
  int M, K, N, nt, nchunks, stages, base, rem;
  float kf, eps;  // K as a float (no int-to-float conversion in the kernel)
  Div by_nt;
  __device__ __forceinline__ int start(int j) const { return j * base + min(j, rem); }
};

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of the given parity has completed; a wait of more
// than ~10 s (a barrier that can never complete) traps, so a fault in the
// pipeline ends the launch with an error instead of hanging the card
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

// box at (c0: column, c1: row) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// shared memory at src to the box at (c0: column, c1: row) of the map's
// tensor; the parts of the box past its edges are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// the 256 consumer threads (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[KG][4]) {
#pragma unroll
  for (int i = 0; i < KG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// shared-memory descriptor of w's k-step at `addr` (16 rows of the four
// 64-column atoms, read transposed: MN-major, 128-byte swizzle): the atoms
// W_ATOM bytes apart along N, groups of 8 rows 1,024 bytes apart along K
__device__ __forceinline__ uint64_t w_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(W_ATOM >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 256, f32) += A (registers, 64 x 16) . B (shared memory, 16 x 256,
// MN-major: imm-trans-b 1)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// a bf16x2 word of x (columns k, k + 1) normalised with its row's
// statistics and the columns' gamma and beta (gb = {g_k, g_k+1, b_k,
// b_k+1}), each step rounded, packed back to bf16x2
__device__ __forceinline__ uint32_t norm2(uint32_t w, float mu, float rstd, const float4& gb) {
  const float v0 = normalise(__uint_as_float(w << 16), mu, rstd, gb.x, gb.z);
  const float v1 = normalise(__uint_as_float(w & 0xffff0000u), mu, rstd, gb.y, gb.w);
  const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The A fragments of product group h (k-steps KG h ..) of the chunk whose
// x tile this lane reads at xt (its ldmatrix row, a_hi and a_x as in the
// kernel), normalised with its rows' statistics and the columns' gamma and
// beta (gbc: the chunk's column pairs from this lane's first)
__device__ __forceinline__ void normalise_group(uint32_t (&a)[KG][4], uint32_t xt, int h,
                                                uint32_t a_hi, uint32_t a_x,
                                                const float4* gbc, float mu0, float rs0,
                                                float mu1, float rs1) {
#pragma unroll
  for (int i = 0; i < KG; ++i) {
    const int j = KG * h + i;
    uint32_t r[4];
    ldsm_x4(r, xt + (((2 * j + a_hi) ^ a_x) << 4));
    const float4 glo = gbc[8 * j], ghi = gbc[8 * j + 4];  // columns 16j + 2(l % 4), + 8
    a[i][0] = norm2(r[0], mu0, rs0, glo);  // row l / 4
    a[i][1] = norm2(r[1], mu1, rs1, glo);  // row l / 4 + 8
    a[i][2] = norm2(r[2], mu0, rs0, ghi);
    a[i][3] = norm2(r[3], mu1, rs1, ghi);
  }
}

// (mean, rstd) of row gm of x (K > 1,280), two passes over memory as
// row_stats; one warp
__device__ __forceinline__ float2 row_stats_loop(const WgParams& p, int gm, int lane) {
  const uint4* row = reinterpret_cast<const uint4*>(p.x + (size_t)gm * p.K);
  float s = 0.f;
  for (int i = lane; i * 8 < p.K; i += 32) {
    const uint4 v = __ldg(row + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s += __uint_as_float(w[j] << 16) + __uint_as_float(w[j] & 0xffff0000u);
  }
  const float mu = __fdiv_rn(warp_sum(s), p.kf);
  float q = 0.f;
  for (int i = lane; i * 8 < p.K; i += 32) {
    const uint4 v = __ldg(row + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float lo = __fsub_rn(__uint_as_float(w[j] << 16), mu);
      const float hi = __fsub_rn(__uint_as_float(w[j] & 0xffff0000u), mu);
      q = __fadd_rn(q, __fmul_rn(lo, lo));
      q = __fadd_rn(q, __fmul_rn(hi, hi));
    }
  }
  return make_float2(mu, 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), p.kf), p.eps)));
}

// (mean, rstd) of R rows of x from gm0 (K <= 256 S; rows past M get
// zeros), two passes as row_stats from rows read once into registers, all
// R rows' loads in flight together; one warp
template <int S, int R>
__device__ __forceinline__ void rows_stats(const WgParams& p, int gm0, int lane,
                                           float2 (&out)[R]) {
  uint4 v[R][S];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const uint4* row =
        reinterpret_cast<const uint4*>(p.x + (size_t)min(gm0 + rr, p.M - 1) * p.K);
#pragma unroll
    for (int i = 0; i < S; ++i)
      v[rr][i] = (i * 32 + lane) * 8 < p.K ? __ldg(row + i * 32 + lane)
                                           : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const uint32_t w[4] = {v[rr][i].x, v[rr][i].y, v[rr][i].z, v[rr][i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s += __uint_as_float(w[j] << 16) + __uint_as_float(w[j] & 0xffff0000u);
    }
    const float mu = __fdiv_rn(warp_sum(s), p.kf);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if ((i * 32 + lane) * 8 >= p.K) continue;
      const uint32_t w[4] = {v[rr][i].x, v[rr][i].y, v[rr][i].z, v[rr][i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __fsub_rn(__uint_as_float(w[j] << 16), mu);
        const float hi = __fsub_rn(__uint_as_float(w[j] & 0xffff0000u), mu);
        q = __fadd_rn(q, __fmul_rn(lo, lo));
        q = __fadd_rn(q, __fmul_rn(hi, hi));
      }
    }
    const float rstd = 1.f / sqrtf(__fadd_rn(__fdiv_rn(warp_sum(q), p.kf), p.eps));
    out[rr] = gm0 + rr < p.M ? make_float2(mu, rstd) : make_float2(0.f, 0.f);
  }
}

// The statistics of the 16 rows of x from m0 (one consumer warp, on
// entering a row block): lane l keeps those of rows l / 4 and l / 4 +
// 8, the rows of its A fragments. Rows of K <= 768 are read into registers
// 8 at a time, of K <= 1,280 4 at a time; longer rows loop over memory.
__device__ __forceinline__ void warp_stats(const WgParams& p, int m0, int lane, float& mu0,
                                           float& rs0, float& mu1, float& rs1) {
  const int want = lane >> 2;
  auto keep = [&](int r, float2 st) {
    if (r == want) mu0 = st.x, rs0 = st.y;
    if (r == want + 8) mu1 = st.x, rs1 = st.y;
  };
  if (p.K <= 3 * 256) {
#pragma unroll 1
    for (int r0 = 0; r0 < 16; r0 += 8) {
      float2 st[8];
      rows_stats<3, 8>(p, m0 + r0, lane, st);
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) keep(r0 + rr, st[rr]);
    }
  } else if (p.K <= 5 * 256) {
#pragma unroll 1
    for (int r0 = 0; r0 < 16; r0 += 4) {
      float2 st[4];
      rows_stats<5, 4>(p, m0 + r0, lane, st);
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) keep(r0 + rr, st[rr]);
    }
  } else {
#pragma unroll 1
    for (int r = 0; r < 16; ++r)
      keep(r, m0 + r < p.M ? row_stats_loop(p, m0 + r, lane) : make_float2(0.f, 0.f));
  }
}

// The wgmma form. Persistent CTAs, one per SM, each walking its run of
// (row block, N tile) units; 384 threads: warp 8's first thread keeps a
// ring of `stages` chunks filled by TMA (x's 128 rows x 64 columns and w's
// 64 rows x 256 columns, raw), and two consumer warpgroups take 64 rows of
// the tile each (warpgroup 2 gives up its registers to them by setmaxnreg).
// Entering a row block (the run's first unit, or a new row block), each
// consumer warp computes the statistics of its own 16 rows (warp_stats) and
// each thread keeps those of its two fragment rows in registers for every
// N tile of the block. For each k-step of 16 columns a thread ldmatrix-es
// its raw A fragment from the swizzled x chunk, normalises its 8 values
// with its rows' statistics and the columns' gamma and beta (from shared
// memory, staged once per CTA, zero past K so the padding columns
// normalise to 0) and packs them to bf16x2: wgmma.m64n256k16's register
// operand, with w read transposed from shared memory. The products go in
// groups of KG k-steps: a group's products are issued, the next group is
// normalised into the other set of A registers while they run, then all
// of them are waited for (a register operand written while products are in
// flight would make ptxas serialise every wgmma). A stage goes back to the
// loads when its chunk's last products are done. The epilogue rounds the
// accumulators to bf16 into a per-warp staging area (stmatrix, swizzled),
// adds the bias in bf16 there (rounding twice) and stores each 16 x 64
// piece by TMA; the ring keeps loading the next tile meanwhile. No split-K:
// two calls give the same bits.
__global__ void __launch_bounds__(WG_THREADS, 1)
    ln_mm_wgmma_kernel(const __grid_constant__ WgParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int stages = p.stages;
  const uint32_t staging = base + stages * STAGE;
  float4* const gb = reinterpret_cast<float4*>(smem_raw + (base - raw) + stages * STAGE + STAGING);
  const uint32_t bars = staging + STAGING + 8 * k_pad(p.K);
  auto x_tile = [&](int s) { return base + s * STAGE; };
  auto w_tile = [&](int s) { return base + s * STAGE + X_BYTES; };
  auto full_bar = [&](int s) { return bars + 8 * s; };                   // x, w landed
  auto empty_bar = [&](int s) { return bars + 8 * (MAX_STAGES + s); };  // consumers done

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full_bar(s), 1);
      bar_init(empty_bar(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = p.start(blockIdx.x), u1 = p.start(blockIdx.x + 1);
  if (warp >= 8) {
    regs_dec<40>();  // 128 x 40 + 256 x 232 registers: the 384 x 168 of the launch
    // ---------------- loads: one thread issues every TMA copy ----------------
    if (warp == 8 && lane == 0) {
      int s = 0, ph = 0;
      for (int u = u0; u < u1; ++u) {
        const int rb = p.by_nt.div(u), nj = u - rb * p.nt;
        for (int c = 0; c < p.nchunks; ++c) {
          bar_wait(empty_bar(s), ph ^ 1);
          const uint32_t full = full_bar(s);
          bar_arrive_tx(full, STAGE);
          tma_load_2d(x_tile(s), &p.xmap, full, c * KC, rb * TM);
#pragma unroll
          for (int a = 0; a < TN / 64; ++a)
            tma_load_2d(w_tile(s) + a * W_ATOM, &p.wmap, full, nj * TN + 64 * a, c * KC);
          if (++s == stages) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 rows of the tile per warpgroup ----------------
  regs_inc<232>();
  // gamma and beta interleaved, gb[i] = {g[2i], g[2i + 1], b[2i], b[2i + 1]},
  // zero past K
  for (int i = threadIdx.x; i < k_pad(p.K) / 2; i += 256) {
    const int k = 2 * i;
    gb[i] = k < p.K ? make_float4(p.gamma[k], p.gamma[k + 1], p.beta[k], p.beta[k + 1])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  consumers_sync();

  const int row16 = 16 * warp;  // the warp's first row of the tile (warpgroup warp / 4)
  // ldmatrix: lane l addresses row row16 + l % 16, 16-byte chunk 2j + l / 16
  // of k-step j, XOR the row % 8 (= l % 8) for the 128-byte swizzle
  const uint32_t a_row = (uint32_t)(row16 + (lane & 15)) * 128;
  const uint32_t a_hi = lane >> 4, a_x = lane & 7;
  const float4* const gb_lane = gb + (lane & 3);  // column pair 2 (lane % 4) of each 8
  // stmatrix: lane l addresses row (l / 8 % 2) * 8 + l % 8 of the warp's 16,
  // 16-byte chunk 2h + l / 16
  const int st_row = ((lane >> 3) & 1) * 8 + (lane & 7);
  const uint32_t stg = staging + warp * 2048;
  float acc[128];
  uint32_t a0[KG][4], a1[KG][4];  // A of this group and of the next, normalised under this one's products
  float mu0 = 0.f, rs0 = 0.f, mu1 = 0.f, rs1 = 0.f;
  int s = 0, ph = 0, rb_stats = -1;
  int c = 0, h = 0;  // the chunk and group in it whose products come next

  // One product group: its KG products from `cur`, the next group's A into
  // `nxt` while they run (first waiting for its stage where it starts a
  // chunk), then the wait for the products, which releases a finished
  // chunk's stage. False after the tile's last group.
  auto group = [&](uint32_t(&cur)[KG][4], uint32_t(&nxt)[KG][4]) -> bool {
    fence_regs(cur);
    wgmma_fence();
    const uint32_t wt = w_tile(s);
#pragma unroll
    for (int i = 0; i < KG; ++i) wgmma_rs_n256(acc, cur[i], w_desc(wt + (KG * h + i) * 2048));
    wgmma_commit();
    const int done = s;
    const bool chunk_end = h + 1 == KC / 16 / KG;
    const bool more = !chunk_end || c + 1 < p.nchunks;
    if (chunk_end) {
      h = 0, ++c;
      if (++s == stages) s = 0, ph ^= 1;
    } else {
      ++h;
    }
    if (more) {
      if (chunk_end) bar_wait(full_bar(s), ph);
      normalise_group(nxt, x_tile(s) + a_row, h, a_hi, a_x, gb_lane + c * (KC / 2), mu0, rs0,
                      mu1, rs1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(cur);
    if (chunk_end) {  // the stage is free
      __syncwarp();
      if (lane == 0) bar_arrive(empty_bar(done));
    }
    return more;
  };

#pragma unroll 1
  for (int u = u0; u < u1; ++u) {
    const int rb = p.by_nt.div(u), nj = u - rb * p.nt;
    if (rb != rb_stats) {  // a new row block: its statistics, once
      warp_stats(p, rb * TM + row16, lane, mu0, rs0, mu1, rs1);
      rb_stats = rb;
    }
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    c = h = 0;
    bar_wait(full_bar(s), ph);
    normalise_group(a0, x_tile(s) + a_row, 0, a_hi, a_x, gb_lane, mu0, rs0, mu1, rs1);
    while (group(a0, a1) && group(a1, a0)) {
    }

    // epilogue: 64 columns at a time through the warp's staging area and a
    // TMA store; the bias of this lane's 8 columns of each, loaded first
    const int m_base = rb * TM + row16;
    uint4 bq[TN / 64];
#pragma unroll
    for (int q = 0; q < TN / 64; ++q) {
      const int n = nj * TN + 64 * q + 8 * (lane & 7);
      bq[q] = p.bias && n < p.N ? __ldg(reinterpret_cast<const uint4*>(p.bias + n))
                                : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < TN / 64; ++q) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {  // column groups t = 8q + 2h, + 1 (8 columns each)
        const int t = 8 * q + 2 * h;
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // rows l / 4 and l / 4 + 8 of groups t, t + 1
          const __nv_bfloat162 pk =
              __floats2bfloat162_rn(acc[4 * t + 2 * e], acc[4 * t + 2 * e + 1]);
          v[e] = *reinterpret_cast<const uint32_t*>(&pk);
        }
        const int chunk = 2 * h + (lane >> 4);
        stsm_x4(stg + st_row * 128 + ((chunk ^ (st_row & 7)) << 4), v);
      }
      __syncwarp();
      if (p.bias) {  // round(acc) + bias in bf16, rounded twice: rows l / 8 + 4i, chunk l % 8
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (lane >> 3) + 4 * i, ch = lane & 7;
          const uint32_t at = stg + r * 128 + ((ch ^ (r & 7)) << 4);
          uint32_t o[4];
          asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3])
                       : "r"(at));
          const uint32_t b[4] = {bq[q].x, bq[q].y, bq[q].z, bq[q].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = __fadd_rn(__uint_as_float(o[e] << 16), __uint_as_float(b[e] << 16));
            const float hi = __fadd_rn(__uint_as_float(o[e] & 0xffff0000u),
                                       __uint_as_float(b[e] & 0xffff0000u));
            const __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
            o[e] = *reinterpret_cast<const uint32_t*>(&pk);
          }
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(o[0]),
                       "r"(o[1]), "r"(o[2]), "r"(o[3])
                       : "memory");
        }
      }
      // the 16 x 64 box to y by TMA (rows past M and columns past N are
      // not written), once every lane's writes are visible to it; the
      // staging area is free again once the copy has read it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0 && m_base < p.M && nj * TN + 64 * q < p.N) {
        tma_store_2d(&p.ymap, stg, nj * TN + 64 * q, m_base);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      __syncwarp();
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// looked up at run time through the runtime's entry-point query, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr,
                                                             12000, cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// The TMA map of a row-major bf16 (rows, cols) matrix in boxes of 64
// columns (128 bytes, the 128-byte swizzle) x box_rows; rows and columns
// past the edge read as zero, and are not written. Returns 0, or 1000 + the
// CUresult.
int encode_2d(CUtensorMap* map, const void* ptr, long long cols, long long rows, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return 1999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The form a launch takes (kernels/ln_matmul.py::ln_mm_form mirrors it): 0
// the f32 form for f32 operands; 2 the wgmma form for bf16 where TMA can
// describe x and w (K % 8 == 0 and N % 8 == 0: row strides that are
// multiples of 16 bytes; x, w and the bias on 16-byte boundaries) and the
// ring's shared memory fits (wg_stages(K) > 0: K <= 8,384); 1 the mma.sync
// form for every other bf16 shape.
int form_of(int dtype, int K, int N, const void* x, const void* w, const void* bias) {
  if (dtype == 0) return 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(bias);
  return K % 8 == 0 && N % 8 == 0 && bases % 16 == 0 && wg_stages(K) > 0 ? 2 : 1;
}

// the wgmma kernel with its shared-memory limit raised on the current
// device (once per device)
void* wgmma_kernel(cudaError_t* err) {
  void* kernel = reinterpret_cast<void*>(ln_mm_wgmma_kernel);
  static bool raised[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess && (dev < 0 || dev >= 64 || !raised[dev])) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (*err == cudaSuccess && dev >= 0 && dev < 64) raised[dev] = true;
  }
  return kernel;
}

int wgmma_launch(const bf16* x, const float* gamma, const float* beta, const bf16* w,
                 const bf16* bias, bf16* y, int M, int K, int N, float eps, int grid,
                 cudaStream_t s) {
  WgParams prm;
  memset(&prm, 0, sizeof(prm));
  prm.x = x;
  prm.gamma = gamma;
  prm.beta = beta;
  prm.bias = bias;
  prm.y = y;
  prm.M = M;
  prm.K = K;
  prm.N = N;
  prm.nt = (N + TN - 1) / TN;
  prm.nchunks = (K + KC - 1) / KC;
  prm.stages = wg_stages(K);
  prm.kf = (float)K;
  prm.eps = eps;
  const long long units = (long long)((M + TM - 1) / TM) * prm.nt;
  if (units > 0x7FFFFFFFLL || grid < 1 || grid > units || prm.stages == 0)
    return (int)cudaErrorInvalidValue;
  prm.base = (int)(units / grid);
  prm.rem = (int)(units % grid);
  prm.by_nt = divisor(prm.nt);
  int err = encode_2d(&prm.xmap, x, K, M, TM);
  if (err == 0) err = encode_2d(&prm.wmap, w, N, K, KC);
  if (err == 0) err = encode_2d(&prm.ymap, y, N, M, 16);
  if (err) return err;
  cudaError_t e;
  void* kernel = wgmma_kernel(&e);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&prm};
  e = cudaLaunchKernel(kernel, dim3(grid), dim3(WG_THREADS), args, wg_smem(K, prm.stages), s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y). x (M, K), w (K, N) and
// y (M, N) are contiguous row-major; gamma and beta have K f32 values; bias
// has N values or is null. The form is form_of's (ln_matmul_form); in the
// wgmma form `grid` persistent CTAs (at most the card's resident count,
// ln_mm_wgmma_resident_ctas, and at most the tile units) share the units,
// and the other forms ignore it. The mma.sync and f32 forms take 16-byte
// loads where K % 8, N % 8 and the bases of x, w, gamma and beta allow
// them. Returns the cudaError_t of the launch (0 = launched), or 1000 + the
// CUresult of a failed TMA map encoding.
int ln_matmul_launch(int dtype, const void* x, const void* gamma, const void* beta,
                     const void* w, const void* bias, void* y, int M, int K, int N,
                     float eps, int grid, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int form = form_of(dtype, K, N, x, w, bias);
  if (form == 2)
    return wgmma_launch(static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(w),
                        static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, K, N, eps,
                        grid, s);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(gamma) | reinterpret_cast<uintptr_t>(beta);
  const bool vec = K % 8 == 0 && N % 8 == 0 && bases % 16 == 0;
  if (dtype == 1) {
    const dim3 grid2((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid2.y > 65535) return (int)cudaErrorInvalidValue;
    ln_mm_bf16_kernel<<<grid2, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), g, b, static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), M, K, N,
        eps, vec);
  } else if (dtype == 0) {
    const dim3 grid2((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid2.y > 65535) return (int)cudaErrorInvalidValue;
    ln_mm_f32_kernel<<<grid2, 256, 0, s>>>(
        static_cast<const float*>(x), g, b, static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(y), M, K, N, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The form ln_matmul_launch takes for these operands: 0 the f32 form, 1 the
// mma.sync form, 2 the wgmma form (the rule is form_of's); -1 for a shape
// or type it refuses.
int ln_matmul_form(int dtype, int M, int K, int N, const void* x, const void* w,
                   const void* bias) {
  if (M <= 0 || K <= 0 || N <= 0 || dtype < 0 || dtype > 1) return -1;
  return form_of(dtype, K, N, x, w, bias);
}

// The wgmma form's CTAs resident on the current card at once; -1 on an
// error. The wrapper's grid is at most this.
int ln_mm_wgmma_resident_ctas() {
  cudaError_t e;
  void* kernel = wgmma_kernel(&e);
  if (e != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS,
                                                    wg_smem(KC, MAX_STAGES)) != cudaSuccess)
    return -1;
  return sms * per_sm > 0 ? sms * per_sm : -1;
}

// The wgmma form's constants, which kernels/ln_matmul.py's plan mirrors: 0
// the tile's rows of x, 1 its columns of w, 2 the chunk's columns of x, 3
// the ring's stages for rows of K (0: the form refuses K), 4 the shared
// memory of a launch at K in bytes, 5 the threads of a CTA; -1 otherwise.
int ln_mm_wgmma_config(int K, int what) {
  if (K <= 0) return -1;
  const int stages = wg_stages(K);
  const int v[6] = {TM, TN, KC, stages, stages ? wg_smem(K, stages) : 0, WG_THREADS};
  return what >= 0 && what < 6 ? v[what] : -1;
}

}  // extern "C"
