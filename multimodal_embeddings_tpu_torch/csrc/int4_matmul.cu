// Weight-only packed-int4 matrix product for Hopper (sm_90a):
//
//   y[M, N] = cast( sum_g ( bf16(x[:, group g]) . q_g  (f32 accumulation) ) * scale[g, N] )
//
// x is bf16 (the wrapper rounds an f32 x to bf16 first, as the TPU kernel
// does), the weight is packed int4 with f32 group scales, y is bf16 or f32.
// Replaces the Pallas TPU kernel `_mm4_kernel` of `int4_matmul` in
// multimodal_embeddings_tpu/kernels/quantization_int4.py and keeps its
// layout and rounding:
//
//   * a (K, N) weight is split into n_groups groups of G = K / n_groups rows;
//     packed row p of group g holds weight row g*G + p in its LOW nibble and
//     row g*G + G/2 + p in its HIGH nibble (not the adjacent-pair interleave
//     of GPTQ/AWQ); a nibble stores q + 8, q in [-8, 7];
//   * per group, part = bf16(x_g) . q_g summed in f32 (the bf16 x int4
//     products are exact), then acc += part * scale[g, :] in f32; one cast at
//     the end.
//
// The packed weight is read from device memory as bytes and becomes bf16 only
// in shared memory or registers, so no bf16 copy of W exists in HBM.
//
// Two kernels:
//
// * M > 4 (prefill): tensor cores, after K2 (csrc/int8_matmul.cu). What
//   bounds it: at the 32B prefill's M = 1535 rows a product does ~6000 flops
//   per weight byte, so the tensor cores bound it (95.8 TFLOP per prefill,
//   96.9 ms at 989 TFLOP/s). 128x128 output tiles of 8 warps (each 64x32),
//   mma.sync m16n8k16 (bf16 in, f32 accumulate). A k-step takes 16 packed
//   rows = 32 weight rows, 16 low-nibble and 16 high-nibble rows, with the x
//   columns of the same 32 rows beside them, so every packed byte is read
//   once. A two-stage shared-memory ring is filled from registers loaded one
//   step ahead. Each warp keeps a per-group partial accumulator and folds it
//   into the output accumulator with the group's scale row after the group's
//   last k-step.
// * M <= 4 (decode): a GEMV. What bounds it: decode reads every weight byte
//   once per token for 2 flops per weight per row, so HBM bandwidth bounds it
//   (17.0 GB per 32B decode step: 5.07 ms at 3.35 TB/s), and bandwidth needs
//   bytes in flight: each block owns 128 output columns, its 256 threads are
//   8 column threads (one 16-byte load of packed bytes per packed row) x 32
//   slices of contiguous packed rows, unrolled 4 deep; where N gives too few
//   column tiles to fill 132 SMs twice (q/o/k/v/down), the packed rows are
//   split over blocks too and the last block of a column tile sums the
//   splits' f32 partials in order.
//
// Ragged M, K and N are zero-filled at the tile edges; vector loads are used
// where rows are aligned (checked in the launcher) and element loads
// elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// --------------------------------------------------------------------------
// M > 4: tensor cores
// --------------------------------------------------------------------------

constexpr int BM = 128, BN = 128;
constexpr int PK = 16;            // packed rows per k-step (32 weight rows)
constexpr int THREADS = 256;      // 8 warps: 2 along M (64 rows) x 4 along N (32 cols)
constexpr int A_LD = 2 * PK + 8;  // bf16 per shared x row [16 low | 16 high]: 80 B
constexpr int B_LD = BN + 8;      // bf16 per shared W row: 272 B

struct Stage {
  bf16 a[BM * A_LD];      // x tile, [m][k]: k < 16 low rows, k >= 16 high rows
  bf16 b[2 * PK * B_LD];  // W tile as bf16, [k][n], the same k order
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// nibble pair -> two bf16 values (exact: |q| <= 8)
__device__ __forceinline__ uint32_t nib_pair(uint32_t b0, uint32_t b1, int shift) {
  const float lo = (float)((int)((b0 >> shift) & 15u) - 8);
  const float hi = (float)((int)((b1 >> shift) & 15u) - 8);
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One k-step's global loads, held in registers until the ring slot is free:
// two 8-element x chunks and 8 packed bytes per thread.
struct Fetch {
  uint4 x[2];
  uint2 w;
};

// k-step over packed rows [pr0, pr0 + 16) of group g (local rows pl0 ..)
__device__ __forceinline__ void fetch(Fetch& f, const bf16* __restrict__ x,
                                      const uint8_t* __restrict__ p, int M, int K,
                                      int N, int G, int g, int pl0, int m0, int n0,
                                      bool vecx, bool vecw, int tid) {
  const int half = G / 2;
  const int klo = g * G + pl0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;  // 512 chunks: 128 rows x 4
    const int row = c >> 2, qd = c & 3, gm = m0 + row;
    const int local = pl0 + (qd & 1) * 8;               // packed row of element 0
    const int gk = klo + (qd >> 1) * half + (qd & 1) * 8;  // its x column
    if (vecx && gm < M && local + 8 <= half) {
      f.x[i] = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (gm < M && local + j < half)
                   ? __bfloat16_as_ushort(x[(size_t)gm * K + gk + j])
                   : (uint16_t)0;
      f.x[i] = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                          e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
  }
  const int row = tid >> 4, gn = n0 + (tid & 15) * 8;  // 16 packed rows x 16 chunks
  const int local = pl0 + row;
  const size_t pr = (size_t)g * half + local;
  if (vecw && local < half && gn + 8 <= N) {
    f.w = *reinterpret_cast<const uint2*>(p + pr * N + gn);
  } else {
    uint32_t w[2] = {0x88888888u, 0x88888888u};  // nibble 8: q = 0
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (local < half && gn + j < N) {
        w[j >> 2] &= ~(0xFFu << (8 * (j & 3)));
        w[j >> 2] |= (uint32_t)p[pr * N + gn + j] << (8 * (j & 3));
      }
    f.w = make_uint2(w[0], w[1]);
  }
}

__device__ __forceinline__ void stage_store(Stage& s, const Fetch& f, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    *reinterpret_cast<uint4*>(&s.a[(c >> 2) * A_LD + (c & 3) * 8]) = f.x[i];
  }
  const uint32_t w0 = f.w.x, w1 = f.w.y;  // bytes 0-3, 4-7
  const int row = tid >> 4, col = (tid & 15) * 8;
  // low nibbles -> row, high nibbles -> 16 + row
  const uint4 lo = make_uint4(nib_pair(w0, w0 >> 8, 0), nib_pair(w0 >> 16, w0 >> 24, 0),
                              nib_pair(w1, w1 >> 8, 0), nib_pair(w1 >> 16, w1 >> 24, 0));
  const uint4 hi = make_uint4(nib_pair(w0, w0 >> 8, 4), nib_pair(w0 >> 16, w0 >> 24, 4),
                              nib_pair(w1, w1 >> 8, 4), nib_pair(w1 >> 16, w1 >> 24, 4));
  *reinterpret_cast<uint4*>(&s.b[row * B_LD + col]) = lo;
  *reinterpret_cast<uint4*>(&s.b[(PK + row) * B_LD + col]) = hi;
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
    int4_mm_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                   const float* __restrict__ scale, OutT* __restrict__ y, int M, int K,
                   int N, int n_groups, bool vecx, bool vecw) {
  __shared__ __align__(16) Stage ring[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  const int G = K / n_groups, half = G / 2;
  const int spg = (half + PK - 1) / PK;  // k-steps per group
  const int steps = n_groups * spg;
  const int g_lane = lane >> 2, c2 = (lane & 3) * 2;

  float acc[4][4][4], part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = part[i][j][r] = 0.f;

  Fetch f;
  fetch(f, x, p, M, K, N, G, 0, 0, m0, n0, vecx, vecw, tid);
  stage_store(ring[0], f, tid);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int g = t / spg, sub = t % spg;
    if (t + 1 < steps) {
      const int g1 = (t + 1) / spg, sub1 = (t + 1) % spg;
      fetch(f, x, p, M, K, N, G, g1, sub1 * PK, m0, n0, vecx, vecw, tid);
    }
    const Stage& s = ring[t & 1];
#pragma unroll
    for (int kk = 0; kk < 2 * PK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], &s.a[(wm + i * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], &s.b[(kk + (lane & 15)) * B_LD + wn + j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(part[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
    if (sub == spg - 1) {  // the group's last k-step: acc += part * scale[g]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + j * 8 + c2;
        const float s0 = n < N ? scale[(size_t)g * N + n] : 0.f;
        const float s1 = n + 1 < N ? scale[(size_t)g * N + n + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] += part[i][j][0] * s0;
          acc[i][j][1] += part[i][j][1] * s1;
          acc[i][j][2] += part[i][j][2] * s0;
          acc[i][j][3] += part[i][j][3] * s1;
#pragma unroll
          for (int r = 0; r < 4; ++r) part[i][j][r] = 0.f;
        }
      }
    }
    if (t + 1 < steps) stage_store(ring[(t + 1) & 1], f, tid);
    __syncthreads();
  }

  // epilogue: accumulator (row g or g + 8, columns 2*(lane % 4) + {0, 1})
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + c2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm + i * 16 + g_lane + hh * 8;
        if (m >= M) continue;
        OutT* out = y + (size_t)m * N + n;
        if (n < N) store_out(out, acc[i][j][2 * hh]);
        if (n + 1 < N) store_out(out + 1, acc[i][j][2 * hh + 1]);
      }
    }
  }
}

// --------------------------------------------------------------------------
// M <= 4: GEMV
// --------------------------------------------------------------------------

constexpr int GV_CT = 8;            // column threads, 16 columns (one 16-byte load) each
constexpr int GV_SL = 32;           // row slices
constexpr int GV_THREADS = GV_CT * GV_SL;
constexpr int GV_BN = 16 * GV_CT;   // 128 output columns per block
constexpr int GV_MAX_M = 4;

template <int MT>
__device__ __forceinline__ void fold(float (&acc)[MT][16], float (&part)[MT][16],
                                     const float* __restrict__ scale, int g, int N, int n) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float sc = n + c < N ? scale[(size_t)g * N + n + c] : 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      acc[m][c] += part[m][c] * sc;
      part[m][c] = 0.f;
    }
  }
}

// Block (blockIdx.x, blockIdx.y) = (128-column tile, split of the packed
// rows). Each of the 32 slices takes a contiguous run of the split's rows
// and keeps one partial per group, folded with the group's scale when the
// run leaves the group. Slices are summed through warp shuffles and shared
// memory; with several splits each block writes its f32 partial to `ws` and
// the last block of a column tile to arrive (atomic counter, reset after
// use) sums the splits in order, so the result does not depend on timing.
template <int MT, typename OutT>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ p,
                     const float* __restrict__ scale, OutT* __restrict__ y,
                     float* __restrict__ ws, int* __restrict__ counters, int M, int K,
                     int N, int n_groups, int rows_per_split, bool vecw) {
  __shared__ float red[GV_SL / 4][MT][GV_BN];
  __shared__ bool is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % GV_CT, sl = tid / GV_CT;
  const int n = blockIdx.x * GV_BN + ct * 16;
  const int G = K / n_groups, half = G / 2, rows = K / 2;
  const int r0 = blockIdx.y * rows_per_split, r1 = min(rows, r0 + rows_per_split);
  const int per = (r1 - r0 + GV_SL - 1) / GV_SL;
  const int s0 = min(r1, r0 + sl * per), s1 = min(r1, s0 + per);

  float acc[MT][16], part[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = part[m][c] = 0.f;

  int g = s0 / half;
#pragma unroll 4
  for (int r = s0; r < s1; ++r) {
    const int gr = r / half;
    if (gr != g) {
      fold<MT>(acc, part, scale, g, N, n);
      g = gr;
    }
    uint32_t w[4];
    if (vecw && n + 16 <= N) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + (size_t)r * N + n));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = 0x88888888u;  // nibble 8: q = 0
      for (int c = 0; c < 16 && n + c < N; ++c) {
        w[c >> 2] &= ~(0xFFu << (8 * (c & 3)));
        w[c >> 2] |= (uint32_t)p[(size_t)r * N + n + c] << (8 * (c & 3));
      }
    }
    const int klo = g * G + (r - g * half), khi = klo + half;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= M) break;
      const float xl = __bfloat162float(x[(size_t)m * K + klo]);
      const float xh = __bfloat162float(x[(size_t)m * K + khi]);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const uint32_t b = w[c >> 2] >> (8 * (c & 3));
        const float lo = (float)((int)(b & 15u) - 8), hi = (float)((int)((b >> 4) & 15u) - 8);
        part[m][c] = fmaf(xh, hi, fmaf(xl, lo, part[m][c]));
      }
    }
  }
  if (s0 < s1) fold<MT>(acc, part, scale, g, N, n);

  // the 4 slices of a warp (lanes ct, ct+8, ct+16, ct+24), then the 8 warps
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < GV_CT) red[warp][m][ct * 16 + c] = v;
    }
  __syncthreads();
  const int splits = gridDim.y;
  for (int o = tid; o < MT * GV_BN; o += GV_THREADS) {
    const int m = o / GV_BN, col = o % GV_BN, gn = blockIdx.x * GV_BN + col;
    if (m >= M || gn >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < GV_SL / 4; ++w2) sum += red[w2][m][col];
    if (splits == 1)
      store_out(y + (size_t)m * N + gn, sum);
    else
      ws[((size_t)blockIdx.y * M + m) * N + gn] = sum;
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < MT * GV_BN; o += GV_THREADS) {
    const int m = o / GV_BN, col = o % GV_BN, gn = blockIdx.x * GV_BN + col;
    if (m >= M || gn >= N) continue;
    float sum = 0.f;
    for (int k2 = 0; k2 < splits; ++k2) sum += __ldcg(&ws[((size_t)k2 * M + m) * N + gn]);
    store_out(y + (size_t)m * N + gn, sum);
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

template <typename OutT>
int launch(const bf16* x, const uint8_t* p, const float* scale, OutT* y, float* ws,
           int* counters, int M, int K, int N, int n_groups, int splits, cudaStream_t s) {
  const int G = K / n_groups;
  if (M <= GV_MAX_M) {
    if (splits < 1 || splits > 65535 || (splits > 1 && (ws == nullptr || counters == nullptr)))
      return (int)cudaErrorInvalidValue;
    const bool vecw = N % 16 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    const int rows = K / 2, rows_per_split = (rows + splits - 1) / splits;
    const dim3 grid((N + GV_BN - 1) / GV_BN, splits);
    if (M == 1)
      int4_gemv_kernel<1, OutT><<<grid, GV_THREADS, 0, s>>>(
          x, p, scale, y, ws, counters, M, K, N, n_groups, rows_per_split, vecw);
    else if (M == 2)
      int4_gemv_kernel<2, OutT><<<grid, GV_THREADS, 0, s>>>(
          x, p, scale, y, ws, counters, M, K, N, n_groups, rows_per_split, vecw);
    else
      int4_gemv_kernel<4, OutT><<<grid, GV_THREADS, 0, s>>>(
          x, p, scale, y, ws, counters, M, K, N, n_groups, rows_per_split, vecw);
  } else {
    const bool vecx = K % 8 == 0 && (G / 2) % 8 == 0 &&
                      (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const bool vecw = N % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    int4_mm_kernel<OutT><<<grid, THREADS, 0, s>>>(x, p, scale, y, M, K, N, n_groups, vecx, vecw);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16 (y). x (M, K) bf16, packed (K/2, N)
// uint8, scale (n_groups, N) f32 and y (M, N) are contiguous row-major; K is
// even and a multiple of n_groups with an even group size. For M <= 4 the
// packed rows are cut into `splits` parts; with splits > 1, ws holds
// splits * M * N f32 and counters ceil(N / 128) int32 zeros (left zero).
// Returns the cudaError_t of the launch (0 = launched).
int int4_matmul_launch(int out_dtype, const void* x, const void* packed,
                       const void* scale, void* y, int M, int K, int N,
                       int n_groups, int splits, void* ws, void* counters,
                       void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_groups <= 0 || K % n_groups != 0 ||
      (K / n_groups) % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* p = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (out_dtype == 1)
    return launch(xb, p, sc, static_cast<bf16*>(y), w, cnt, M, K, N, n_groups, splits, s);
  if (out_dtype == 0)
    return launch(xb, p, sc, static_cast<float*>(y), w, cnt, M, K, N, n_groups, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
