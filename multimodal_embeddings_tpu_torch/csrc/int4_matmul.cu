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
// Three forms (form_of; kernels/quantization_int4.py::mm_form mirrors it):
//
// * M > 4 where TMA can describe every operand (G = 64 or G % 128 == 0,
//   N % 16 == 0, 16-byte-aligned bases; every Qwen2.5-VL-32B prefill
//   projection): the wgmma form. What bounds it: at the 32B prefill's
//   M = 1535 rows a product does ~6000 flops per weight byte, so the tensor
//   cores bound it (95.8 TFLOP per prefill, 96.9 ms at 989 TFLOP/s), and
//   next the shared memory a chunk of 128 weight rows moves per CTA against
//   its 1,024 tensor-core cycles: wgmma's reads of x (64 KB) and TMA's
//   writes (40 KB). Persistent CTAs of 384 threads in clusters of two walk
//   128 x 128 output tiles. One thread keeps a ring of 5 stages by TMA, a
//   stage one chunk: x's 128 x 128 bf16 (each CTA of the pair loads half the
//   rows, multicast into both), the chunk's 64 x 128 packed bytes and the
//   group's 128 scales. The product is taken transposed, y^T = q^T x^T, so
//   the weight is wgmma's register operand: each of two consumer warpgroups
//   turns its 64 columns' nibbles into A fragments (ldmatrix.trans, then per
//   two values one LOP3 and one bf16x2 FMA: 0x4300 | n is the bf16 128 + n,
//   less 136 is q, exact, no int-to-float conversion), the next chunk's
//   while this chunk's wgmma m64n128k16 run against x as the K-major B; a
//   group's first product starts from zero (scale-d = 0), and after the
//   group's last the f32 fold acc += part * scale. Measured on the way
//   (scripts/torch_k3_prefill_probe.py): a dequantising warpgroup writing a
//   bf16 B tile to shared memory for both consumers (wgmma SS) moved ~168 KB
//   per chunk; the double-buffered A fragments keep the dequantisation off
//   the path between two chunks' products; the multicast halves x's L2
//   reads. Each output is summed by one thread in a fixed order: two calls
//   give the same bits.
// * M > 4 otherwise (a G, N or base the rule refuses): the mma.sync form,
//   after K2 (csrc/int8_matmul.cu). 128x128 output tiles of 8 warps (each
//   64x32), mma.sync m16n8k16 (bf16 in, f32 accumulate). A k-step takes 16
//   packed rows = 32 weight rows, 16 low-nibble and 16 high-nibble rows, with
//   the x columns of the same 32 rows beside them, so every packed byte is
//   read once. A two-stage shared-memory ring is filled from registers loaded
//   one step ahead, the nibbles turned into bf16 as above. Each warp keeps a
//   per-group partial accumulator and folds it into the output accumulator
//   with the group's scale row after the group's last k-step.
// * M <= 4 (decode): a GEMV on the CUDA cores. What bounds it: decode reads
//   every weight byte once per token for 2 flops per weight per row, so HBM
//   bandwidth bounds it (17.0 GB per 32B decode step: 5.07 ms at 3.35 TB/s),
//   and the instruction issue comes next (32 G nibbles per step). So a nibble
//   is never converted from int to float: masked in place, its bits are a
//   subnormal float that multiplies a power-of-two-scaled x exactly (gv_word;
//   one LOP3 and one FFMA per nibble, where an I2F-based dequantization took
//   ~11 instructions per byte); the sum over the stored nibble n becomes the
//   sum over q = n - 8 with -8 times the rows' x sum at each group's fold.
//   x is staged per CTA in shared memory. The (256-column tile, group) units
//   are cut into equal contiguous shares over the CTAs the card holds at once
//   (stream-K), each thread keeping the next 8 rows' 16-byte loads in flight
//   in registers, and a cut tile's partials are summed in a fixed order.
//   A tensor-core GEMV would need the weight laid out again, which the
//   shared layout above forbids.
//
// Ragged M and N: TMA reads rows and columns past the edge as zero in the
// wgmma form, whose stores are masked; the other two zero-fill their tiles'
// edges, with vector loads where rows are aligned (checked in the launcher)
// and element loads elsewhere.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// Two nibbles -> bf16x2 (q_a, q_b), q = n - 8, with no int->float
// conversion: a PRMT puts bytes a and b of w at bytes 0 and 2 (selector
// 0x4140: bytes 0, 1; 0x4342: bytes 2, 3), a LOP3 keeps their low nibbles n
// under 0x4300 (the bf16 bits of 128 + n), and one packed bf16x2 FMA
// subtracts 136 (0xC308), exact. For the high nibbles w is shifted right 4.
__device__ __forceinline__ uint32_t q_bf16x2(uint32_t t) {  // the low nibbles of bytes 0, 2
  uint32_t u, r;  // (t & 0x000F000F) | 0x43004300 as one LOP3: the second constant in a register
  asm("lop3.b32 %0, %1, 0x000F000F, %2, 0xEA;\n" : "=r"(u) : "r"(t), "r"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(u), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ uint32_t q_pair(uint32_t w, uint32_t sel) {
  return q_bf16x2(__byte_perm(w, 0u, sel));
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
  const uint4 lo = make_uint4(q_pair(w0, 0x4140u), q_pair(w0, 0x4342u), q_pair(w1, 0x4140u),
                              q_pair(w1, 0x4342u));
  const uint4 hi = make_uint4(q_pair(w0 >> 4, 0x4140u), q_pair(w0 >> 4, 0x4342u),
                              q_pair(w1 >> 4, 0x4140u), q_pair(w1 >> 4, 0x4342u));
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

  // (g, sub): step t's group and k-step in it, counted (no division)
  for (int t = 0, g = 0, sub = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      const bool wrap = sub + 1 == spg;
      fetch(f, x, p, M, K, N, G, wrap ? g + 1 : g, wrap ? 0 : (sub + 1) * PK, m0, n0, vecx,
            vecw, tid);
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
    if (++sub == spg) {
      sub = 0;
      ++g;
    }
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
// M > 4 where TMA can describe the operands: warp-specialised wgmma
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // WG0 loads (one thread), WG1-2 dequantise and multiply
constexpr int WT = 128;          // output tile: 128 rows of x x 128 columns of W
constexpr int WC = 2;            // CTAs per cluster: adjacent N tiles sharing each x tile
constexpr int SMEM_LIMIT = 232448;

// A chunk is KC weight rows of one group: KC / 2 packed rows whose low
// nibbles are the chunk's k rows [0, KC/2) and high nibbles its rows
// [KC/2, KC). KC = 128 for G % 128 == 0 (chunk c of a group takes packed
// rows [64c, 64c + 64) and x columns g*G + 64c and g*G + G/2 + 64c, 64 each:
// at G = 128 that is x's natural order), KC = 64 for G = 64 (one 64-column
// x box).
template <int KC>
struct WgShape {
  static constexpr int X_BYTES = WT * KC * 2;  // x: KC / 64 atoms of 128 rows x 128 B
  static constexpr int P_BYTES = KC / 2 * WT;  // packed: KC / 2 rows x 128 B
  static constexpr int S_BYTES = WT * 4;       // the group's 128 f32 scales
  static constexpr int STAGE = X_BYTES + P_BYTES;
  // the 1,024 bytes in front align the base for the swizzle
  static constexpr int fit(int s) { return 1024 + s * (STAGE + S_BYTES) + 16 * s; }
  // ring stages: as many as fit, at most 8 (5 at KC = 128: 41,472 bytes each)
  static constexpr int stages() {
    int s = 8;
    while (fit(s) > SMEM_LIMIT) --s;
    return s;
  }
  static constexpr int STAGES = stages();
  static constexpr int SMEM = fit(STAGES);
};
static_assert(WgShape<128>::STAGES >= 3, "the wgmma form's ring");

// One launch: the TMA maps of x (boxes of 64 columns x 128 / WC rows,
// 128-byte swizzle: each CTA of a cluster loads its share of the tile's rows
// for all), packed (128 bytes x KC/2 rows, 128-byte swizzle) and scale (128
// f32 x 1 row), the output and its shape; `groups` counts the clusters' tile
// groups (WC adjacent N tiles of one M tile).
struct WgParams {
  CUtensorMap xmap, pmap, smap;
  void* y;
  int M, N, G, nchunks, cpg, mt, groups;
};

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

// arrive on the barrier at the same offset in cluster member `cta`
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the same box into every CTA of the cluster, each signalling its own barrier
__device__ __forceinline__ void tma_load_2d_all(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"((uint16_t)((1u << WC) - 1))
      : "memory");
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 lds64f(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// shared-memory matrix descriptor of a K-major operand with the 128-byte
// swizzle: start and stride byte offsets (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving register reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (64 x 128, f32) = [d +] A (registers) . B (smem, K-major), k = 16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The A fragments of one chunk's KS k-steps for this thread's columns n,
// n + 1 (rows lane / 4 and lane / 4 + 8 of its warp's 16), from the packed
// tile at `pt`. One ldmatrix.trans of four 8 x 8 matrices of 16-bit pairs
// (8 packed rows x the warp's 16 byte columns each, row addresses `lane_off`
// with the 128-byte swizzle) gives the thread, per matrix, columns n, n + 1
// of packed rows 2c and 2c + 1 (c = lane % 4) in one word: bytes n@2c,
// (n+1)@2c, n@2c+1, (n+1)@2c+1. So a word v makes, with no PRMT, the low
// k-step's pairs q(v) (column n) and q(v >> 8) (n + 1) and the high
// k-step's q(v >> 4) and q(v >> 12).
template <int KS>
__device__ __forceinline__ void dequant_chunk(uint32_t (&a)[KS][4], uint32_t pt,
                                              uint32_t lane_off) {
  constexpr int LOW = KS / 2;
#pragma unroll
  for (int h = 0; h < LOW / 2; ++h) {  // low k-steps 2h, 2h + 1: packed rows 32h ..
    uint32_t r[4];
    ldsm_x4_trans(r, pt + 32 * h * 128 + lane_off);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * h + q;
      const uint32_t v0 = r[2 * q], v1 = r[2 * q + 1];  // rows 16j + 2c, +1 and 16j + 8 + 2c, +1
      a[j][0] = q_bf16x2(v0), a[j][1] = q_bf16x2(v0 >> 8);
      a[j][2] = q_bf16x2(v1), a[j][3] = q_bf16x2(v1 >> 8);
      a[LOW + j][0] = q_bf16x2(v0 >> 4), a[LOW + j][1] = q_bf16x2(v0 >> 12);
      a[LOW + j][2] = q_bf16x2(v1 >> 4), a[LOW + j][3] = q_bf16x2(v1 >> 12);
    }
  }
}

// acc += part * scale[g]: rows n (d[4i], d[4i + 1]) and n + 1 (d[4i + 2], d[4i + 3])
__device__ __forceinline__ void fold(float (&acc)[64], const float (&part)[64], float2 sc) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    acc[4 * i] = fmaf(part[4 * i], sc.x, acc[4 * i]);
    acc[4 * i + 1] = fmaf(part[4 * i + 1], sc.x, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(part[4 * i + 2], sc.y, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(part[4 * i + 3], sc.y, acc[4 * i + 3]);
  }
}

// The product is taken transposed, y^T = q^T x^T, so the dequantised weight
// is wgmma's register operand A and never goes back to shared memory:
// consumer warpgroup g takes the tile's columns [64g, 64g + 64) as A's 64
// rows and x's 128 rows (K-major, as TMA wrote them) as B. A row r of warp w
// stands for column 16w + 2(r % 8) + (r % 16) / 8 of the warpgroup's 64, so
// a thread's two A rows (lane / 4 and lane / 4 + 8) are two adjacent columns
// n, n + 1, which ldmatrix hands it together (dequant_chunk), and it stores
// its outputs (row m, columns n, n + 1) as pairs.
//
// CTAs run in clusters of WC, a cluster taking WC adjacent N tiles of one M
// tile at a time: each CTA loads its 128 / WC rows of the x tile by a TMA
// multicast into all, so x is read from L2 once per cluster (x is 80% of a
// stage's bytes, and L2 to SM traffic bounds the loads: 4.2 GB per gate,up
// call with CTAs alone), and a stage is refilled only when the consumers of
// every CTA have released it (its empty barrier counts them all). The
// persistent clusters walk the tile groups p = cluster, + clusters, ... in
// M-fastest order (M tile p % mt, N tiles WC (p / mt) + rank), so the
// clusters resident together share W's columns and x in L2; where a group
// runs past N, its last CTAs compute tiles past N and store nothing. Each
// tile is nchunks chunks in order; both roles keep one count of chunks
// across the CTA's tiles, which sets the ring slot and barrier parity of
// each. A
// consumer issues chunk t's products, dequantises chunk t + 1 into its
// second set of A registers while they run, waits for them, releases the
// stage and folds; the two warpgroups' products and folds interleave as
// the tensor cores take them (a turn-taking schedule between them measured
// 2% slower per prefill, scripts/torch_k3_prefill_probe.py).
template <int KC, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
    int4_mm_wgmma_kernel(const __grid_constant__ WgParams p) {
  using Sh = WgShape<KC>;
  constexpr int S = Sh::STAGES, KS = KC / 16;  // k-steps per chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t scales = base + S * Sh::STAGE;
  const uint32_t bars = scales + S * Sh::S_BYTES;
  auto x_tile = [&](int s) { return base + s * Sh::STAGE; };
  auto p_tile = [&](int s) { return base + s * Sh::STAGE + Sh::X_BYTES; };
  auto full_bar = [&](int s) { return bars + 8 * s; };         // x, packed, scale landed
  auto empty_bar = [&](int s) { return bars + 8 * (S + s); };  // consumers done with them

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full_bar(s), 1);
      bar_init(empty_bar(s), 8 * WC);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // no CTA signals or writes into another before its barriers exist

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int rank = (int)cluster_rank(), group0 = blockIdx.x / WC, groups_step = gridDim.x / WC;
  if (wg == 0) {
    // ---------------- loads: one thread issues every TMA copy ----------------
    regs_dec<40>();
    if (tid == 0) {
      int s = 0, ph = 0, mi = group0, gn = 0;
      while (mi >= p.mt) mi -= p.mt, ++gn;
      for (int t = group0; t < p.groups; t += groups_step) {
        const int m0 = mi * WT + rank * (WT / WC), n0 = (WC * gn + rank) * WT;  // m0: our rows
        for (int c = 0, g = 0, sub = 0; c < p.nchunks; ++c) {
          bar_wait(empty_bar(s), ph ^ 1);
          const uint32_t full = full_bar(s), xr = x_tile(s) + rank * (WT / WC) * 128;
          bar_arrive_tx(full, Sh::STAGE + Sh::S_BYTES);
          if constexpr (KC == 64) {
            tma_load_2d_all(xr, &p.xmap, full, g * p.G, m0);
          } else {
            tma_load_2d_all(xr, &p.xmap, full, g * p.G + 64 * sub, m0);
            tma_load_2d_all(xr + Sh::X_BYTES / 2, &p.xmap, full, g * p.G + p.G / 2 + 64 * sub,
                            m0);
          }
          tma_load_2d(p_tile(s), &p.pmap, full, n0, g * (p.G / 2) + sub * (KC / 2));
          tma_load_2d(scales + s * Sh::S_BYTES, &p.smap, full, n0, g);
          if (++s == S) s = 0, ph ^= 1;
          if (++sub == p.cpg) sub = 0, ++g;
        }
        mi += groups_step;
        while (mi >= p.mt) mi -= p.mt, ++gn;
      }
    }
    cluster_sync();  // no CTA exits while another may still write into it
    return;
  }

  // ---------------- consumers: 64 columns of the tile each ----------------
  regs_inc<232>();
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, c4 = lane & 3;
  const int ncol = 64 * g + 16 * warp + 2 * (lane >> 2);  // this thread's columns n, n + 1
  // the row this lane addresses for ldmatrix: packed row lane (+ 32h), the
  // warp's 16-byte column chunk XOR row % 8 (the 128-byte swizzle)
  const uint32_t lane_off =
      (uint32_t)lane * 128 + (((uint32_t)(ncol >> 4) ^ (uint32_t)(lane & 7)) << 4);
  float acc[64], part[64];
  uint32_t a0[KS][4], a1[KS][4];  // A of this chunk and of the next, dequantised under this one's products
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  int s = 0, ph = 0, mi = group0, gn = 0, t = group0, c = 0, sub = 0;
  while (mi >= p.mt) mi -= p.mt, ++gn;
  bar_wait(full_bar(0), 0);
  dequant_chunk<KS>(a0, p_tile(0), lane_off);
  // One chunk: its products from `cur`, the next chunk's A into `nxt` while
  // they run, then the fold. False after the CTA's last chunk.
  auto chunk = [&](uint32_t(&cur)[KS][4], uint32_t(&nxt)[KS][4]) -> bool {
    const bool last = sub == p.cpg - 1;  // the group's last chunk: fold after it
    fence_regs(cur);
    wgmma_fence();
    // B: x's 128 rows, k-step j in atom j / 4 at byte 32 (j % 4); the
    // group's first product starts part at zero
    const uint64_t xd = desc128(x_tile(s));
#pragma unroll
    for (int j = 0; j < KS; ++j)
      wgmma_rs_n128(part, cur[j], xd + (((j >> 2) * WT * 128 + (j & 3) * 32) >> 4),
                    sub > 0 || j > 0);
    wgmma_commit();
    const float2 sc = lds64f(scales + s * Sh::S_BYTES + ncol * 4);
    const int done = s;
    // the next chunk: in this tile, or the first of the next tile
    const bool tile_end = c + 1 == p.nchunks;
    const bool more = !tile_end || t + groups_step < p.groups;
    if (++s == S) s = 0, ph ^= 1;
    if (more) {
      bar_wait(full_bar(s), ph);
      dequant_chunk<KS>(nxt, p_tile(s), lane_off);
    }
    wgmma_wait0();
    fence_regs(part);
    fence_regs(cur);
    __syncwarp();
    if (lane == 0)  // the stage is free in every CTA of the cluster
      for (int r = 0; r < WC; ++r) bar_arrive_remote(empty_bar(done), r);
    if (last) fold(acc, part, sc);
    if (++sub == p.cpg) sub = 0;
    if (!tile_end) {
      ++c;
      return true;
    }
    // epilogue: y[m, n], y[m, n + 1] for m = 8i + 2c4 + {0, 1}; N % 16 == 0,
    // so the pair is inside N or outside it whole
    const int n = (WC * gn + rank) * WT + ncol;
    if (n < p.N) {
      OutT* y = static_cast<OutT*>(p.y) + n;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = mi * WT + 8 * i + 2 * c4 + e;
          if (m < p.M) store_pair(y + (size_t)m * p.N, acc[4 * i + e], acc[4 * i + 2 + e]);
        }
    }
    if (!more) return false;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    c = 0;
    t += groups_step;
    mi += groups_step;
    while (mi >= p.mt) mi -= p.mt, ++gn;
    return true;
  };
  while (chunk(a0, a1) && chunk(a1, a0)) {
  }
  cluster_sync();
}

// --------------------------------------------------------------------------
// M <= 4: GEMV
// --------------------------------------------------------------------------

constexpr int GV_THREADS = 128;
constexpr int GV_CT = 16;                  // column threads, 16 columns (one 16-byte load) each
constexpr int GV_SL = GV_THREADS / GV_CT;  // 8 row slices
constexpr int GV_TN = 16 * GV_CT;          // 256 output columns per tile
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_XBYTES = 20480;           // the x window in shared memory
constexpr int GV_MAX_M = 4;

// consecutive packed rows a thread takes per chunk: 8, or 2 where four rows
// of x need the registers; a chunk is 8 slices of them (64 rows at 8)
__host__ __device__ constexpr int gv_rows(int mt) { return mt == 4 ? 2 : 8; }
__host__ __device__ constexpr int gv_chunk(int mt) { return GV_SL * gv_rows(mt); }
// a packed row of x takes 20 bytes per row of x: its four scaled values and
// the f32 sum of its two rows
__host__ __device__ constexpr int gv_xrows(int mt) { return GV_XBYTES / (20 * mt); }
__host__ __device__ constexpr int gv_smem(int mt) {
  return GV_XBYTES + GV_WARPS * mt * GV_TN * 4;
}
// within the 48 KB a launch may take without raising its attribute (the
// kernel's static shared memory is a few bytes)
static_assert(gv_smem(GV_MAX_M) + 64 <= 48 * 1024, "the GEMV's shared memory");

// A 16-byte load of weight bytes, which are read once per call: not kept in
// L1, evicted first from L2.
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// One 32-bit word of packed bytes (columns c0 .. c0 + 3) times one packed
// row's x. A nibble masked in place (LOP3) is, as the bits of a float, the
// subnormal n · 2^(p - 149) for its bit position p (0, 4, 8 or 12: bytes 2
// and 3 are read from w >> 16), so it is multiplied by the row's x scaled by
// 2^(k - p) (xv = x_lo·2^k, x_hi·2^(k-4), x_lo·2^(k-8), x_hi·2^(k-12)) and
// the product is x·n·2^(k - 149), exact: an 8-bit by 4-bit significand, with
// k chosen per x window so that every x within 2^118 of the window's largest
// lands at or above 2^-149. One LOP3 and one FFMA per nibble and a SHF per
// word, no int->float conversion. The sum over n (0 .. 15) is turned into
// the sum over q = n - 8 at the fold, with -8 times the f32 sum of the rows'
// x (gv_flush).
template <int MT>
__device__ __forceinline__ void gv_word(float (&part)[MT][16], int c0, uint32_t w,
                                        const float4 (&xv)[MT]) {
  const uint32_t v = w >> 16;
  const float d0 = __uint_as_float(w & 0xFu), d1 = __uint_as_float(w & 0xF0u);
  const float d2 = __uint_as_float(w & 0xF00u), d3 = __uint_as_float(w & 0xF000u);
  const float d4 = __uint_as_float(v & 0xFu), d5 = __uint_as_float(v & 0xF0u);
  const float d6 = __uint_as_float(v & 0xF00u), d7 = __uint_as_float(v & 0xF000u);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    part[m][c0] = fmaf(xv[m].y, d1, fmaf(xv[m].x, d0, part[m][c0]));
    part[m][c0 + 1] = fmaf(xv[m].w, d3, fmaf(xv[m].z, d2, part[m][c0 + 1]));
    part[m][c0 + 2] = fmaf(xv[m].y, d5, fmaf(xv[m].x, d4, part[m][c0 + 2]));
    part[m][c0 + 3] = fmaf(xv[m].w, d7, fmaf(xv[m].z, d6, part[m][c0 + 3]));
  }
}

// 2^e as a float, -126 <= e <= 127
__device__ __forceinline__ float gv_exp2(int e) { return __int_as_float((e + 127) << 23); }

// acc += (sum over the rows so far of x·q) · scale, and part, xsum = 0: the
// rows' x·n sum is part · 2^(149 - k) (two exact scalings), less 8 times
// their x sum, in one rounding.
template <int MT>
__device__ __forceinline__ void gv_flush(float (&acc)[MT][16], float (&part)[MT][16],
                                         float (&xsum)[MT], const float (&sc)[16], float unscale) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float corr = -8.f * xsum[m];
#pragma unroll
    for (int cc = 0; cc < 16; ++cc) {
      acc[m][cc] += fmaf(part[m][cc] * 18446744073709551616.f, unscale, corr) * sc[cc];
      part[m][cc] = 0.f;
    }
    xsum[m] = 0.f;
  }
}

// x / d for 0 <= x < 2^31 by a multiply and a shift (no division, so no
// int->float conversion); `gv_divisor` finds mul and shr on the host.
struct GvDiv {
  int d;
  uint32_t mul, shr;
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : (int)(__umulhi((uint32_t)x, mul) >> shr);
  }
};

GvDiv gv_divisor(int d) {
  GvDiv r{d, 0u, 0u};
  if (d > 1) {
    int log2d = 0;  // ceil(log2(d))
    while ((1ll << log2d) < d) ++log2d;
    const int p = 31 + log2d;
    r.mul = (uint32_t)(((1ull << p) + (uint64_t)d - 1) / (uint64_t)d);
    r.shr = (uint32_t)(p - 32);
  }
  return r;
}

// The GEMV's operands and its plan, computed on the host. There are
// units = ceil(N / 256) · n_groups (tile, group) units; CTA c's share is
// [start(c), start(c + 1)) with start(c) = c · base + min(c, rem), base =
// units / grid and rem = units % grid: the cut gemv_plan describes.
struct GemvArgs {
  const bf16* x;
  const uint8_t* p;
  const float* scale;
  float* ws;
  int* counters;
  int M, K, N, n_groups, half, nch, base, rem;
  GvDiv by_groups, by_half;
  bool vecw, vecs;
  __device__ __forceinline__ int start(int c) const { return c * base + min(c, rem); }
};

// A position in a CTA's share: 256-column tile t, group g, chunk ch.
struct GvPos {
  int t, g, ch;
  __device__ __forceinline__ void next(int nch, int n_groups) {
    if (++ch == nch) {
      ch = 0;
      if (++g == n_groups) {
        g = 0;
        ++t;
      }
    }
  }
};

// Stream-K over (256-column tile, group) units: CTA c takes a contiguous
// share of the units in tile-major order, so a share spans whole groups of
// one or more tiles, and the shares differ by at most one unit. Its steps are
// chunks of those groups: thread (slice sl, column thread ct) takes R
// consecutive packed rows (R = 8, or 2 at MT = 4) of a chunk at 16 columns,
// loading the next step's rows into registers while it computes this one's.
// x is staged per window of packed rows (the rows the share needs in a tile,
// up to XR): for each row, x_lo and x_hi scaled for gv_word by 2^k, k from
// the window's largest |x|, and the f32 sum x_lo + x_hi. Each thread folds
// its group partial with the group's 16 scales (four 16-byte loads, issued
// before the chunk's products) after the group's last chunk (gv_flush). At a
// tile's last unit in the share the slices are summed (shuffle, then the 4
// warps in order through shared memory); a tile whole in the share is
// stored, a cut one leaves its f32 partial in ws (slot 0 where the share
// starts in the tile, else 1) and the tile's last CTA to arrive (acq_rel
// counter, reset after use) sums the partials in CTA order, so the result
// does not depend on timing.
template <int MT, typename OutT>
__global__ void __launch_bounds__(GV_THREADS)
    int4_gemv_kernel(const GemvArgs a, OutT* __restrict__ y) {
  constexpr int R = gv_rows(MT), CHUNK = gv_chunk(MT), XR = gv_xrows(MT);
  extern __shared__ __align__(16) unsigned char gv_buf[];
  float4* xs = reinterpret_cast<float4*>(gv_buf);                  // [MT][XR]
  float* xsums = reinterpret_cast<float*>(gv_buf + 16 * MT * XR);  // [MT][XR]
  float* red = reinterpret_cast<float*>(gv_buf + GV_XBYTES);
  __shared__ bool is_last;
  __shared__ unsigned xmax;  // the window's largest |x|, as bits

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % GV_CT, sl = tid / GV_CT;
  const int c = blockIdx.x, ng = a.n_groups, half = a.half, N = a.N;
  const int u0 = a.start(c), u1 = a.start(c + 1);
  const int steps = (u1 - u0) * a.nch;
  // launched with programmatic stream serialization: the CTAs may be resident
  // before the previous kernel in the stream ends; nothing is read before it has
  asm volatile("griddepcontrol.wait;" ::: "memory");
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));

  const int t0 = a.by_groups.div(u0);
  GvPos ld{t0, u0 - t0 * ng, 0}, cu = ld;
  auto fetch = [&](uint4 (&w)[R]) {  // the weight rows of step ld, then advance ld
    const int n = ld.t * GV_TN + ct * 16, l0 = ld.ch * CHUNK + sl * R;
    const uint8_t* src = a.p + ((size_t)ld.g * half + l0) * N + n;
    if (a.vecw && n + 16 <= N && l0 + R <= half) {
#pragma unroll
      for (int j = 0; j < R; ++j) w[j] = ld_stream(src + (size_t)j * N, policy);
    } else {  // element loads; nibble 8 (q = 0) past N and past the group
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint32_t e[4] = {0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u};
        if (l0 + j < half) {
#pragma unroll
          for (int cc = 0; cc < 16; ++cc)
            if (n + cc < N)
              e[cc >> 2] = (e[cc >> 2] & ~(0xFFu << (8 * (cc & 3)))) |
                           (uint32_t)src[(size_t)j * N + cc] << (8 * (cc & 3));
        }
        w[j] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
    ld.next(a.nch, ng);
  };

  float acc[MT][16], part[MT][16], xsum[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    xsum[m] = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = part[m][j] = 0.f;
  }
  float unscale = 1.f;  // 2^(85 - k) of the staged window
  uint4 cur[R], nxt[R];
  if (steps > 0) fetch(cur);
  int xw0 = -2 * XR;  // x is staged for packed rows [xw0, xw0 + XR)

  // the tile's sum over the slices, stored where the share holds the tile
  // whole, else left in ws for the tile's last CTA to arrive, which sums
  // the partials in CTA order (uniform: every thread calls it)
  auto finish = [&](int t) {
    const int first = t * ng;
    const bool whole = first >= u0 && first + ng <= u1;
    // slices 2·warp and 2·warp + 1 by shuffle, then the warps in order
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int cc = 0; cc < 16; ++cc) {
        const float v = acc[m][cc] + __shfl_xor_sync(0xffffffffu, acc[m][cc], 16);
        if (lane < 16) red[(warp * MT + m) * GV_TN + cc * GV_CT + ct] = v;
        acc[m][cc] = 0.f;
      }
    __syncthreads();
    const int mine = 2 * c + (u0 >= first ? 0 : 1);  // this share's ws slot
    for (int o = tid; o < MT * GV_TN; o += GV_THREADS) {
      const int m = o / GV_TN, col = o % GV_TN, gn = t * GV_TN + col;
      if (m >= a.M || gn >= N) continue;
      const int at = (col % 16) * GV_CT + col / 16;
      float sum = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < GV_WARPS; ++w2) sum += red[(w2 * MT + m) * GV_TN + at];
      if (whole)
        store_out(y + (size_t)m * N + gn, sum);
      else
        a.ws[((size_t)mine * MT + m) * GV_TN + col] = sum;
    }
    if (!whole) {
      int c_first = c, c_last = c;  // the CTAs whose shares meet the tile
      while (a.start(c_first) > first) --c_first;
      while (a.start(c_last + 1) < first + ng) ++c_last;
      // the barrier orders every thread's partial before thread 0's
      // release, and its acquire before the partials' reads
      __syncthreads();
      if (tid == 0) {
        int arrived;
        asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                     : "=r"(arrived) : "l"(a.counters + t) : "memory");
        is_last = arrived == c_last - c_first;
      }
      __syncthreads();
      if (is_last) {
        const int first_slot = 2 * c_first + (a.start(c_first) >= first ? 0 : 1);
        for (int o = tid; o < MT * GV_TN; o += GV_THREADS) {
          const int m = o / GV_TN, col = o % GV_TN, gn = t * GV_TN + col;
          if (m >= a.M || gn >= N) continue;
          float sum = __ldcg(&a.ws[((size_t)first_slot * MT + m) * GV_TN + col]);
#pragma unroll 4
          for (int c2 = c_first + 1; c2 <= c_last; ++c2)  // shares starting in the tile
            sum += __ldcg(&a.ws[((size_t)2 * c2 * MT + m) * GV_TN + col]);
          store_out(y + (size_t)m * N + gn, sum);
        }
        if (tid == 0) a.counters[t] = 0;
      }
    }
    __syncthreads();  // red is free for the next tile
  };

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) fetch(nxt);
    const int n = cu.t * GV_TN + ct * 16, l0 = cu.ch * CHUNK + sl * R;
    const bool fold = cu.ch == a.nch - 1;  // the group's last chunk
    const int r_a = cu.g * half + cu.ch * CHUNK;
    const int r_b = cu.g * half + min(half, (cu.ch + 1) * CHUNK);
    const bool restage = r_a < xw0 || r_b > xw0 + XR;  // the chunk leaves the window
    float sc[16];
    if (fold || (restage && cu.ch > 0)) {
      const float* srow = a.scale + (size_t)cu.g * N + n;
      if (a.vecs && n + 16 <= N) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(srow) + q);
          sc[4 * q] = v.x;
          sc[4 * q + 1] = v.y;
          sc[4 * q + 2] = v.z;
          sc[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) sc[cc] = n + cc < N ? __ldg(srow + cc) : 0.f;
      }
    }
    if (restage) {
      // a group wider than the window: its rows so far go with this window's k
      if (cu.ch > 0) gv_flush<MT>(acc, part, xsum, sc, unscale);
      // stage the rows the share still needs in this tile, up to XR, eight
      // rows per thread in flight at a time: first x as f32 and the window's
      // largest |x|, then k = 125 - its exponent (at most 149), and x scaled
      if (tid == 0) xmax = 0u;
      __syncthreads();
      xw0 = r_a;
      const int len = min(XR, (min(u1, (cu.t + 1) * ng) - cu.t * ng) * half - r_a);
      unsigned big = 0u;
      for (int r0 = 0; r0 < len; r0 += 8 * GV_THREADS) {
        __nv_bfloat16 v[MT][8][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i * GV_THREADS + tid, pr = r_a + r;
          const int k = pr + a.by_half.div(pr) * half;  // its low row
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const bool in = r < len && m < a.M;
            v[m][i][0] = in ? a.x[(size_t)m * a.K + k] : __float2bfloat16(0.f);
            v[m][i][1] = in ? a.x[(size_t)m * a.K + k + half] : __float2bfloat16(0.f);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + i * GV_THREADS + tid;
          if (r < len)
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float lo = __bfloat162float(v[m][i][0]), hi = __bfloat162float(v[m][i][1]);
              big = max(big, max(__float_as_uint(fabsf(lo)), __float_as_uint(fabsf(hi))));
              xs[m * XR + r] = make_float4(lo, hi, 0.f, 0.f);
              xsums[m * XR + r] = lo + hi;
            }
        }
      }
      big = __reduce_max_sync(0xffffffffu, big);
      if (lane == 0) atomicMax(&xmax, big);
      __syncthreads();
      const int e = (int)(xmax >> 23) - 127;  // -127 for a zero or subnormal largest |x|
      const int k = min(149, 125 - e);
      const float up = gv_exp2(k - 64), up64 = 18446744073709551616.f;
      unscale = gv_exp2(85 - k);
      for (int r = tid; r < len; r += GV_THREADS)
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float4 f = xs[m * XR + r];
          const float lo = f.x * up * up64, hi = f.y * up * up64;
          xs[m * XR + r] = make_float4(lo, hi * 0.0625f, lo * 0.00390625f, hi * 0.000244140625f);
        }
      __syncthreads();
    }
    const float4* xrow = xs + (cu.g * half + l0 - xw0);
    const float* srow_x = xsums + (cu.g * half + l0 - xw0);
    const int rows = min(R, half - l0);  // R but in a group's last rows
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j >= rows) break;
      float4 xv[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        xv[m] = xrow[m * XR + j];
        xsum[m] += srow_x[m * XR + j];
      }
      gv_word<MT>(part, 0, cur[j].x, xv);
      gv_word<MT>(part, 4, cur[j].y, xv);
      gv_word<MT>(part, 8, cur[j].z, xv);
      gv_word<MT>(part, 12, cur[j].w, xv);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) cur[j] = nxt[j];
    if (fold) {  // acc += (the group's x·q sum) * scale[g]
      gv_flush<MT>(acc, part, xsum, sc, unscale);
      if (cu.g == ng - 1 || s == steps - 1) {  // the tile's last unit in the share
        finish(cu.t);
      }
    }
    cu.next(a.nch, ng);
  }
}

template <int MT, typename OutT>
int gemv_launch(GemvArgs a, OutT* y, int grid, cudaStream_t s) {
  const long long units = (long long)a.base * grid + a.rem;
  a.nch = (a.half + gv_chunk(MT) - 1) / gv_chunk(MT);
  if (units * a.nch > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  // programmatic stream serialization lets the CTAs be launched while the
  // previous kernel drains (the kernel waits for it before any read)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = gv_smem(MT);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err2 = cudaLaunchKernelEx(&cfg, int4_gemv_kernel<MT, OutT>, a, y);
  return (int)(err2 != cudaSuccess ? err2 : cudaGetLastError());
}

template <int MT, typename OutT>
int gemv_resident(int* ctas) {
  int per_sm = 0, dev = 0, sms = 0;
  int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, int4_gemv_kernel<MT, OutT>, GV_THREADS, gv_smem(MT));
  if (err == 0) err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *ctas = per_sm * sms;
  return err;
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

// The TMA map of a row-major (rows, cols) matrix of row_bytes per row, in
// boxes of box_cols x box_rows; rows and columns past the edge read as zero.
// Returns 0, or 1000 + the CUresult.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long cols,
              long long rows, long long row_bytes, int box_cols, int box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return 1999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The form a launch takes (kernels/quantization_int4.py::mm_form mirrors it):
// 0 the GEMV for M <= 4; 2 the wgmma form where TMA can describe every
// operand and a chunk is whole: G = 64 or G % 128 == 0 (so K % 8 == 0), N %
// 16 == 0 (packed's and scale's row strides), x, packed and scale on 16-byte
// boundaries; 1 the mma.sync form for every other M > 4 shape (a G that is
// not one of those, an N that is not a multiple of 16, a base off 16 bytes).
int form_of(int M, int K, int N, int n_groups, const void* x, const void* p, const void* s) {
  if (M <= GV_MAX_M) return 0;
  const int G = K / n_groups;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(s);
  return (G == 64 || G % 128 == 0) && N % 16 == 0 && bases % 16 == 0 ? 2 : 1;
}

// the launch configuration of `grid` CTAs in clusters of WC (attr: its one
// attribute, kept by the caller)
template <int KC>
cudaLaunchConfig_t wgmma_config(int grid, cudaStream_t s, cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WgShape<KC>::SMEM;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KC, typename OutT>
int wgmma_launch(const bf16* x, const uint8_t* p, const float* scale, OutT* y, int M, int K,
                 int N, int n_groups, int grid, cudaStream_t s) {
  using Sh = WgShape<KC>;
  WgParams prm;
  memset(&prm, 0, sizeof(prm));
  prm.y = y;
  prm.M = M;
  prm.N = N;
  prm.G = K / n_groups;
  prm.nchunks = K / KC;
  prm.cpg = prm.G / KC;
  prm.mt = (M + WT - 1) / WT;
  const long long groups = (long long)prm.mt * (((N + WT - 1) / WT + WC - 1) / WC);
  if (groups > 0x7FFFFFFFLL || grid < WC || grid % WC != 0 || grid > WC * groups)
    return (int)cudaErrorInvalidValue;
  prm.groups = (int)groups;
  int err = encode_2d(&prm.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, WT / WC,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_2d(&prm.pmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, N, K / 2, N, WT, KC / 2,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_2d(&prm.smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, n_groups, 4LL * N, WT,
                    1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  void* kernel = reinterpret_cast<void*>(int4_mm_wgmma_kernel<KC, OutT>);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wgmma_config<KC>(grid, s, attr);
  void* args[] = {&prm};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The wgmma form's CTAs resident on the current card at once, in clusters
template <int KC, typename OutT>
int wgmma_resident(int* ctas) {
  void* kernel = reinterpret_cast<void*>(int4_mm_wgmma_kernel<KC, OutT>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       WgShape<KC>::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wgmma_config<KC>(WC, nullptr, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *ctas = WC * clusters;
  return (int)e;
}

template <typename OutT>
int launch(const bf16* x, const uint8_t* p, const float* scale, OutT* y, float* ws,
           int* counters, int M, int K, int N, int n_groups, int grid, cudaStream_t s) {
  const int G = K / n_groups;
  const int form = form_of(M, K, N, n_groups, x, p, scale);
  if (form == 0) {
    const long long units = (long long)((N + GV_TN - 1) / GV_TN) * n_groups;
    if (grid < 1 || grid > units || ws == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    GemvArgs a{x, p, scale, ws, counters, M, K, N, n_groups, G / 2, 0,
               (int)(units / grid), (int)(units % grid), gv_divisor(n_groups),
               gv_divisor(G / 2),
               N % 16 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0,
               N % 4 == 0 && (reinterpret_cast<uintptr_t>(scale) & 15) == 0};
    if (M == 1) return gemv_launch<1, OutT>(a, y, grid, s);
    if (M == 2) return gemv_launch<2, OutT>(a, y, grid, s);
    return gemv_launch<4, OutT>(a, y, grid, s);
  }
  if (form == 2)
    return G == 64 ? wgmma_launch<64, OutT>(x, p, scale, y, M, K, N, n_groups, grid, s)
                   : wgmma_launch<128, OutT>(x, p, scale, y, M, K, N, n_groups, grid, s);
  const bool vecx = K % 8 == 0 && (G / 2) % 8 == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vecw = N % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0;
  const dim3 grid2((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid2.y > 65535) return (int)cudaErrorInvalidValue;
  int4_mm_kernel<OutT><<<grid2, THREADS, 0, s>>>(x, p, scale, y, M, K, N, n_groups, vecx, vecw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16 (y). x (M, K) bf16, packed (K/2, N)
// uint8, scale (n_groups, N) f32 and y (M, N) are contiguous row-major; K is
// even and a multiple of n_groups with an even group size. For M <= 4, `grid`
// CTAs (1 .. ceil(N / 256) · n_groups) share the (tile, group) units; ws
// holds grid · 2 · MT · 256 f32 (MT = 1, 2, 4 for M = 1, 2, 3-4) and counters
// ceil(N / 256) int32 zeros (left zero). In the wgmma form (int4_matmul_form
// 2), `grid` persistent CTAs in clusters of int4_wgmma_cluster() (a multiple
// of it, up to it times the groups of that many adjacent 128 x 128 tiles)
// walk the tile groups; the mma.sync form ignores it. Returns the cudaError_t of the launch (0 =
// launched), or 1000 + the CUresult of a failed TMA map encoding.
int int4_matmul_launch(int out_dtype, const void* x, const void* packed,
                       const void* scale, void* y, int M, int K, int N,
                       int n_groups, int grid, void* ws, void* counters,
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
    return launch(xb, p, sc, static_cast<bf16*>(y), w, cnt, M, K, N, n_groups, grid, s);
  if (out_dtype == 0)
    return launch(xb, p, sc, static_cast<float*>(y), w, cnt, M, K, N, n_groups, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The form int4_matmul_launch takes for these operands: 0 the GEMV (M <= 4),
// 1 the mma.sync form, 2 the wgmma form (the rule is form_of's).
int int4_matmul_form(int M, int K, int N, int n_groups, const void* x, const void* packed,
                     const void* scale) {
  if (M <= 0 || K <= 0 || N <= 0 || n_groups <= 0 || K % n_groups != 0) return -1;
  return form_of(M, K, N, n_groups, x, packed, scale);
}

// The wgmma form's CTAs (in clusters of WC) resident on the current card at
// once for groups of `group_rows` rows and out_dtype as above; -1 on an
// error. The wrapper's grid is a multiple of WC up to this count.
int int4_wgmma_resident_ctas(int out_dtype, int group_rows) {
  int ctas = 0, err;
  const bool kc64 = group_rows == 64;
  if (out_dtype == 1)
    err = kc64 ? wgmma_resident<64, bf16>(&ctas) : wgmma_resident<128, bf16>(&ctas);
  else if (out_dtype == 0)
    err = kc64 ? wgmma_resident<64, float>(&ctas) : wgmma_resident<128, float>(&ctas);
  else
    return -1;
  return err == 0 && ctas >= WC ? ctas : -1;
}

// CTAs per cluster of the wgmma form
int int4_wgmma_cluster() { return WC; }

// The GEMV form's CTAs resident on the current card at once (the occupancy
// calls) for x of `m` rows and out_dtype as above; -1 on an error.
int int4_gemv_resident_ctas(int out_dtype, int m) {
  int ctas = 0, err;
  if (m <= 0 || m > GV_MAX_M || out_dtype < 0 || out_dtype > 1) return -1;
  if (out_dtype == 1)
    err = m == 1 ? gemv_resident<1, bf16>(&ctas)
                 : m == 2 ? gemv_resident<2, bf16>(&ctas) : gemv_resident<4, bf16>(&ctas);
  else
    err = m == 1 ? gemv_resident<1, float>(&ctas)
                 : m == 2 ? gemv_resident<2, float>(&ctas) : gemv_resident<4, float>(&ctas);
  return err == 0 ? ctas : -1;
}

}  // extern "C"
