// Weight-only int8 matrix product for Hopper (sm_90a):
//
//   y[M, N] = cast_T( sum_k x[M, k] * q[k, N]  (f32 accumulation) * scale[N] )
//
// x is bf16 or f32 (T), q int8, scale f32, y in x's type. Replaces the
// Pallas TPU kernel `_mm_kernel` of int8_matmul in
// multimodal_embeddings_tpu/kernels/quantization.py, which converts each
// int8 weight tile to bf16 in VMEM, feeds the MXU with an f32 accumulator
// and multiplies the f32 per-column scale in at the last K step. The same
// contract here: the weight is read from device memory as int8 and becomes
// bf16 (exactly: |q| <= 127) only in registers or shared memory, so a bf16
// copy of W never exists in global memory.
//
// What bounds it on this card: at the text stack's M = 512 rows the product
// does 2*M*K*N flops on K*N weight bytes, about 1000 flops per weight byte,
// far above the H100's ~300 bf16 flops per HBM byte, so the tensor cores
// bound the work (the cross-attention k/v at M = 12808 even more so); but
// the bytes each SM takes in from L2 come first in practice: x is read again
// for every column tile and W for every row tile, and the loads alone take
// ~72% of the wgmma form's time at gate,up (scripts/torch_k2_probe.py).
//
// Three forms (form_of; kernels/quantization.py::int8_mm_form mirrors it):
//
// * bf16 x with M > 4 where TMA can describe every operand (K % 8 == 0,
//   N % 16 == 0, x, q and scale on 16-byte boundaries; all five mmE5-11B text
//   shapes): the wgmma form, int8_mm_wgmma_kernel. Persistent CTAs of 384
//   threads in clusters of two over output tiles of TM rows of x (128 or
//   256: a 256-row tile serves each weight chunk to twice the rows, for 17%
//   fewer bytes per product) x 128 columns. One thread keeps a TMA ring of
//   chunks of KC weight rows: x's TM x KC bf16 (each CTA of the pair loads
//   half the rows, multicast into both) and the KC x 128 int8 weight bytes.
//   The product is taken transposed, y^T = q^T x^T, so the weight is wgmma's
//   register operand and never goes back to shared memory: each of two
//   consumer warpgroups turns its 64 columns' bytes into A fragments
//   (ldmatrix.trans; per two weights two LOP3 and one bf16x2 FMA, no
//   int-to-float conversion, q_bf16x2), the next chunk's while this chunk's
//   wgmma m64nTMk16 run against x as the K-major B. The work is (tile pair,
//   chunk) units cut into contiguous shares that differ by at most one unit
//   over the resident clusters (stream-K; per M tile where the M tiles are
//   few, so the clusters working on one weight chunk do so together), so a
//   tile may be cut across CTAs: each writes its f32 partial to a workspace
//   and the last to arrive sums them in a fixed order in the same launch (no
//   float atomics: two calls give the same bits). The scale is applied once
//   per tile. kernels/quantization.py::int8_wgmma_plan picks TM, the
//   sequences and the grid.
// * bf16 x otherwise (ragged K or N, a misaligned base, M <= 4): the
//   mma.sync form, int8_mm_bf16_kernel: 128x128 output tiles of 8 warps
//   (each 64x32), mma.sync m16n8k16, K steps of 32, a two-stage
//   shared-memory ring filled from registers loaded one step ahead (the
//   weight converted to bf16 there), fragments by ldmatrix.
// * f32 x, for checks only (the page program runs bf16): a CUDA-core tiled
//   loop, 64x64 tiles, 4x4 outputs per thread, exact int8 -> f32 weights.
//
// Ragged M, K and N: TMA reads rows and columns past the edge as zero in the
// wgmma form, whose stores are masked; the other two zero-fill their tiles'
// edges, with 16-byte vector loads where the launcher finds the rows
// aligned (K % 8 == 0 and N % 16 == 0, 16-byte base addresses) and element
// loads elsewhere.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

// --------------------------------------------------------------------------
// bf16 x, the mma.sync form
// --------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;      // 8 warps: 2 along M (64 rows) x 4 along N (32 cols)
constexpr int A_LD = BK + 8;      // bf16 per shared x row: 80 B, 8 ldmatrix rows on distinct banks
constexpr int B_LD = BN + 8;      // bf16 per shared W row: 272 B, likewise

struct Stage {
  __nv_bfloat16 a[BM * A_LD];  // x tile, [m][k]
  __nv_bfloat16 b[BK * B_LD];  // W tile as bf16, [k][n]
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

// One tile's global loads, held in registers until the ring slot is free:
// two 8-element x chunks and one 16-byte int8 W chunk per thread.
struct Fetch {
  uint4 x[2];
  uint4 w;
};

__device__ __forceinline__ void fetch(Fetch& f, const __nv_bfloat16* __restrict__ x,
                                      const int8_t* __restrict__ q, int M, int K,
                                      int N, int m0, int n0, int k0, bool vec,
                                      int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;  // 512 chunks: 128 rows x 4
    const int row = c >> 2, gm = m0 + row, gk = k0 + (c & 3) * 8;
    if (vec && gm < M && gk + 8 <= K) {
      f.x[i] = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (gm < M && gk + j < K)
                   ? __bfloat16_as_ushort(x[(size_t)gm * K + gk + j])
                   : (uint16_t)0;
      f.x[i] = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                          e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
  }
  const int row = tid >> 3, gk = k0 + row, gn = n0 + (tid & 7) * 16;  // 32 rows x 8
  if (vec && gk < K && gn + 16 <= N) {
    f.w = *reinterpret_cast<const uint4*>(q + (size_t)gk * N + gn);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (gk < K && gn + j < N)
        w[j >> 2] |= (uint32_t)(uint8_t)q[(size_t)gk * N + gn + j] << (8 * (j & 3));
    f.w = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(uint32_t word, int byte) {
  const float lo = (float)(int8_t)(word >> (8 * byte));
  const float hi = (float)(int8_t)(word >> (8 * byte + 8));
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // exact for int8
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void stage_store(Stage& s, const Fetch& f, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    *reinterpret_cast<uint4*>(&s.a[(c >> 2) * A_LD + (c & 3) * 8]) = f.x[i];
  }
  const uint32_t w[4] = {f.w.x, f.w.y, f.w.z, f.w.w};
  uint32_t o[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = pack_bf16(w[j], 0);
    o[2 * j + 1] = pack_bf16(w[j], 2);
  }
  uint4* dst = reinterpret_cast<uint4*>(&s.b[(tid >> 3) * B_LD + (tid & 7) * 16]);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(THREADS)
    int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N,
                        bool vec) {
  __shared__ __align__(16) Stage ring[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int steps = (K + BK - 1) / BK;
  Fetch f;
  fetch(f, x, q, M, K, N, m0, n0, 0, vec, tid);
  stage_store(ring[0], f, tid);
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) fetch(f, x, q, M, K, N, m0, n0, (t + 1) * BK, vec, tid);
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
    if (t + 1 < steps) stage_store(ring[(t + 1) & 1], f, tid);
    __syncthreads();
  }

  // epilogue: accumulator (row g or g + 8, columns 2*(lane % 4) + {0, 1})
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + c2;
    const float s0 = n < N ? scale[n] : 0.f;
    const float s1 = n + 1 < N ? scale[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + g + h * 8;
        if (m >= M) continue;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[i][j][2 * h] * s0);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[i][j][2 * h + 1] * s1);
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
// f32 x, CUDA cores (checks only)
// --------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(256)
    int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ y,
                       int M, int K, int N) {
  __shared__ __align__(16) float sa[FK][FM];  // x tile, transposed
  __shared__ __align__(16) float sb[FK][FN];  // W tile as f32
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      const int r = e >> 4, kc = e & 15;  // x: 64 rows x 16
      const int gm = m0 + r, gk = k0 + kc;
      sa[kc][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
      const int kr = e >> 6, nc = e & 63;  // W: 16 rows x 64
      const int wk = k0 + kr, wn = n0 + nc;
      sb[kr][nc] = (wk < K && wn < N) ? (float)q[(size_t)wk * N + wn] : 0.f;
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
      if (m < M && n < N) y[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
  }
}

// --------------------------------------------------------------------------
// bf16 x where TMA can describe the operands: warp-specialised wgmma
// --------------------------------------------------------------------------

constexpr int WG_THREADS = 384;  // WG0 loads (one thread), WG1-2 convert and multiply
constexpr int WN = 128;          // output tile columns (of W)
constexpr int WC = 2;            // CTAs per cluster: adjacent N tiles sharing each x tile
constexpr int SMEM_LIMIT = 232448;

// The shape of the form with TM rows of x per tile (128 or 256): a chunk is
// KC weight rows (128 at TM = 128, 64 at TM = 256, so a stage holds 48 or 40
// KB), a consumer thread keeps TM / 2 f32 accumulators.
template <int TM>
struct WgShape {
  static constexpr int KC = TM == 128 ? 128 : 64;  // weight rows per chunk (one ring stage)
  static constexpr int KS = KC / 16;               // wgmma k-steps per chunk
  static constexpr int ACC = TM / 2;               // accumulators per consumer thread
  static constexpr int X_BYTES = TM * KC * 2;      // x: KC / 64 atoms of TM rows x 128 B
  static constexpr int W_BYTES = KC * WN;          // the weight: KC rows x 128 B
  static constexpr int STAGE = X_BYTES + W_BYTES;
  // the 1,024 bytes in front align the base for the swizzle; 16 bytes of
  // barriers per stage
  static constexpr int fit(int s) { return 1024 + s * STAGE + 16 * s; }
  static constexpr int stages() {
    int s = 8;
    while (fit(s) > SMEM_LIMIT) --s;
    return s;
  }
  static constexpr int STAGES = stages();  // 4 at TM = 128, 5 at TM = 256
  static constexpr int SMEM = fit(STAGES);
  // a CTA's f32 partial of one tile, per consumer warpgroup: ACC floats per
  // thread, laid out as ACC / 4 float4 by 128 threads
  static constexpr int PART_F4 = ACC / 4 * 128;
};
static_assert(WgShape<128>::STAGES >= 3 && WgShape<256>::STAGES >= 3, "the wgmma form's ring");

// x / d for 0 <= x < 2^31 by a multiply and a shift: an integer division
// would compute its reciprocal through an int-to-float conversion (I2F);
// `divisor` finds mul and shr on the host.
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

// One launch: the TMA maps of x (boxes of 64 columns x TM / WC rows,
// 128-byte swizzle: each CTA of a cluster loads its half of the tile's rows
// for both) and q (128 bytes x KC rows, 128-byte swizzle); the scale, the
// output, the stream-K workspace and arrival counters; the shape. A group is
// WC adjacent N tiles of one M tile, numbered M-fastest (grp = gn * mt + mi).
// The groups are dealt into `seqs` sequences (group grp to sequence grp %
// seqs; seqs is 1 or mt, so a sequence is all groups, or one M tile's), the
// clusters likewise (cluster c to sequence c % seqs, as its set c / seqs),
// and each sequence's units (group, chunk), group-major, are cut over its
// sets: set j takes [start(j), start(j + 1)) of them.
struct WgParams {
  CUtensorMap xmap, wmap;
  const float* scale;
  bf16* y;
  float* ws;
  int* counters;
  int M, N, nchunks, mt, seqs, base, rem;
  Div by_chunks, by_mt, by_seqs;
  __device__ __forceinline__ int start(int j) const { return j * base + min(j, rem); }
};

// A position in a share: the sequence's unit u is chunk c of group grp, the
// group's M tile mi and pair of N tiles gn
struct WgPos {
  int grp, c, mi, gn;
  __device__ __forceinline__ WgPos(const WgParams& p, int seq, int u) {
    const int local = p.by_chunks.div(u);
    c = u - local * p.nchunks;
    grp = local * p.seqs + seq;
    gn = p.by_mt.div(grp);
    mi = grp - gn * p.mt;
  }
  __device__ __forceinline__ void next(const WgParams& p) {
    if (++c == p.nchunks) {
      c = 0;
      grp += p.seqs;
      mi += p.seqs;
      while (mi >= p.mt) mi -= p.mt, ++gn;
    }
  }
};

__device__ __forceinline__ int ctaid_x() {  // read anew: not kept live in a register
  int r;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(r));
  return r;
}

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

// the 128 threads of one consumer warpgroup (named barrier 1 or 2)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int KS>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[KS][4]) {
#pragma unroll
  for (int i = 0; i < KS; ++i)
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

// d (64 x 256, f32) = [d +] A (registers) . B (smem, K-major), k = 16
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the product of one k-step for TM rows of x
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n128(d, a, b, accumulate);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  wgmma_rs_n256(d, a, b, accumulate);
}

// Bytes 0 and 2 of t, two int8 weights, as a bf16x2 pair with no int-to-float
// conversion: an int8 q is m - 128 s (m its low 7 bits, s its sign bit).
// One LOP3 puts m under 0x4300, the bf16 bits of 128 + m; another puts s in
// the lowest exponent bit of 0xC300 (-128), making it -256 where s is set;
// their sum, one bf16x2 FMA, is q exactly. (The bf16 0x4300 | n trick of K3
// does not take 8 bits: 128 + u for u up to 255 needs 9 significant bits.)
__device__ __forceinline__ uint32_t q_bf16x2(uint32_t t) {
  uint32_t m, s, r;  // (t & mask) | constant as one LOP3: the second constant in a register
  asm("lop3.b32 %0, %1, 0x007F007F, %2, 0xEA;\n" : "=r"(m) : "r"(t), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, 0x00800080, %2, 0xEA;\n" : "=r"(s) : "r"(t), "r"(0xC300C300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(s));
  return r;
}

// The A fragments of one chunk's KS k-steps for this thread's columns n,
// n + 1 (rows lane / 4 and lane / 4 + 8 of its warp's 16), from the weight
// tile at `wt`. One ldmatrix.trans of four 8 x 8 matrices of 16-bit pairs
// (8 weight rows x the warp's 16 byte columns each, row addresses `lane_off`
// with the 128-byte swizzle) gives the thread, per matrix, columns n, n + 1
// of rows 2c and 2c + 1 (c = lane % 4) in one word: bytes n@2c, (n+1)@2c,
// n@2c+1, (n+1)@2c+1. So a word v makes column n's pair from bytes 0 and 2,
// q_bf16x2(v), and column n + 1's from v >> 8: seven instructions per four
// weights.
template <int KS>
__device__ __forceinline__ void convert_chunk(uint32_t (&a)[KS][4], uint32_t wt,
                                              uint32_t lane_off) {
#pragma unroll
  for (int h = 0; h < KS / 2; ++h) {  // k-steps 2h, 2h + 1: weight rows 32h ..
    uint32_t r[4];
    ldsm_x4_trans(r, wt + 32 * h * 128 + lane_off);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * h + q;
      const uint32_t v0 = r[2 * q], v1 = r[2 * q + 1];  // rows 16j + 2c, +1 and 16j + 8 + 2c, +1
      a[j][0] = q_bf16x2(v0), a[j][1] = q_bf16x2(v0 >> 8);
      a[j][2] = q_bf16x2(v1), a[j][3] = q_bf16x2(v1 >> 8);
    }
  }
}

// The product is taken transposed, y^T = q^T x^T, so the converted weight is
// wgmma's register operand A: consumer warpgroup g takes the tile's columns
// [64g, 64g + 64) as A's 64 rows and x's 128 rows (K-major, as TMA wrote
// them) as B. A row r of warp w stands for column 16w + 2(r % 8) + (r % 16) /
// 8 of the warpgroup's 64, so a thread's two A rows (lane / 4 and lane / 4 +
// 8) are two adjacent columns n, n + 1, which ldmatrix hands it together
// (convert_chunk), and it stores its outputs (row m, columns n, n + 1) as
// pairs.
//
// Clusters of WC CTAs walk groups of WC adjacent N tiles of one M tile, in
// M-fastest order: each CTA loads its TM / WC rows of the x tile by a TMA
// multicast into all, so x is read from L2 once per cluster, and a stage is
// refilled only when the consumers of every CTA have released it (its empty
// barrier counts them all). The work is the units (group, chunk), and each
// set of clusters takes a contiguous share of its sequence's (WgParams):
// equal shares (to one unit) over every resident cluster, so N = 1024 fills
// the card and no wave is left partial. Where the M tiles are few, a
// sequence is one M tile's groups, so the mt clusters of a set walk the same
// weight chunks at the same time, one M tile each, and the weights are read
// from HBM once; else the clusters resident together share them through the
// M-fastest order. A share's run of chunks in one group is a segment; its first product starts from zero (scale-d = 0). A segment that
// is the whole group is scaled and stored; one that is not leaves each
// warpgroup's f32 partial in ws (slot 0 where the share starts in the group,
// else 1) and the last of the group's clusters to arrive (acq_rel counter
// per tile and warpgroup, reset after use) sums the partials in cluster
// order, which is k order, then scales and stores: the bits do not depend on
// timing. Both roles keep one count of chunks across the CTA's share, which
// sets the ring slot and barrier parity of each. A consumer issues chunk u's
// products, converts chunk u + 1 into its second set of A registers while
// they run, waits for them and releases the stage.
template <int TM>
__global__ void __launch_bounds__(WG_THREADS, 1)
    int8_mm_wgmma_kernel(const __grid_constant__ WgParams p) {
  using Sh = WgShape<TM>;
  constexpr int KC = Sh::KC, KS = Sh::KS, STAGES = Sh::STAGES, STAGE = Sh::STAGE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ int last_arrival[2];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto x_tile = [&](int s) { return base + s * STAGE; };
  auto w_tile = [&](int s) { return base + s * STAGE + Sh::X_BYTES; };
  auto full_bar = [&](int s) { return bars + 8 * s; };              // x, q landed
  auto empty_bar = [&](int s) { return bars + 8 * (STAGES + s); };  // consumers done with them

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full_bar(s), 1);
      bar_init(empty_bar(s), 8 * WC);  // every consumer warp of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // no CTA signals or writes into another before its barriers exist

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int rank = (int)cluster_rank(), cl = blockIdx.x / WC;
  const int set = p.by_seqs.div(cl), seq = cl - set * p.seqs;
  const int u0 = p.start(set), u1 = p.start(set + 1);
  if (wg == 0) {
    // ---------------- loads: one thread issues every TMA copy ----------------
    regs_dec<40>();
    if (tid == 0) {
      int s = 0, ph = 0;
      WgPos at(p, seq, u0);
      for (int u = u0; u < u1; ++u, at.next(p)) {
        const int m0 = at.mi * TM + rank * (TM / WC), n0 = (WC * at.gn + rank) * WN;  // m0: our rows
        bar_wait(empty_bar(s), ph ^ 1);
        const uint32_t full = full_bar(s), xr = x_tile(s) + rank * (TM / WC) * 128;
        bar_arrive_tx(full, STAGE);
#pragma unroll
        for (int a = 0; a < KC / 64; ++a)
          tma_load_2d_all(xr + a * TM * 128, &p.xmap, full, at.c * KC + 64 * a, m0);
        tma_load_2d(w_tile(s), &p.wmap, full, n0, at.c * KC);
        if (++s == STAGES) s = 0, ph ^= 1;
      }
    }
    cluster_sync();  // no CTA exits while another may still write into it
    return;
  }

  // ---------------- consumers: 64 columns of the tile each ----------------
  regs_inc<232>();
  const int g = wg - 1, warp = tid / 32, lane = tid % 32, c4 = lane & 3;
  const int ncol = 64 * g + 16 * warp + 2 * (lane >> 2);  // this thread's columns n, n + 1
  // the row this lane addresses for ldmatrix: weight row lane (+ 32h), the
  // warp's 16-byte column chunk XOR row % 8 (the 128-byte swizzle)
  const uint32_t lane_off =
      (uint32_t)lane * 128 + (((uint32_t)(ncol >> 4) ^ (uint32_t)(lane & 7)) << 4);
  float4* const ws4 = reinterpret_cast<float4*>(p.ws);
  float acc[Sh::ACC];
  uint32_t a0[KS][4], a1[KS][4];  // A of this chunk and of the next, converted under this one's products
  int s = 0, ph = 0, u = u0;
  WgPos at(p, seq, u0);
  bool seg_start = true;

  // the end of a segment of group grp: store, or leave the partial and, as
  // the group's last cluster to arrive, sum the partials and store
  auto finish = [&]() {
    const int grp = at.grp, tile_n = WC * at.gn + rank;
    if (tile_n * WN >= p.N) return;  // a tile past N: every cluster of the group skips it
    const int first = u - at.c;  // the group's first unit in the sequence
    // the share, anew from the block index (cold here: not kept in registers)
    const int set = p.by_seqs.div(ctaid_x() / WC);
    const int u0 = p.start(set);
    if (first < u0 || first + p.nchunks > u1) {
      const int slot = u0 >= first ? 0 : 1;
      const size_t mine = ((size_t)(blockIdx.x * 2 + slot) * 2 + g) * Sh::PART_F4 + tid;
#pragma unroll
      for (int i = 0; i < Sh::ACC / 4; ++i)
        __stcg(ws4 + mine + i * 128,
               make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]));
      int c_first = set, c_last = set;  // the sets whose shares meet the group
      while (p.start(c_first) > first) --c_first;
      while (p.start(c_last + 1) < first + p.nchunks) ++c_last;
      // every thread's partial before thread 0's release; its acquire
      // before the partials' reads
      __threadfence();
      wg_sync(1 + g);
      int* const counter = p.counters + (grp * WC + rank) * 2 + g;
      if (tid == 0) {
        int arrived;
        asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
                     : "=r"(arrived) : "l"(counter) : "memory");
        last_arrival[g] = arrived == c_last - c_first;
      }
      wg_sync(1 + g);
      if (!last_arrival[g]) return;
      const int slot0 = p.start(c_first) >= first ? 0 : 1;
      // set j's CTA of this rank: (j * seqs + seq) * WC + rank
      const int seq = grp - p.by_seqs.div(grp) * p.seqs;
      const size_t at0 =
          ((size_t)(((c_first * p.seqs + seq) * WC + rank) * 2 + slot0) * 2 + g) * Sh::PART_F4 +
          tid;
#pragma unroll
      for (int i = 0; i < Sh::ACC / 4; ++i) {
        const float4 v = __ldcg(ws4 + at0 + i * 128);
        acc[4 * i] = v.x, acc[4 * i + 1] = v.y, acc[4 * i + 2] = v.z, acc[4 * i + 3] = v.w;
      }
      for (int c2 = c_first + 1; c2 <= c_last; ++c2) {  // shares starting in the group
        const size_t off =
            ((size_t)(((c2 * p.seqs + seq) * WC + rank) * 2) * 2 + g) * Sh::PART_F4 + tid;
        // eight loads in flight at a time: all of them would need ACC more
        // registers
#pragma unroll
        for (int i0 = 0; i0 < Sh::ACC / 4; i0 += 8) {
#pragma unroll
          for (int i = i0; i < i0 + 8; ++i) {
            const float4 v = __ldcg(ws4 + off + i * 128);
            acc[4 * i] += v.x, acc[4 * i + 1] += v.y, acc[4 * i + 2] += v.z,
                acc[4 * i + 3] += v.w;
          }
          asm volatile("" ::: "memory");
        }
      }
      if (tid == 0) *counter = 0;
    }
    // y[m, n], y[m, n + 1] for m = 8i + 2c4 + {0, 1}; N % 16 == 0, so the
    // pair is inside N or outside it whole
    const int n = tile_n * WN + ncol;
    if (n < p.N) {
      const float2 sc = __ldg(reinterpret_cast<const float2*>(p.scale + n));
      bf16* y = p.y + n;
#pragma unroll
      for (int i = 0; i < TM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = at.mi * TM + 8 * i + 2 * c4 + e;
          if (m < p.M)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * p.N) =
                __floats2bfloat162_rn(acc[4 * i + e] * sc.x, acc[4 * i + 2 + e] * sc.y);
        }
    }
  };

  // One chunk: its products from `cur`, the next chunk's A into `nxt` while
  // they run, then a segment's end. False after the share's last chunk.
  auto chunk = [&](uint32_t(&cur)[KS][4], uint32_t(&nxt)[KS][4]) -> bool {
    fence_regs(cur);
    wgmma_fence();
    // B: x's TM rows, k-step j in atom j / 4 at byte 32 (j % 4)
    const uint64_t xd = desc128(x_tile(s));
#pragma unroll
    for (int j = 0; j < KS; ++j)
      wgmma_rs(acc, cur[j], xd + (((j >> 2) * TM * 128 + (j & 3) * 32) >> 4),
               !seg_start || j > 0);
    wgmma_commit();
    const int done = s;
    const bool more = u + 1 < u1;
    if (++s == STAGES) s = 0, ph ^= 1;
    if (more) {
      bar_wait(full_bar(s), ph);
      convert_chunk(nxt, w_tile(s), lane_off);
    }
    wgmma_wait0();
    fence_regs(acc);
    fence_regs(cur);
    __syncwarp();
    if (lane == 0)  // the stage is free in every CTA of the cluster
      for (int r = 0; r < WC; ++r) bar_arrive_remote(empty_bar(done), r);
    seg_start = at.c + 1 == p.nchunks || !more;
    if (seg_start) finish();
    ++u;
    at.next(p);
    return more;
  };
  if (u0 < u1) {
    bar_wait(full_bar(0), 0);
    convert_chunk(a0, w_tile(0), lane_off);
    while (chunk(a0, a1) && chunk(a1, a0)) {
    }
  }
  cluster_sync();
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
// boxes of box_cols x box_rows at the 128-byte swizzle; rows and columns past
// the edge read as zero. Returns 0, or 1000 + the CUresult.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long cols,
              long long rows, long long row_bytes, int box_cols, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return 1999;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// The form a launch takes (kernels/quantization.py::int8_mm_form mirrors
// it): 0 the f32 form for f32 x; 2 the wgmma form for bf16 x with M > 4
// where TMA can describe every operand: K % 8 == 0 (x's row stride a
// multiple of 16 bytes), N % 16 == 0 (q's), x, q and scale on 16-byte
// boundaries; 1 the mma.sync form for every other bf16 shape. M > 4: at four
// rows or fewer a 128-row tile is nearly all zero fill, the same in either
// tensor-core form; those shapes are left to the simpler one.
int form_of(int dtype, int M, int K, int N, const void* x, const void* q, const void* s) {
  if (dtype == 0) return 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(s);
  return M > 4 && K % 8 == 0 && N % 16 == 0 && bases % 16 == 0 ? 2 : 1;
}

// the kernel of TM rows with its shared-memory limit raised on the current
// device (once per device)
template <int TM>
void* wgmma_kernel(cudaError_t* err) {
  void* kernel = reinterpret_cast<void*>(int8_mm_wgmma_kernel<TM>);
  static bool raised[64] = {};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess && (dev < 0 || dev >= 64 || !raised[dev])) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                WgShape<TM>::SMEM);
    if (*err == cudaSuccess && dev >= 0 && dev < 64) raised[dev] = true;
  }
  return kernel;
}

// the launch configuration of `grid` CTAs in clusters of WC (attr: its one
// attribute, kept by the caller)
template <int TM>
cudaLaunchConfig_t wgmma_config(int grid, cudaStream_t s, cudaLaunchAttribute (&attr)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WgShape<TM>::SMEM;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int TM>
int wgmma_launch(const bf16* x, const int8_t* q, const float* scale, bf16* y, float* ws,
                 int* counters, int M, int K, int N, int grid, int seqs, cudaStream_t s) {
  constexpr int KC = WgShape<TM>::KC;
  WgParams prm;
  memset(&prm, 0, sizeof(prm));
  prm.scale = scale;
  prm.y = y;
  prm.ws = ws;
  prm.counters = counters;
  prm.M = M;
  prm.N = N;
  prm.nchunks = (K + KC - 1) / KC;
  prm.mt = (M + TM - 1) / TM;
  const long long groups = (long long)prm.mt * (((N + WN - 1) / WN + WC - 1) / WC);
  const long long units = groups * prm.nchunks;
  const int clusters = grid / WC;
  if (units > 0x7FFFFFFFLL || grid < WC || grid % WC != 0 || ws == nullptr ||
      counters == nullptr || (seqs != 1 && seqs != prm.mt) || clusters % seqs != 0)
    return (int)cudaErrorInvalidValue;
  const long long seq_units = units / seqs;
  const int sets = clusters / seqs;
  if (sets > seq_units) return (int)cudaErrorInvalidValue;
  prm.seqs = seqs;
  prm.base = (int)(seq_units / sets);
  prm.rem = (int)(seq_units % sets);
  prm.by_chunks = divisor(prm.nchunks);
  prm.by_mt = divisor(prm.mt);
  prm.by_seqs = divisor(seqs);
  int err = encode_2d(&prm.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64, TM / WC);
  if (err == 0)
    err = encode_2d(&prm.wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, WN, KC);
  if (err) return err;
  cudaError_t e;
  void* kernel = wgmma_kernel<TM>(&e);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wgmma_config<TM>(grid, s, attr);
  void* args[] = {&prm};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). x (M, K), q (K, N) int8 and
// y (M, N) are contiguous row-major; scale has N f32 values. The mma.sync
// and f32 forms take 16-byte loads where K % 8, N % 16 and the bases of x
// and q allow them. In the wgmma form (int8_matmul_form 2), `grid`
// persistent CTAs in clusters of int8_wgmma_config(tile_m, 3) share the units
// of tiles of tile_m (128 or 256) rows, in `seqs` sequences (1, or the M
// tiles; WgParams): grid / cluster a multiple of seqs, and at most seqs times
// a sequence's units; ws holds grid x 2 x 2 x 128 x tile_m / 2 f32 and
// counters 2 x the tiles int32 zeros (left zero); the other forms ignore
// them. Returns the cudaError_t of the launch
// (0 = launched), or 1000 + the CUresult of a failed TMA map encoding.
int int8_matmul_launch(int dtype, const void* x, const void* q, const void* scale, void* y,
                       int M, int K, int N, int grid, int tile_m, int seqs, void* ws,
                       void* counters, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int form = form_of(dtype, M, K, N, x, q, scale);
  const bool vec = K % 8 == 0 && N % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15) == 0;
  if (dtype == 1 && form == 2) {
    const bf16* xb = static_cast<const bf16*>(x);
    const int8_t* qb = static_cast<const int8_t*>(q);
    const float* sc = static_cast<const float*>(scale);
    bf16* yb = static_cast<bf16*>(y);
    float* w = static_cast<float*>(ws);
    int* cnt = static_cast<int*>(counters);
    if (tile_m == 128) return wgmma_launch<128>(xb, qb, sc, yb, w, cnt, M, K, N, grid, seqs, s);
    if (tile_m == 256) return wgmma_launch<256>(xb, qb, sc, yb, w, cnt, M, K, N, grid, seqs, s);
    return (int)cudaErrorInvalidValue;
  } else if (dtype == 1) {
    const dim3 grid2((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid2.y > 65535) return (int)cudaErrorInvalidValue;
    int8_mm_bf16_kernel<<<grid2, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, K,
        N, vec);
  } else if (dtype == 0) {
    const dim3 grid2((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid2.y > 65535) return (int)cudaErrorInvalidValue;
    int8_mm_f32_kernel<<<grid2, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(y), M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The form int8_matmul_launch takes for these operands: 0 the f32 form, 1
// the mma.sync form, 2 the wgmma form (the rule is form_of's); -1 for a
// shape or type it refuses.
int int8_matmul_form(int dtype, int M, int K, int N, const void* x, const void* q,
                     const void* scale) {
  if (M <= 0 || K <= 0 || N <= 0 || dtype < 0 || dtype > 1) return -1;
  return form_of(dtype, M, K, N, x, q, scale);
}

// The wgmma form's CTAs (in clusters of WC) resident on the current card at
// once for tiles of tile_m rows; -1 on an error. The wrapper's grid is a
// multiple of WC up to this.
int int8_wgmma_resident_ctas(int tile_m) {
  if (tile_m != 128 && tile_m != 256) return -1;
  cudaError_t e;
  void* kernel = tile_m == 128 ? wgmma_kernel<128>(&e) : wgmma_kernel<256>(&e);
  if (e != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      tile_m == 128 ? wgmma_config<128>(WC, nullptr, attr) : wgmma_config<256>(WC, nullptr, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess && clusters > 0 ? WC * clusters : -1;
}

// The wgmma form's constants for tiles of tile_m rows, which
// kernels/quantization.py's plan mirrors: 0 the tile's rows of x, 1 its
// columns of W, 2 the chunk's weight rows, 3 the CTAs per cluster, 4 the
// ring's stages; -1 otherwise.
int int8_wgmma_config(int tile_m, int what) {
  if (tile_m != 128 && tile_m != 256) return -1;
  const int v[5] = {tile_m, WN, tile_m == 128 ? WgShape<128>::KC : WgShape<256>::KC, WC,
                    tile_m == 128 ? WgShape<128>::STAGES : WgShape<256>::STAGES};
  return what >= 0 && what < 5 ? v[what] : -1;
}

}  // extern "C"
