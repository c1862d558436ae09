// Flash attention (online softmax over key tiles) for Hopper (sm_90a):
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h] . k[b, j, h/rep] / sqrt(Dk)) v[b, j, h/rep]
//
// over the keys j < lengths[b] (and j <= i when causal), with GQA (query head
// h reads kv head h / (H / KVH)) and independent Dk and Dv. Replaces the
// Pallas TPU kernels `_flash_kernel` (flash_attention) and `_flash_kernel_v2`
// (flash_attention_v2) of multimodal_embeddings_tpu/kernels/flash_attention.py
// and keeps their numerics contract, tile for tile:
//
//   * scores = (q . k) accumulated in f32 from bf16 operands, then times
//     1/sqrt(Dk) in f32; masked keys get -1e30;
//   * keys are visited in tiles of 128 (the TPU kernel's block_k): per tile
//     m_new = max(m, tile max), corr = exp(m - m_new), p = exp(s - m_new),
//     sum = sum * corr + (sum of the UNROUNDED f32 p), acc = acc * corr +
//     bf16(p) . v accumulated in f32;
//   * out = acc / max(sum, 1e-30), cast to the input type.
//
// Tiles past a row's last valid key (lengths, or the causal diagonal) are
// skipped: their p is exactly 0 and their corr exactly 1.
//
// What bounds it on this card: at the Qwen vision shape (1, 4960, 16, 80)
// the two products are 4*L^2*D*H = 126 GFLOP against 51 MB of q/k/v/o, ~2500
// flops per byte, so the tensor cores bound it (0.127 ms at 989 TFLOP/s),
// not HBM. Only the warpgroup products (wgmma) reach that rate, so the bf16
// kernel is built around them and never writes the (L, L) scores anywhere:
//
//   * a CTA owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each and one loading warp (288 threads, so each
//     thread may hold 224 registers without setmaxnreg);
//   * the loading warp keeps a ring of 2-4 stages of 128-key K and V tiles
//     in shared memory, each stage guarded by a full and an empty mbarrier;
//     one thread issues TMA tile loads (cp.async.bulk.tensor) that zero-fill
//     rows past L and columns past the head dim. An operand whose base or
//     (batch, row, head) stride is not a multiple of 16 bytes cannot be
//     described to TMA: the warp copies it with cp.async (or plain loads,
//     2-byte aligned) into the same swizzled layout, so the consumers run
//     the same code (the plan, chosen in Python, says which);
//   * a consumer runs S = Q K^T as wgmma m64n128k16 (both operands in shared
//     memory), the online softmax on the S accumulators (exp on the MUFU
//     unit), and O += P V as wgmma m64nNk16 with P in registers (the S
//     accumulators' layout is the A fragment's) and V read transposed from
//     shared memory (N = Dv padded to 16). The two warpgroups take turns
//     issuing their products, so one's softmax runs under the other's
//     products;
//   * shared memory holds a head dim padded to 16 as column atoms, each one
//     TMA box: 64 columns with the 128-byte swizzle, and a remainder of 16
//     columns (32-byte swizzle), 32 (64-byte) or 48 (in a 64-column atom).
//     At Dk = Dv = 80 a K+V stage is 40 KB, so four stages fit.
//
// flash_attention launches one CTA per (128-row query tile, head, batch
// item), the heaviest causal tiles first. flash_attention_v2 is the TPU
// kernel's K/V-resident schedule: there one program per (batch, head) walks
// all its query blocks with the head's K and V in VMEM. One head's K/V at
// (2, 6432, 16, 80) is 2.06 MB, more than even an 8-CTA cluster's shared
// memory, so here "resident" becomes "read once per cluster": a cluster of C
// CTAs takes C adjacent query tiles of one (head, batch item) at a time, in
// lockstep, and each K/V tile is fetched once for the cluster by a TMA
// multicast into every member's ring (the members take turns issuing it); a
// stage's empty barrier waits for the consumers of all C members. Under
// causal masking the cluster walks to the furthest tile any member needs,
// and a member past its own last tile skips the products but still signals
// the barriers. The consumer code is v1's on the same tiles in the same
// order, so v2's outputs equal v1's bit for bit. The plan sets C and, where
// the (head, batch item) pairs are too few to fill the card, S clusters per
// pair, each walking every S-th group of C tiles: the fewest rounds of
// tiles for the clusters the card holds at once (at (2, 6432, 16, 80) C = 2,
// S = 2: 128 CTAs, each K/V tile read twice per head instead of 51 times).
//
// The f32 forms (checks only) run on CUDA cores: one thread per query row,
// 32-key tiles in shared memory, the same online-softmax recurrence with
// unrounded p (f32 needs no rounding step, so the tile width only changes the
// summation order).
//
// q, k and v are addressed through (batch, row, head) strides with a unit
// feature stride, so strided views (q/k/v sliced out of one fused projection)
// need no copy; o is contiguous (B, L, H, Dv).
//
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime: it is
// looked up at run time through the runtime's entry-point query, so the
// library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int BQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int BKV = 128;         // keys per tile (the TPU kernel's block_k)
constexpr int DMAX = 128;        // largest head dim
constexpr int THREADS = 288;     // warpgroups 0 and 1 compute, warp 8 loads
constexpr int LOADERS = 32;      // threads of the loading warp
constexpr int MAX_STAGES = 4;
constexpr int BARRIER_BYTES = 8 * (2 * MAX_STAGES + 2);
constexpr int MAX_CLUSTER = 8;
constexpr float NEG_INF = -1e30f;

typedef __nv_bfloat16 bf16;

// A head dim padded to P (a multiple of 16) in shared memory: P / 64 atoms
// of 64 columns, then one atom for the remainder (16, 32 or 64 columns).
__host__ __device__ constexpr int rem_cols(int p) {
  return p % 64 == 0 ? 0 : (p % 64 == 48 ? 64 : p % 64);
}
__host__ __device__ constexpr int dim_cols(int p) { return p / 64 * 64 + rem_cols(p); }
// wgmma's layout code of an atom of w columns (its swizzle: 2w bytes)
__host__ __device__ constexpr int layout_code(int w) { return w == 64 ? 1 : (w == 32 ? 2 : 3); }

// One launch: the TMA maps of q, k and v (a 64-column box, then the
// remainder's box), and what the cp.async path and the masks need.
struct Params {
  CUtensorMap map[6];
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* lengths;
  long long qsb, ksb, vsb;
  int qsl, qsh, ksl, ksh, vsl, vsh;
  int L, H, KVH, Dk, Dv, dkp, causal;
  float scale;
  int width[3];  // q, k, v: 0 = TMA, else bytes per cp.async copy (16, 8, 4), 2 = plain loads
  int stages, cluster, nq, nsteps, qstride, v1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- TMA -----------------------------------------------------------------

// box at (c0: column, c1: row, c2: head, c3: batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same box into every CTA of `mask`, each signalling its own barrier
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, int c2,
                                                   int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "h"(mask)
      : "memory");
}

// --- cp.async (operands TMA cannot take) ---------------------------------

template <int W>
__device__ __forceinline__ void cp_async(uint32_t dst, const bf16* src, int src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(W), "r"(src_bytes)
                 : "memory");
}

// Rows [r0, r0 + rows) of one (batch, head) operand, padded head dim P, into
// its atoms at `dst` in the layout TMA writes (zero at rows >= L and columns
// >= d), by the loading warp; W bytes per copy (W = 2: plain loads and
// stores).
template <int W>
__device__ __forceinline__ void copy_tile_w(uint32_t dst, const bf16* __restrict__ src,
                                            int row_stride, int r0, int rows, int L, int d,
                                            int P, int tid) {
  constexpr int E = W / 2;  // bf16 per copy
  const int full = P / 64, natoms = full + (rem_cols(P) ? 1 : 0);
  for (int a = 0; a < natoms; ++a) {
    const int w = a < full ? 64 : rem_cols(P), col0 = 64 * a;
    const int mask = w / 8 - 1;  // 16-byte chunks per row, minus one (the swizzle's XOR bits)
    const uint32_t base = dst + a * rows * 128;
    const int per_row = w / E;
    for (int c = tid; c < rows * per_row; c += LOADERS) {
      const int r = c / per_row, col = (c - r * per_row) * E, gr = r0 + r, gc = col0 + col;
      const int n = gr < L ? min(max(d - gc, 0), E) : 0;  // elements read
      const bf16* s = n > 0 ? src + (size_t)gr * row_stride + gc : src;
      const uint32_t o = r * w * 2 + col * 2;
      const uint32_t t = base + (o ^ (((o >> 7) & mask) << 4));
      if constexpr (W == 2) {
        const unsigned short val = n > 0 ? __bfloat16_as_ushort(*s) : (unsigned short)0;
        asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(t), "h"(val) : "memory");
      } else {
        cp_async<W>(t, s, 2 * n);
      }
    }
  }
}

__device__ __forceinline__ void copy_tile(int width, uint32_t dst, const bf16* src,
                                          int row_stride, int r0, int rows, int L, int d,
                                          int P, int tid) {
  switch (width) {
    case 16: copy_tile_w<16>(dst, src, row_stride, r0, rows, L, d, P, tid); break;
    case 8: copy_tile_w<8>(dst, src, row_stride, r0, rows, L, d, P, tid); break;
    case 4: copy_tile_w<4>(dst, src, row_stride, r0, rows, L, d, P, tid); break;
    default: copy_tile_w<2>(dst, src, row_stride, r0, rows, L, d, P, tid);
  }
}

// the copies of this thread have landed and are visible to the async proxy
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fence_proxy_async();
}

// TMA loads of one operand tile (every atom) at row r0 into `dst`
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* maps, uint32_t bar,
                                         int P, int rows, int r0, int head, int batch,
                                         int cluster) {
  const int full = P / 64, natoms = full + (rem_cols(P) ? 1 : 0);
  for (int a = 0; a < natoms; ++a) {
    // a 48-column remainder sits in a 64-column atom: the full box's map
    const CUtensorMap* map = (a < full || rem_cols(P) == 64) ? &maps[0] : &maps[1];
    const uint32_t at = dst + a * rows * 128;
    if (cluster > 1)
      tma_load_multicast(at, map, bar, 64 * a, r0, head, batch, (uint16_t)((1u << cluster) - 1));
    else
      tma_load(at, map, bar, 64 * a, r0, head, batch);
  }
}

// --- wgmma ---------------------------------------------------------------

// shared-memory matrix descriptor: start, leading and stride byte offsets,
// layout (1: 128-byte swizzle, 2: 64-byte, 3: 32-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand (rows x P) at `base`, the 16 columns from 16 * j, rows from r0
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int P, int rows, int r0, int j) {
  const int full = P / 64, c = 16 * j;
  const int a = c < 64 * full ? c / 64 : full;
  const int w = a < full ? 64 : rem_cols(P);
  const uint32_t addr = base + a * rows * 128 + r0 * w * 2 + (c - 64 * a) * 2;
  return make_desc(addr, 16, 16 * w, layout_code(w));
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

// the two consumer warpgroups take turns issuing products (named barriers
// 1 and 2, 256 threads): one runs its softmax while the other's products run
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// exp(x) in f32 for the softmax: 2^(x log2 e) on the MUFU unit, within a
// few ulp of expf at a quarter of its instructions
__device__ __forceinline__ float exp_f32(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// d (64 x 128, f32) = [d +] A (smem, K-major) . B (smem, K-major), k = 16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 16, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 48, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 112, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (registers) . B (smem, MN-major), k = 16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T over NK 16-column steps of the head dim, in one straight line
template <int NK>
__device__ __forceinline__ void qk_products(float (&s)[64], uint32_t sq, uint32_t sk, int dkp,
                                            int q_row) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
    wgmma_ss_n128(s, kmajor_desc(sq, dkp, BQ, q_row, j), kmajor_desc(sk, dkp, BKV, 0, j), j > 0);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 48) wgmma_rs_n48(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 112) wgmma_rs_n112(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// Key tiles query tile qt attends (0 past the last query tile).
__device__ __forceinline__ int tiles_of(int qt, int nq, int nkt, int causal) {
  if (qt >= nq) return 0;
  return causal ? min(nkt, qt + 1) : nkt;
}

// The bf16 kernel of both schedules; DVP is Dv padded to 16. V's columns
// go to the PV product in at most two pieces: NA columns in 128-byte-swizzle
// atoms and NB (16 or 32) in the remainder atom.
template <int DVP>
__global__ void __launch_bounds__(THREADS, 1) flash_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int NB = (DVP % 64 == 16 || DVP % 64 == 32) ? DVP % 64 : 0;
  constexpr int NA = DVP - NB;
  constexpr int VC = dim_cols(DVP);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int KC = dim_cols(p.dkp);
  const uint32_t q_bytes = BQ * KC * 2, k_bytes = BKV * KC * 2, v_bytes = BKV * VC * 2;
  const uint32_t sQ = base, sKV = base + q_bytes;
  const uint32_t bars = sKV + p.stages * (k_bytes + v_bytes);
  const uint32_t q_full = bars + 16 * MAX_STAGES, q_empty = q_full + 8;
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  auto k_tile = [&](int s) { return sKV + s * (k_bytes + v_bytes); };
  auto v_tile = [&](int s) { return sKV + s * (k_bytes + v_bytes) + k_bytes; };

  const int C = p.cluster;
  const bool q_cp = p.width[0] != 0, kv_cp = p.width[1] != 0 || p.width[2] != 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      bar_init(full_bar(s), 1 + (kv_cp ? LOADERS : 0));
      bar_init(empty_bar(s), 8 * C);  // every consumer warp of every member
    }
    bar_init(q_full, 1 + (q_cp ? LOADERS : 0));
    bar_init(q_empty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (C > 1) cluster_sync();  // no member signals a barrier before it exists

  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (p.H / p.KVH);
  const int rank = C > 1 ? (int)cluster_rank() : 0;
  // v1: one query tile, the heaviest causal tiles first; v2: cluster j of S
  // on this head takes the C adjacent tiles from C * j, then from C * (j + S), ...
  const int qt0 = p.v1 ? p.nq - 1 - blockIdx.x : blockIdx.x;
  const int L = p.L;
  int valid = L;
  if (p.lengths != nullptr) valid = min(max(p.lengths[b], 0), L);
  const int nkt = (valid + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (wg == 2) {
    // ---------------- the loading warp ----------------
    const bf16* qb = p.q + b * p.qsb + (size_t)h * p.qsh;
    const bf16* kb = p.k + b * p.ksb + (size_t)kvh * p.ksh;
    const bf16* vb = p.v + b * p.vsb + (size_t)kvh * p.vsh;
    const uint32_t kv_tma_bytes =
        (p.width[1] == 0 ? k_bytes : 0) + (p.width[2] == 0 ? v_bytes : 0);
    int st = 0, ph = 0, qph = 0;
    for (int step = 0; step < p.nsteps; ++step) {
      const int qt = qt0 + step * p.qstride;
      bar_wait(q_empty, qph ^ 1);
      if (!q_cp) {
        if (tid == 0) {
          bar_arrive_tx(q_full, qt < p.nq ? q_bytes : 0);
          if (qt < p.nq) tma_tile(sQ, &p.map[0], q_full, p.dkp, BQ, qt * BQ, h, b, 1);
        }
      } else {
        if (tid == 0) bar_arrive(q_full);
        if (qt < p.nq) copy_tile(p.width[0], sQ, qb, p.qsl, qt * BQ, BQ, L, p.Dk, p.dkp, tid);
        copies_done();
        bar_arrive(q_full);
      }
      qph ^= 1;
      // the cluster walks to the furthest tile any member needs
      const int walk = tiles_of(min(qt - rank + C - 1, p.nq - 1), p.nq, nkt, p.causal);
      for (int t = 0; t < walk; ++t) {
        bar_wait(empty_bar(st), ph ^ 1);
        if (tid == 0) {
          bar_arrive_tx(full_bar(st), kv_tma_bytes);
          if (t % C == rank) {  // the members take turns fetching for all
            if (p.width[1] == 0)
              tma_tile(k_tile(st), &p.map[2], full_bar(st), p.dkp, BKV, t * BKV, kvh, b, C);
            if (p.width[2] == 0)
              tma_tile(v_tile(st), &p.map[4], full_bar(st), DVP, BKV, t * BKV, kvh, b, C);
          }
        }
        if (kv_cp) {
          if (p.width[1] != 0)
            copy_tile(p.width[1], k_tile(st), kb, p.ksl, t * BKV, BKV, L, p.Dk, p.dkp, tid);
          if (p.width[2] != 0)
            copy_tile(p.width[2], v_tile(st), vb, p.vsl, t * BKV, BKV, L, p.Dv, DVP, tid);
          copies_done();
          bar_arrive(full_bar(st));
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    // no member leaves while another may still write into its ring or signal it
    if (C > 1) cluster_sync();
  } else {
    // ---------------- consumers ----------------
    const int g = wg, warp = tid / 32, lane = tid % 32;
    const int nkd = (p.Dk + 15) / 16;
    int st = 0, ph = 0, qph = 0;
    if (g == 1) turn_pass(1);  // the first warpgroup goes first
    for (int step = 0; step < p.nsteps; ++step) {
      const int qt = qt0 + step * p.qstride;
      const int walk = tiles_of(min(qt - rank + C - 1, p.nq - 1), p.nq, nkt, p.causal);
      const int own = tiles_of(qt, p.nq, nkt, p.causal);
      // C fragment rows of this thread: row0 and row0 + 8
      const int row_lo = qt * BQ + g * 64, row0 = row_lo + warp * 16 + lane / 4;
      float oa[NA > 0 ? NA / 2 : 1], ob[NB > 0 ? NB / 2 : 1];
#pragma unroll
      for (int i = 0; i < (NA > 0 ? NA / 2 : 1); ++i) oa[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (NB > 0 ? NB / 2 : 1); ++i) ob[i] = 0.f;
      float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
      bar_wait(q_full, qph);
      if (q_cp) fence_proxy_async();
      for (int t = 0; t < walk; ++t) {
        bar_wait(full_bar(st), ph);
        if (kv_cp) fence_proxy_async();
        if (t < own) {
          const int k0 = t * BKV;
          // S = Q K^T
          float s[64];
          turn_wait(1 + g);
          wgmma_fence();
          const uint32_t sk = k_tile(st);
          switch (nkd) {
            case 1: qk_products<1>(s, sQ, sk, p.dkp, g * 64); break;
            case 2: qk_products<2>(s, sQ, sk, p.dkp, g * 64); break;
            case 3: qk_products<3>(s, sQ, sk, p.dkp, g * 64); break;
            case 4: qk_products<4>(s, sQ, sk, p.dkp, g * 64); break;
            case 5: qk_products<5>(s, sQ, sk, p.dkp, g * 64); break;
            case 6: qk_products<6>(s, sQ, sk, p.dkp, g * 64); break;
            case 7: qk_products<7>(s, sQ, sk, p.dkp, g * 64); break;
            default: qk_products<8>(s, sQ, sk, p.dkp, g * 64);
          }
          wgmma_commit();
          turn_pass(2 - g);
          wgmma_wait0();
          fence_regs(s);

          // scale, mask (only a tile that holds a boundary), tile row max
          const bool edge = k0 + BKV > valid || (p.causal && k0 + BKV - 1 > row_lo);
          float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float sc = s[4 * i + e] * p.scale;
              if (edge) {
                const int key = k0 + 8 * i + 2 * (lane & 3) + (e & 1);
                const int row = row0 + (e >> 1) * 8;
                if (!(key < valid && (!p.causal || key <= row))) sc = NEG_INF;
              }
              s[4 * i + e] = sc;
              tmax[e >> 1] = fmaxf(tmax[e >> 1], sc);
            }
          float corr[2], tsum[2] = {0.f, 0.f};
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
            tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
            const float m_new = fmaxf(m[r], tmax[r]);
            corr[r] = exp_f32(m[r] - m_new);
            m[r] = m_new;
          }
          uint32_t pa[BKV / 16][4];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            float pe[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pe[e] = exp_f32(s[4 * i + e] - m[e >> 1]);
              tsum[e >> 1] += pe[e];
            }
            // the S accumulators of key columns 16kk .. 16kk + 15 are the A
            // fragment of keys kk * 16 ..
            pa[i / 2][(i & 1) * 2] = pack_bf16(pe[0], pe[1]);
            pa[i / 2][(i & 1) * 2 + 1] = pack_bf16(pe[2], pe[3]);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
            tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
            l[r] = l[r] * corr[r] + tsum[r];
          }
#pragma unroll
          for (int i = 0; i < (NA > 0 ? NA / 2 : 0); ++i) oa[i] *= corr[(i >> 1) & 1];
#pragma unroll
          for (int i = 0; i < (NB > 0 ? NB / 2 : 0); ++i) ob[i] *= corr[(i >> 1) & 1];

          // O += bf16(P) V, V read transposed (MN-major) from its atoms
          fence_regs(oa);
          fence_regs(ob);
          fence_regs(pa);
          turn_wait(1 + g);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            if constexpr (NA > 0)
              wgmma_rs<NA>(oa, pa[kk],
                           make_desc(v_tile(st) + kk * 16 * 128, BKV * 128, 1024, 1));
            if constexpr (NB > 0)
              wgmma_rs<NB>(ob, pa[kk],
                           make_desc(v_tile(st) + (DVP / 64) * BKV * 128 + kk * 16 * NB * 2,
                                     BKV * 128, 16 * NB, layout_code(NB)));
          }
          wgmma_commit();
          turn_pass(2 - g);
          wgmma_wait0();
          fence_regs(oa);
          fence_regs(ob);
        }
        // this warp is done with the stage, in every member that received it
        __syncwarp();
        if (lane == 0) {
          if (C > 1) {
            for (int c = 0; c < C; ++c) bar_arrive_remote(empty_bar(st), c);
          } else {
            bar_arrive(empty_bar(st));
          }
        }
        if (++st == p.stages) {
          st = 0;
          ph ^= 1;
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(q_empty);
      qph ^= 1;

      // epilogue: acc / max(sum, 1e-30), rows row0 and row0 + 8
      if (qt < p.nq) {
        const int c2 = 2 * (lane & 3);
        const bool pairs = (p.Dv & 1) == 0;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + r * 8;
          if (row >= L) continue;
          const float den = fmaxf(l[r], 1e-30f);
          bf16* out = p.o + (((size_t)b * L + row) * p.H + h) * p.Dv;
          auto put = [&](int d, float x0, float x1) {
            if (d >= p.Dv) return;
            const bf16 v0 = __float2bfloat16_rn(x0 / den), v1 = __float2bfloat16_rn(x1 / den);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(out + d) = __halves2bfloat162(v0, v1);
            } else {
              out[d] = v0;
              if (d + 1 < p.Dv) out[d + 1] = v1;
            }
          };
#pragma unroll
          for (int i = 0; i < NA / 8; ++i) put(8 * i + c2, oa[4 * i + 2 * r], oa[4 * i + 2 * r + 1]);
#pragma unroll
          for (int i = 0; i < NB / 8; ++i)
            put(NA + 8 * i + c2, ob[4 * i + 2 * r], ob[4 * i + 2 * r + 1]);
        }
      }
    }
    if (C > 1) cluster_sync();
  }
}

// --------------------------------------------------------------------------
// f32, CUDA cores (checks only)
// --------------------------------------------------------------------------

constexpr int FQ = 64;    // query rows (threads) per block
constexpr int FKV = 32;   // keys per tile

#define FLASH_F32_PARAMS                                                        \
  const float *__restrict__ q, const float *__restrict__ k,                     \
      const float *__restrict__ v, float *__restrict__ o,                       \
      const int *__restrict__ lengths, int L, int H, int KVH, int Dk, int Dv,   \
      long long qsb, int qsl, int qsh, long long ksb, int ksl, int ksh,         \
      long long vsb, int vsl, int vsh, int causal, float scale
#define FLASH_F32_ARGS                                                         \
  q, k, v, o, lengths, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb, ksl, ksh, vsb,  \
      vsl, vsh, causal, scale

// Query rows [q0, q0 + FQ) of head h of batch item b, one per thread; every
// thread takes part in the K/V staging, rows past L included.
__device__ __forceinline__ void flash_f32_tile(float (*sK)[DMAX], float (*sV)[DMAX], int q0,
                                               int h, int b, FLASH_F32_PARAMS) {
  const int tid = threadIdx.x;
  const int row = q0 + tid;
  const int kvh = h / (H / KVH);
  int valid = L;
  if (lengths != nullptr) valid = min(max(lengths[b], 0), L);
  const float* qr = q + b * qsb + (size_t)h * qsh + (size_t)min(row, L - 1) * qsl;
  const float* kb = k + b * ksb + (size_t)kvh * ksh;
  const float* vb = v + b * vsb + (size_t)kvh * vsh;

  float qv[DMAX], acc[DMAX];
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qv[d] = d < Dk ? qr[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  int last = valid;
  if (causal) last = min(last, q0 + FQ);
  for (int k0 = 0; k0 < last; k0 += FKV) {
    __syncthreads();
    for (int c = tid; c < FKV * DMAX; c += FQ) {
      const int r = c / DMAX, d = c % DMAX, gr = k0 + r;
      sK[r][d] = (gr < L && d < Dk) ? kb[(size_t)gr * ksl + d] : 0.f;
      sV[r][d] = (gr < L && d < Dv) ? vb[(size_t)gr * vsl + d] : 0.f;
    }
    __syncthreads();
    float s[FKV];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < FKV; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) dot = fmaf(qv[d], sK[j][d], dot);
      const int key = k0 + j;
      const bool ok = key < valid && (!causal || key <= row);
      s[j] = ok ? dot * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    float tsum = 0.f;
#pragma unroll
    for (int j = 0; j < FKV; ++j) {
      s[j] = expf(s[j] - m_new);
      tsum += s[j];
    }
    l = l * corr + tsum;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) {
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < FKV; ++j) pv = fmaf(s[j], sV[j][d], pv);
      acc[d] = acc[d] * corr + pv;
    }
  }
  if (row < L) {
    const float den = fmaxf(l, 1e-30f);
    float* out = o + (((size_t)b * L + row) * H + h) * Dv;
    for (int d = 0; d < Dv; ++d) out[d] = acc[d] / den;
  }
}

__global__ void __launch_bounds__(FQ) flash_f32_kernel(FLASH_F32_PARAMS) {
  __shared__ float sK[FKV][DMAX];
  __shared__ float sV[FKV][DMAX];
  flash_f32_tile(sK, sV, blockIdx.x * FQ, blockIdx.y, blockIdx.z, FLASH_F32_ARGS);
}

__global__ void __launch_bounds__(FQ) flash_v2_f32_kernel(FLASH_F32_PARAMS) {
  __shared__ float sK[FKV][DMAX];
  __shared__ float sV[FKV][DMAX];
  for (int q0 = 0; q0 < L; q0 += FQ)
    flash_f32_tile(sK, sV, q0, blockIdx.x, blockIdx.y, FLASH_F32_ARGS);
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

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

// The TMA map of one (B, L, heads, d) operand with `box_cols`-column boxes of
// 128 rows; strides in elements. A stride of an extent-1 dim is never used,
// so it is replaced by one TMA takes. Returns 0, or 1000 + the CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int d, int L, int heads, int B, long long sl,
               long long sh, long long sb, int box_cols) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return 1999;
  if (L == 1) sl = (d + 7) / 8 * 8;
  if (heads == 1) sh = sl * L;
  if (B == 1) sb = sh * heads;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)L, (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sl * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)BKV, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1000 + (int)r;
}

// maps[0] (64-column boxes) and maps[1] (the 16- or 32-column remainder)
int encode_maps(CUtensorMap* maps, const void* ptr, int d, int P, int L, int heads, int B,
                long long sl, long long sh, long long sb) {
  int err = 0;
  if (P >= 64 || rem_cols(P) == 64) err = encode_map(&maps[0], ptr, d, L, heads, B, sl, sh, sb, 64);
  if (err == 0 && (rem_cols(P) == 16 || rem_cols(P) == 32))
    err = encode_map(&maps[1], ptr, d, L, heads, B, sl, sh, sb, rem_cols(P));
  return err;
}

int smem_bytes(int dkp, int dvp, int stages) {
  return 1024 + BQ * dim_cols(dkp) * 2 + stages * BKV * (dim_cols(dkp) + dim_cols(dvp)) * 2 +
         BARRIER_BYTES;
}

template <int DVP>
void* bf16_kernel() {
  return reinterpret_cast<void*>(flash_wgmma_kernel<DVP>);
}

void* bf16_kernel_for(int dvp) {
  switch (dvp) {
    case 16: return bf16_kernel<16>();
    case 32: return bf16_kernel<32>();
    case 48: return bf16_kernel<48>();
    case 64: return bf16_kernel<64>();
    case 80: return bf16_kernel<80>();
    case 96: return bf16_kernel<96>();
    case 112: return bf16_kernel<112>();
    default: return bf16_kernel<128>();
  }
}

int launch_bf16(int v1, const void* q, const void* k, const void* v, void* o,
                const void* lengths, int B, int L, int H, int KVH, int Dk, int Dv,
                long long qsb, int qsl, int qsh, long long ksb, int ksl, int ksh, long long vsb,
                int vsl, int vsh, int causal, float scale, const int* plan, cudaStream_t s) {
  // plan: dkp, dvp, q/k/v copy width (0 = TMA), stages, cluster, clusters per
  // head, shared bytes
  const int dkp = plan[0], dvp = plan[1], stages = plan[5], cluster = v1 ? 1 : plan[6];
  const int splits = v1 ? 1 : plan[7], smem = plan[8];
  if (dkp != (Dk + 15) / 16 * 16 || dvp != (Dv + 15) / 16 * 16 || stages < 2 ||
      stages > MAX_STAGES || cluster < 1 || cluster > MAX_CLUSTER ||
      (cluster & (cluster - 1)) != 0 || splits < 1 || smem != smem_bytes(dkp, dvp, stages) ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lengths = static_cast<const int*>(lengths);
  p.qsb = qsb, p.ksb = ksb, p.vsb = vsb;
  p.qsl = qsl, p.qsh = qsh, p.ksl = ksl, p.ksh = ksh, p.vsl = vsl, p.vsh = vsh;
  p.L = L, p.H = H, p.KVH = KVH, p.Dk = Dk, p.Dv = Dv, p.dkp = dkp, p.causal = causal;
  p.scale = scale;
  for (int i = 0; i < 3; ++i) p.width[i] = plan[2 + i];
  p.stages = stages, p.cluster = cluster, p.v1 = v1;
  p.nq = (L + BQ - 1) / BQ;
  p.qstride = cluster * splits;
  p.nsteps = v1 ? 1 : (p.nq + p.qstride - 1) / p.qstride;
  int err = 0;
  if (p.width[0] == 0) err = encode_maps(&p.map[0], q, Dk, dkp, L, H, B, qsl, qsh, qsb);
  if (!err && p.width[1] == 0) err = encode_maps(&p.map[2], k, Dk, dkp, L, KVH, B, ksl, ksh, ksb);
  if (!err && p.width[2] == 0) err = encode_maps(&p.map[4], v, Dv, dvp, L, KVH, B, vsl, vsh, vsb);
  if (err) return err;

  void* kernel = bf16_kernel_for(dvp);
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = v1 ? dim3(p.nq, H, B) : dim3(p.qstride, H, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  void* args[] = {&p};
  e = cudaLaunchKernelExC(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// schedule 0: flash_attention (a CTA per query tile, head and batch item);
// 1: flash_attention_v2 (a cluster per head and batch item walking the query
// tiles; f32: one block per head and batch item)
int launch(int schedule, int dtype, const void* q, const void* k, const void* v, void* o,
           const void* lengths, int B, int L, int H, int KVH, int Dk, int Dv,
           long long qsb, int qsl, int qsh, long long ksb, int ksl, int ksh,
           long long vsb, int vsl, int vsh, int causal, float scale, const int* plan,
           void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Dk <= 0 ||
      Dv <= 0 || Dk > DMAX || Dv > DMAX || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 1) {
    return launch_bf16(schedule == 0, q, k, v, o, lengths, B, L, H, KVH, Dk, Dv, qsb, qsl, qsh,
                       ksb, ksl, ksh, vsb, vsl, vsh, causal, scale, plan, s);
  } else if (dtype == 0) {
    const auto kernel = schedule ? flash_v2_f32_kernel : flash_f32_kernel;
    const dim3 grid = schedule ? dim3(H, B) : dim3((L + FQ - 1) / FQ, H, B);
    kernel<<<grid, FQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lens, L, H, KVH, Dk, Dv,
        qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, causal, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). Strides are in elements
// (batch, row, head) with a unit feature stride; o is contiguous (B, L, H,
// Dv). lengths: B int32 valid key counts on the device, or null for all L.
// plan (bf16; kernels/flash_attention.py::_plan): 9 ints, the padded Dk and
// Dv, the q/k/v copy widths (0 = TMA), the ring stages, v2's cluster size
// and clusters per (head, batch item), and the dynamic shared-memory bytes. Returns the cudaError_t of the launch
// (0 = launched), or 1000 + the CUresult of a failed TMA map encoding.
int flash_attn_launch(int dtype, const void* q, const void* k, const void* v,
                      void* o, const void* lengths, int B, int L, int H, int KVH,
                      int Dk, int Dv, long long qsb, int qsl, int qsh,
                      long long ksb, int ksl, int ksh, long long vsb, int vsl,
                      int vsh, int causal, float scale, const int* plan, void* stream) {
  return launch(0, dtype, q, k, v, o, lengths, B, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb,
                ksl, ksh, vsb, vsl, vsh, causal, scale, plan, stream);
}

// How many CTAs of the bf16 kernel for padded Dv `dvp` with `smem` bytes of
// shared memory the card holds at once in clusters of `cluster` (the plan's
// v2 cluster choice reads it), or -1.
int flash_attn_resident_ctas(int dvp, int smem, int cluster) {
  void* kernel = bf16_kernel_for(dvp);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cluster == 1) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem) != cudaSuccess)
      return -1;
    return n * sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n * cluster;
}

// The same contract and arguments, on the K/V-resident schedule.
int flash_attn_v2_launch(int dtype, const void* q, const void* k, const void* v,
                         void* o, const void* lengths, int B, int L, int H, int KVH,
                         int Dk, int Dv, long long qsb, int qsl, int qsh,
                         long long ksb, int ksl, int ksh, long long vsb, int vsl,
                         int vsh, int causal, float scale, const int* plan, void* stream) {
  return launch(1, dtype, q, k, v, o, lengths, B, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb,
                ksl, ksh, vsb, vsl, vsh, causal, scale, plan, stream);
}

}  // extern "C"
