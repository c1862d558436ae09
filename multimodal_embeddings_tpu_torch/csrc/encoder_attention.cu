// Whole-row encoder self-attention for Hopper (sm_90a), one kernel for every
// K1 form of the page programs.
//
// Replaces the Pallas TPU kernels of
// multimodal_embeddings_tpu/kernels/encoder_attention.py:
// `_enc_attn_blf_kernel` / `_enc_attn_blf_scratch_kernel`
// (encoder_attention_blf), `_enc_attn_blf_packed_kernel`
// (encoder_attention_blf_packed), `_enc_attn_blhd_kernel`
// (encoder_attention_blhd) and `_enc_attn_kernel` (encoder_attention, its
// bhld_inputs form, and encoder_attention_padded which calls it). All
// compute, per (batch, head), a softmax over whole score rows whose keys are
// the prefix [0, valid_len) of the L rows:
//
//   s = (q . k) * scale              f32, keys j < valid_len
//   e = exp(s - rowmax(s))           f32, rowmax over ALL valid keys of the row
//   denom = sum(e)                   f32, of the unrounded e
//   o = (cast_T(e) @ v) / max(denom, 1e-30), accumulated in f32, cast to T
//
// Keys at or past valid_len take no part (the TPU kernel's -1e30 score, whose
// e is exactly 0 in f32). Every one of the L rows is still a query (the
// Mllama vision tower carries its 7 padding rows through every layer).
// Operands are addressed through (batch, row, head) strides with a unit
// feature stride, so one kernel reads the split (B, L, H*D) slabs of the ViT,
// the (B, L, H, D) and (B, H, L, D) views of the Mllama tower and of the
// proj-BHLD route, strided column slices of a fused qkv product, and the
// packed per-head [q(kd) | k(kd) | v(hd)] slab of the detector's PSA block.
//
// bf16, the path every page runs, on tensor cores. What bounds it on this
// card: the two products, 4*L*n*D flops per head over n valid keys (0.09 ms
// at the ViT shape at 989 TFLOP/s, against 0.02 ms of HBM traffic), and the
// exp of every score on the special-function units. The contract's exact row
// max rules out an online softmax (it would round e against a running max
// and rescale it), so each CTA makes TWO passes over the key tiles of its
// query tile:
//
//   pass 1: S = Q K^T on mma.sync m16n8k16 (bf16 in, f32 accumulate), the
//           row max kept in f32 and reduced over the 4 lanes of a row;
//   pass 2: S again, by the same instructions in the same order (bitwise the
//           pass-1 values), p = exp(s - m) in f32, the f32 row sum of the
//           unrounded p, p rounded to bf16 and moved from the S accumulators
//           into the PV A fragments in registers (the C and A fragment
//           layouts line up), O += P V on mma.sync.
//
// That is 1.5x the tensor-core work of one pass. A CTA is 8 warps of 16 query
// rows (128 rows, so each K/V tile staged in shared memory feeds 8 warps and
// the CTAs of one head read K and V from L2 half as often as 64-row CTAs
// would); Q is loaded once into A fragments; the grid is (query tiles, H, B)
// with query tiles fastest, so the CTAs of one head run together and share
// its K/V in L2. K and V come in tiles of 64 keys through a 3-stage cp.async
// ring (the next tiles' copies overlap this tile's products); shared rows are
// padded by 8 bf16 so ldmatrix reads hit 8 distinct 16-byte bank groups.
// Rows past L or past valid_len and columns past D or DV are zero-filled by
// cp.async's src-size operand; head dims are padded to a multiple of 16 (the
// zero columns add exactly 0 to every dot; columns past DV are never stored);
// scores of keys past valid_len are set to -1e30 before the max and the exp,
// and tiles wholly past valid_len are never visited. The copy width of each
// operand (16, 8 or 4 bytes, else 2 by plain loads) is chosen by the caller
// from its base address and strides (kernels/encoder_attention.py::_plan):
// the PSA slab's k starts 72 bytes into each head, only 8-byte aligned.
// wgmma and TMA are the next steps (TMA needs 16-byte-aligned bases).
//
// f32 (checks only) keeps the CUDA-core form: a tile of TQ = 16 query rows'
// f32 score rows resident in shared memory (the TPU kernel's whole-row VMEM
// buffer), K and V streamed through a staged tile, register micro-tiles of
// 4 rows per thread. Its shared memory grows with L.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// --------------------------------------------------------------------------
// bf16, tensor cores
// --------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int BQ = 16 * TC_WARPS;  // query rows per CTA
constexpr int BK = 64;             // keys per ring tile
constexpr int STAGES = 3;          // ring depth
constexpr int PAD = 8;             // bf16 appended to every shared row
constexpr int MAX_DIM = 128;       // D and DV bound
constexpr float NEG_INF = -1e30f;

// shared memory of one bf16 launch: the K/V ring, then the Q tile; the
// caller's plan computes the same bytes
inline size_t tc_smem_bytes(int dp, int dvp) {
  return sizeof(bf16) *
         ((size_t)STAGES * BK * (dp + dvp + 2 * PAD) + (size_t)BQ * (dp + PAD));
}

struct Operand {   // q, k or v of one launch
  const bf16* ptr;
  long long batch;  // elements between batch items
  int row;          // elements between tokens
  int head;         // elements between heads
  int width;        // bytes per copy: 16, 8, 4 or 2
};

struct TcArgs {
  Operand q, k, v;
  bf16* o;
  long long o_batch;
  int o_row, o_head;
  int L, NV, D, DV;
  int nkd, nvd;  // 16-column chunks of the padded D and DV
  float scale;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// W bytes from global to shared memory, of which the first src_bytes are
// read and the rest zero-filled (.cg, L2 only, takes only 16 bytes)
template <int W>
__device__ __forceinline__ void cp_async(bf16* dst, const bf16* src, int src_bytes) {
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(W), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) x columns [0, dp) of one (batch, head) operand into
// shared rows of ld elements, zero at rows >= limit and columns >= d; W = 2
// (an operand only 2-byte aligned) copies by plain loads and stores
template <int W>
__device__ __forceinline__ void load_rows_w(bf16* dst, int ld, const bf16* src,
                                            int row_stride, int r0, int rows, int limit,
                                            int d, int dp) {
  constexpr int E = W / 2;  // bf16 per copy
  const int per_row = dp / E;
  for (int c = threadIdx.x; c < rows * per_row; c += TC_THREADS) {
    const int r = c / per_row, col = (c - r * per_row) * E, gr = r0 + r;
    const int n = gr < limit ? min(max(d - col, 0), E) : 0;  // elements read
    const bf16* s = n > 0 ? src + (size_t)gr * row_stride + col : src;
    bf16* t = dst + r * ld + col;
    if constexpr (W == 2)
      *t = n > 0 ? *s : __ushort_as_bfloat16(0);
    else
      cp_async<W>(t, s, 2 * n);
  }
}

__device__ __forceinline__ void load_rows(bf16* dst, int ld, int width, const bf16* src,
                                          int row_stride, int r0, int rows, int limit,
                                          int d, int dp) {
  switch (width) {
    case 16: load_rows_w<16>(dst, ld, src, row_stride, r0, rows, limit, d, dp); break;
    case 8: load_rows_w<8>(dst, ld, src, row_stride, r0, rows, limit, d, dp); break;
    case 4: load_rows_w<4>(dst, ld, src, row_stride, r0, rows, limit, d, dp); break;
    default: load_rows_w<2>(dst, ld, src, row_stride, r0, rows, limit, d, dp);
  }
}

// The scaled, masked scores of this warp's 16 query rows against keys
// [k0, k0 + BK): C fragment s[j][e] holds row lane/4 + 8*(e/2), key
// k0 + 8*j + 2*(lane%4) + e%2. Both passes call this, so the scores of
// pass 2 are bitwise those of pass 1.
template <int KC, bool EXACT>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4], const uint32_t (&qf)[KC][4],
                                       const bf16* sK, int ldk, int nkd, int k0, int NV,
                                       float scale, int lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    if (!EXACT && kk >= nkd) continue;
#pragma unroll
    for (int jj = 0; jj < BK / 16; ++jj) {
      // matrices: keys jj*16 + {0-7, 0-7, 8-15, 8-15} x dims kk*16 + {0-7, 8-15, 0-7, 8-15}
      uint32_t kf[4];
      ldmatrix_x4(kf, &sK[(jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldk + kk * 16 +
                          ((lane >> 3) & 1) * 8]);
      mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
    }
  }
  const bool full = k0 + BK <= NV;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = __fmul_rn(s[j][e], scale);
      s[j][e] = (full || k0 + j * 8 + 2 * (lane & 3) + (e & 1) < NV) ? x : NEG_INF;
    }
}

// One CTA: query rows [blockIdx.x * BQ, + BQ) of head blockIdx.y of batch
// item blockIdx.z. KC / VC: 16-column chunks of D / DV held in registers;
// EXACT: they are the launch's nkd / nvd, else nkd <= KC, nvd <= VC. Up to
// 80 columns of each, two CTAs share an SM (at most 128 registers a thread:
// Q 4*KC, S 32, O 8*VC of them).
template <int KC, int VC, bool EXACT>
__global__ void __launch_bounds__(TC_THREADS, KC + VC <= 10 ? 2 : 1)
    enc_attn_tc_kernel(const TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkd = EXACT ? KC : a.nkd, nvd = EXACT ? VC : a.nvd;
  const int dp = nkd * 16, dvp = nvd * 16;
  const int ldk = dp + PAD, ldv = dvp + PAD;
  const int stage = BK * (ldk + ldv);  // one ring stage: a K tile, then a V tile
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQ = ring + STAGES * stage;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int NV = a.NV, D = a.D, DV = a.DV;
  const int kw = a.k.width, vw = a.v.width, krow = a.k.row, vrow = a.v.row;
  const bf16* qb = a.q.ptr + b * a.q.batch + (long long)h * a.q.head;
  const bf16* kb = a.k.ptr + b * a.k.batch + (long long)h * a.k.head;
  const bf16* vb = a.v.ptr + b * a.v.batch + (long long)h * a.v.head;

  load_rows(sQ, ldk, a.q.width, qb, a.q.row, q0, BQ, a.L, D, dp);
  cp_async_commit();

  // ring load j: pass 1 reads K tile j, pass 2 reads K and V tile j - nt
  const int nt = (NV + BK - 1) / BK, total = 2 * nt;
  auto fetch = [&](int j) {
    bf16* sk = ring + (j % STAGES) * stage;
    const int t = j < nt ? j : j - nt;
    load_rows(sk, ldk, kw, kb, krow, t * BK, BK, NV, D, dp);
    if (j >= nt) load_rows(sk + BK * ldk, ldv, vw, vb, vrow, t * BK, BK, NV, DV, dvp);
  };
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < total) fetch(j);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 1>();  // the Q group
  __syncthreads();
  uint32_t qf[KC][4];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk)
    if (EXACT || kk < nkd)
      ldmatrix_x4(qf[kk], &sQ[(warp * 16 + (lane & 15)) * ldk + kk * 16 + (lane >> 4) * 8]);

  float acc[2 * VC][4];
#pragma unroll
  for (int j = 0; j < 2 * VC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int i = 0; i < total; ++i) {
    cp_async_wait<STAGES - 2>();  // load i has landed (this thread's copies)
    __syncthreads();              // everyone's copies; stage (i-1) % STAGES is free
    if (i + STAGES - 1 < total) fetch(i + STAGES - 1);
    cp_async_commit();

    const bf16* sk = ring + (i % STAGES) * stage;
    const int k0 = (i < nt ? i : i - nt) * BK;
    float s[BK / 8][4];
    scores<KC, EXACT>(s, qf, sk, ldk, nkd, k0, NV, a.scale, lane);

    if (i < nt) {  // pass 1: the row max
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      if (i == nt - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
          m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
        }
      }
      continue;
    }

    // pass 2: p = exp(s - m), the unrounded sum, O += bf16(p) . V
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[j][e], m[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
    const bf16* sV = sk + BK * ldk;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the S accumulators of key groups 2kk, 2kk+1 are the A fragment of
      // keys kk*16 .. kk*16+15
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int vj = 0; vj < VC; ++vj) {
        if (!EXACT && vj >= nvd) continue;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[(kk * 16 + (lane & 15)) * ldv + vj * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * vj], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * vj + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: acc / max(sum, 1e-30) for rows row0 and row0 + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = q0 + warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  bf16* ob = a.o + b * a.o_batch + (long long)h * a.o_head;
  const bool pairs = ((a.DV | a.o_row | a.o_head) & 1) == 0 && (a.o_batch & 1) == 0 &&
                     (reinterpret_cast<uintptr_t>(a.o) & 3) == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= a.L) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* out = ob + (long long)row * a.o_row;
#pragma unroll
    for (int j = 0; j < 2 * VC; ++j) {
      const int d = j * 8 + c2;
      if (d >= a.DV) continue;
      const bf16 v0 = __float2bfloat16_rn(acc[j][2 * r] / den);
      const bf16 v1 = __float2bfloat16_rn(acc[j][2 * r + 1] / den);
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __halves2bfloat162(v0, v1);
      } else {
        out[d] = v0;
        if (d + 1 < a.DV) out[d + 1] = v1;
      }
    }
  }
}

// a copy width the kernel takes, dividing the base address and every stride
bool aligned(const Operand& op) {
  const long long w = op.width;
  if (w != 16 && w != 8 && w != 4 && w != 2) return false;
  return (reinterpret_cast<uintptr_t>(op.ptr) % w == 0) && (op.batch * 2) % w == 0 &&
         ((long long)op.row * 2) % w == 0 && ((long long)op.head * 2) % w == 0;
}

cudaError_t launch_bf16(const TcArgs& a, int B, int H, int smem, cudaStream_t stream) {
  // register-resident widths: the page programs' exact (D, DV) chunk counts,
  // and one form holding up to 128 columns of each for every other shape
  void (*kernel)(TcArgs) = enc_attn_tc_kernel<8, 8, false>;
  if (a.nkd == 4 && a.nvd == 4) kernel = enc_attn_tc_kernel<4, 4, true>;       // ViT 64
  else if (a.nkd == 5 && a.nvd == 5) kernel = enc_attn_tc_kernel<5, 5, true>;  // Mllama 80
  else if (a.nkd == 3 && a.nvd == 5) kernel = enc_attn_tc_kernel<3, 5, true>;  // PSA 36|72
  else if (a.nkd == 4 && a.nvd == 8) kernel = enc_attn_tc_kernel<4, 8, true>;  // probe 64|128
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + BQ - 1) / BQ, H, B);
  kernel<<<grid, TC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------------------------
// f32, CUDA cores (checks only)
// --------------------------------------------------------------------------

constexpr int TQ = 16;        // query rows per block
constexpr int KT = 64;        // keys per staged K/V tile
constexpr int THREADS = 256;  // (THREADS / KT) row groups of 4 rows == TQ

static_assert((THREADS / KT) * 4 == TQ, "score micro-tiles must cover TQ");
static_assert((TQ / 4) * MAX_DIM <= 2 * THREADS, "PV items per thread");

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Strides {
  long long batch;  // elements between batch items
  int row;          // elements between tokens
  int head;         // elements between heads
};

__host__ __device__ inline int score_stride(int L) { return (L + 3) & ~3; }
__host__ __device__ inline int k_stride(int D) { return D | 1; }  // odd: no bank conflicts
__host__ __device__ inline int kv_tile_stride(int D, int DV) {
  return k_stride(D) > DV ? k_stride(D) : DV;
}

// the caller's plan computes the same bytes
inline size_t f32_smem_bytes(int L, int D, int DV) {
  return sizeof(float) * ((size_t)D * TQ + (size_t)TQ * score_stride(L) +
                          (size_t)KT * kv_tile_stride(D, DV) + TQ);
}

__global__ void __launch_bounds__(THREADS)
    enc_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o, int L, int NV,
                        int D, int DV, Strides qs, Strides ks, Strides vs, Strides os,
                        float scale) {
  // NV = valid_len: keys [0, NV) take part, 1 <= NV <= L
  extern __shared__ __align__(16) float smem[];
  const int LP = score_stride(L);
  const int DP = k_stride(D);
  float* sQ = smem;                                // [D][TQ], transposed
  float* sS = sQ + D * TQ;                         // [TQ][LP] score rows
  float* sKV = sS + TQ * LP;                       // [KT][stride] K or V tile
  float* sDen = sKV + KT * kv_tile_stride(D, DV);  // [TQ] denominators

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = q + b * qs.batch + (long long)h * qs.head;
  const float* kb = k + b * ks.batch + (long long)h * ks.head;
  const float* vb = v + b * vs.batch + (long long)h * vs.head;
  float* ob = o + b * os.batch + (long long)h * os.head;

  // Q tile, transposed so one thread's 4 rows are one float4; rows past L
  // are zero and never stored
  for (int p = tid; p < TQ * D; p += THREADS) {
    const int r = p / D, d = p % D;
    const int row = row0 + r;
    sQ[d * TQ + r] = row < L ? qb[(long long)row * qs.row + d] : 0.f;
  }

  // scores: thread owns key jj of each tile for rows rg*4 .. rg*4+3
  const int jj = tid % KT;
  const int rg = tid / KT;
  for (int j0 = 0; j0 < NV; j0 += KT) {
    __syncthreads();  // previous tile consumed (and Q stored, first pass)
    for (int p = tid; p < KT * D; p += THREADS) {
      const int j = p / D, d = p % D;
      const int key = j0 + j;
      sKV[j * DP + d] = key < NV ? kb[(long long)key * ks.row + d] : 0.f;
    }
    __syncthreads();
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    const float* kr = sKV + jj * DP;
    const float* qc = sQ + rg * 4;
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
      const float4 qv = *reinterpret_cast<const float4*>(qc + d * TQ);
      acc0 = fmaf(qv.x, kv, acc0);
      acc1 = fmaf(qv.y, kv, acc1);
      acc2 = fmaf(qv.z, kv, acc2);
      acc3 = fmaf(qv.w, kv, acc3);
    }
    const int key = j0 + jj;
    if (key < NV) {
      float* s = sS + (rg * 4) * LP + key;
      s[0] = acc0 * scale;
      s[LP] = acc1 * scale;
      s[2 * LP] = acc2 * scale;
      s[3 * LP] = acc3 * scale;
    }
  }
  __syncthreads();

  // softmax numerator in place: f32 exp, f32 denominator
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < TQ; r += THREADS / 32) {
    float* srow = sS + r * LP;
    float m = -INFINITY;
    for (int j = lane; j < NV; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < NV; j += 32) {
      const float e = expf(srow[j] - m);
      sum += e;
      srow[j] = e;
    }
    sum = warp_sum(sum);
    // float4 tail reads of the last key tile see 0 (NV rounded up to 4 <= LP)
    if (lane < ((NV + 3) & ~3) - NV) srow[NV + lane] = 0.f;
    if (lane == 0) sDen[r] = sum;
  }

  // PV: item p = (row group, column c) holds 4 rows of one output column
  const int nitems = (TQ / 4) * DV;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int j0 = 0; j0 < NV; j0 += KT) {
    __syncthreads();  // scores final (first pass) / previous V tile consumed
    for (int p = tid; p < KT * DV; p += THREADS) {
      const int j = p / DV, c = p % DV;
      const int key = j0 + j;
      sKV[j * DV + c] = key < NV ? vb[(long long)key * vs.row + c] : 0.f;
    }
    __syncthreads();
    const int jn = min(KT, NV - j0);
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int p = tid + it * THREADS;
      if (p < nitems) {
        const int g = p / DV, c = p % DV;
        const float* e0 = sS + (g * 4) * LP + j0;
        for (int j = 0; j < jn; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(e0 + j);
          const float4 bq = *reinterpret_cast<const float4*>(e0 + LP + j);
          const float4 cq = *reinterpret_cast<const float4*>(e0 + 2 * LP + j);
          const float4 dq = *reinterpret_cast<const float4*>(e0 + 3 * LP + j);
          const float v0 = sKV[j * DV + c];
          const float v1 = sKV[(j + 1) * DV + c];
          const float v2 = sKV[(j + 2) * DV + c];
          const float v3 = sKV[(j + 3) * DV + c];
          acc[it][0] = fmaf(a.w, v3, fmaf(a.z, v2, fmaf(a.y, v1, fmaf(a.x, v0, acc[it][0]))));
          acc[it][1] = fmaf(bq.w, v3, fmaf(bq.z, v2, fmaf(bq.y, v1, fmaf(bq.x, v0, acc[it][1]))));
          acc[it][2] = fmaf(cq.w, v3, fmaf(cq.z, v2, fmaf(cq.y, v1, fmaf(cq.x, v0, acc[it][2]))));
          acc[it][3] = fmaf(dq.w, v3, fmaf(dq.z, v2, fmaf(dq.y, v1, fmaf(dq.x, v0, acc[it][3]))));
        }
      }
    }
  }

#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int p = tid + it * THREADS;
    if (p < nitems) {
      const int g = p / DV, c = p % DV;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g * 4 + i;
        const int row = row0 + r;
        if (row < L) ob[(long long)row * os.row + c] = acc[it][i] / fmaxf(sDen[r], 1e-30f);
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Keys [0, valid_len) attend. Strides are
// in elements. The plan (kernels/encoder_attention.py::_plan): dp / dvp, D
// and DV padded to a multiple of 16, and q/k/v copy widths in bytes (bf16
// only), and the dynamic shared-memory bytes of the launch. Returns the
// cudaError_t of the launch (0 = launched).
int enc_attn_launch(int dtype, const void* q, const void* k, const void* v,
                    void* o, int B, int L, int H, int D, int DV, int valid_len,
                    long long q_batch, int q_row, int q_head,
                    long long k_batch, int k_row, int k_head,
                    long long v_batch, int v_row, int v_head,
                    long long o_batch, int o_row, int o_head, float scale,
                    int dp, int dvp, int q_width, int k_width, int v_width,
                    int smem, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || DV <= 0 || D > MAX_DIM ||
      DV > MAX_DIM || H > 65535 || B > 65535 || valid_len < 1 ||
      valid_len > L || smem <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const TcArgs a{{static_cast<const bf16*>(q), q_batch, q_row, q_head, q_width},
                   {static_cast<const bf16*>(k), k_batch, k_row, k_head, k_width},
                   {static_cast<const bf16*>(v), v_batch, v_row, v_head, v_width},
                   static_cast<bf16*>(o), o_batch, o_row, o_head,
                   L, valid_len, D, DV, dp / 16, dvp / 16, scale};
    if (!aligned(a.q) || !aligned(a.k) || !aligned(a.v) || dp % 16 || dvp % 16 || dp < D ||
        dvp < DV || dp > MAX_DIM || dvp > MAX_DIM || (size_t)smem < tc_smem_bytes(dp, dvp))
      return (int)cudaErrorInvalidValue;
    return (int)launch_bf16(a, B, H, smem, s);
  }
  if (dtype != 0 || (size_t)smem < f32_smem_bytes(L, D, DV))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      enc_attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  enc_attn_f32_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), L, valid_len, D, DV,
      Strides{q_batch, q_row, q_head}, Strides{k_batch, k_row, k_head},
      Strides{v_batch, v_row, v_head}, Strides{o_batch, o_row, o_head}, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
