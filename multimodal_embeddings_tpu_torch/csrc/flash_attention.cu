// Flash attention (online softmax over key tiles) for Hopper (sm_90a):
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h] . k[b, j, h/rep] / sqrt(Dk)) v[b, j, h/rep]
//
// over the keys j < lengths[b] (and j <= i when causal), with GQA (query head
// h reads kv head h / (H / KVH)) and independent Dk and Dv. Replaces the
// Pallas TPU kernel `_flash_kernel` of `flash_attention` in
// multimodal_embeddings_tpu/kernels/flash_attention.py and keeps its numerics
// contract, tile for tile:
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
// not HBM. The design therefore never writes the (L, L) scores anywhere:
// each block owns 64 query rows of one (batch, head), 4 warps of 16 rows;
// q stays in registers as mma.sync A fragments, each 128-key tile of K and V
// is staged in shared memory, S = Q K^T and O += P V run on mma.sync
// m16n8k16 (bf16 in, f32 accumulate), and P goes from the S accumulators to
// the PV A fragments in registers (the C and A fragment layouts line up), as
// in FlashAttention-2. Shared rows are padded to 136 bf16 so ldmatrix reads
// are free of bank conflicts. Head dims up to 128 are zero-padded to 16.
// Double-buffered tiles, TMA and wgmma are the next steps; this is the
// simple correct form.
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
// The second schedule replaces `_flash_kernel_v2` (flash_attention_v2): the
// TPU kernel runs one program per (batch, head) and walks all its query
// blocks with that head's K and V resident in VMEM. One head's K/V at the
// (2, 6432, 16, 80) shape is 2.06 MB, far past a block's 227 KB of shared
// memory, so here one block per (head, batch item) walks its query tiles in
// order through the same tile body (so the numerics are v1's, row for row)
// and re-reads the head's K/V tiles from L2 (50 MB, against 66 MB of K/V for
// all 32 heads at that shape): L2 stands in for VMEM. It is bound by the same tensor-core work as
// v1 but runs only B*H blocks (32 at that shape, on 132 SMs); a cluster per
// head holding K/V in distributed shared memory is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block: 4 warps x 16
constexpr int BKV = 128;         // keys per tile (the TPU kernel's block_k)
constexpr int DMAX = 128;        // largest head dim
constexpr int LD = DMAX + 8;     // bf16 per shared row: 272 B, ldmatrix rows on distinct banks
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_BYTES = (BQ + 2 * BKV) * LD * 2;

typedef __nv_bfloat16 bf16;

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

// rows [r0, r0 + rows) x features [0, dp) of one (batch, head) into shared
// memory, zero past row L and past feature d
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row_stride, int r0, int rows, int L,
                                          int d, int dp, bool vec, int tid) {
  const int chunks = dp / 8;
  for (int c = tid; c < rows * chunks; c += THREADS) {
    const int r = c / chunks, f = (c % chunks) * 8, gr = r0 + r;
    uint4 val;
    if (vec && gr < L && f + 8 <= d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * row_stride + f);
    } else {
      uint16_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = (gr < L && f + j < d)
                   ? __bfloat16_as_ushort(src[(size_t)gr * row_stride + f + j])
                   : (uint16_t)0;
      val = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                       e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + f) = val;
  }
}

// The bf16 parameters of one launch, shared by both schedules.
#define FLASH_BF16_PARAMS                                                       \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                     \
      const bf16 *__restrict__ v, bf16 *__restrict__ o,                       \
      const int *__restrict__ lengths, int L, int H, int KVH, int Dk, int Dv, \
      long long qsb, int qsl, int qsh, long long ksb, int ksl, int ksh,       \
      long long vsb, int vsl, int vsh, int causal, float scale, int vec
#define FLASH_BF16_ARGS                                                        \
  q, k, v, o, lengths, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb, ksl, ksh, vsb, \
      vsl, vsh, causal, scale, vec

// Query rows [q0, q0 + BQ) of head h of batch item b, with every key tile
// they attend; smem holds the Q tile and one K and one V tile.
__device__ __forceinline__ void flash_bf16_tile(unsigned char* smem_raw, int q0, int h,
                                                int b, FLASH_BF16_PARAMS) {
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + BKV * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = h / (H / KVH);
  int valid = L;
  if (lengths != nullptr) valid = min(max(lengths[b], 0), L);
  const int nkd = (Dk + 15) / 16, nvd = (Dv + 15) / 16;
  const bf16* qb = q + b * qsb + (size_t)h * qsh;
  const bf16* kb = k + b * ksb + (size_t)kvh * ksh;
  const bf16* vb = v + b * vsb + (size_t)kvh * vsh;

  load_tile(sQ, qb, qsl, q0, BQ, L, Dk, nkd * 16, vec != 0, tid);
  __syncthreads();
  uint32_t qf[DMAX / 16][4];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    if (kk < nkd)
      ldmatrix_x4(qf[kk], &sQ[(warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8]);

  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // C fragment: this thread holds rows row0 and row0 + 8, keys 2*(lane%4)+{0,1}
  const int row0 = q0 + warp * 16 + (lane >> 2);
  int ntiles = (valid + BKV - 1) / BKV;
  if (causal) ntiles = min(ntiles, (q0 + BQ - 1) / BKV + 1);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile is consumed
    load_tile(sK, kb, ksl, k0, BKV, L, Dk, nkd * 16, vec != 0, tid);
    load_tile(sV, vb, vsl, k0, BKV, L, Dv, nvd * 16, vec != 0, tid);
    __syncthreads();

    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk >= nkd) continue;
#pragma unroll
      for (int jj = 0; jj < BKV / 16; ++jj) {
        // matrices: keys jj*16 + {0-7, 0-7, 8-15, 8-15} x dims kk*16 + {0-7, 8-15, 0-7, 8-15}
        uint32_t kf[4];
        ldmatrix_x4(kf, &sK[(jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask, tile row max
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        const bool ok = key < valid && (!causal || key <= row);
        const float sc = ok ? s[j][e] * scale : NEG_INF;
        s[j][e] = sc;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], sc);
      }
    float corr[2], tsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        tsum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 1);
      tsum[r] += __shfl_xor_sync(0xffffffffu, tsum[r], 2);
      l[r] = l[r] * corr[r] + tsum[r];
    }
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // O += bf16(P) . V: the S accumulators of key tiles 2kk, 2kk+1 are the
    // A fragment of keys kk*16 .. kk*16+15
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int vj = 0; vj < DMAX / 16; ++vj) {
        if (vj >= nvd) continue;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, &sV[(kk * 16 + (lane & 15)) * LD + vj * 16 + (lane >> 4) * 8]);
        mma_bf16(acc[2 * vj], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * vj + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // epilogue: acc / max(sum, 1e-30), rows row0 and row0 + 8
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= L) continue;
    const float den = fmaxf(l[r], 1e-30f);
    bf16* out = o + (((size_t)b * L + row) * H + h) * Dv;
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j) {
      const int d = j * 8 + c2;
      if (d >= Dv) continue;
      const bf16 v0 = __float2bfloat16_rn(acc[j][2 * r] / den);
      const bf16 v1 = __float2bfloat16_rn(acc[j][2 * r + 1] / den);
      if (d + 1 < Dv && (Dv & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __halves2bfloat162(v0, v1);
      } else {
        out[d] = v0;
        if (d + 1 < Dv) out[d + 1] = v1;
      }
    }
  }
}

// flash_attention: one block per (64-row query tile, head, batch item)
__global__ void __launch_bounds__(THREADS) flash_bf16_kernel(FLASH_BF16_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  flash_bf16_tile(smem_raw, blockIdx.x * BQ, blockIdx.y, blockIdx.z, FLASH_BF16_ARGS);
}

// flash_attention_v2: one block per (head, batch item), walking its query
// tiles in order, so the head's K and V are read by one SM again and again
// and stay in L2 between the tiles (the TPU kernel keeps them in VMEM)
__global__ void __launch_bounds__(THREADS) flash_v2_bf16_kernel(FLASH_BF16_PARAMS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  for (int q0 = 0; q0 < L; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous tile's Q, K and V
    flash_bf16_tile(smem_raw, q0, blockIdx.x, blockIdx.y, FLASH_BF16_ARGS);
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

// schedule 0: flash_attention (a block per query tile, head and batch item);
// 1: flash_attention_v2 (a block per head and batch item, looping over the
// query tiles)
int launch(int schedule, int dtype, const void* q, const void* k, const void* v, void* o,
           const void* lengths, int B, int L, int H, int KVH, int Dk, int Dv,
           long long qsb, int qsl, int qsh, long long ksb, int ksl, int ksh,
           long long vsb, int vsl, int vsh, int causal, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || KVH <= 0 || H % KVH != 0 || Dk <= 0 ||
      Dv <= 0 || Dk > DMAX || Dv > DMAX || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (dtype == 1) {
    const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v)) & 15) == 0;
    const bool strides8 = ((qsb | ksb | vsb) % 8 == 0) && (qsl % 8 == 0) && (qsh % 8 == 0) &&
                          (ksl % 8 == 0) && (ksh % 8 == 0) && (vsl % 8 == 0) && (vsh % 8 == 0);
    const int vec = (aligned && strides8) ? 1 : 0;
    const auto kernel = schedule ? flash_v2_bf16_kernel : flash_bf16_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid = schedule ? dim3(H, B) : dim3((L + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lens, L, H, KVH, Dk, Dv,
        qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, causal, scale, vec);
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
// Returns the cudaError_t of the launch (0 = launched).
int flash_attn_launch(int dtype, const void* q, const void* k, const void* v,
                      void* o, const void* lengths, int B, int L, int H, int KVH,
                      int Dk, int Dv, long long qsb, int qsl, int qsh,
                      long long ksb, int ksl, int ksh, long long vsb, int vsl,
                      int vsh, int causal, float scale, void* stream) {
  return launch(0, dtype, q, k, v, o, lengths, B, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb,
                ksl, ksh, vsb, vsl, vsh, causal, scale, stream);
}

// The same contract and arguments, on the K/V-resident schedule.
int flash_attn_v2_launch(int dtype, const void* q, const void* k, const void* v,
                         void* o, const void* lengths, int B, int L, int H, int KVH,
                         int Dk, int Dv, long long qsb, int qsl, int qsh,
                         long long ksb, int ksl, int ksh, long long vsb, int vsl,
                         int vsh, int causal, float scale, void* stream) {
  return launch(1, dtype, q, k, v, o, lengths, B, L, H, KVH, Dk, Dv, qsb, qsl, qsh, ksb,
                ksl, ksh, vsb, vsl, vsh, causal, scale, stream);
}

}  // extern "C"
