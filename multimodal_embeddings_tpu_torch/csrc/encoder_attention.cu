// Whole-row encoder self-attention for Hopper (sm_90a), one kernel for the
// three attention call sites of the page programs.
//
// Replaces the Pallas TPU kernels `_enc_attn_blf_kernel` /
// `_enc_attn_blf_scratch_kernel` (encoder_attention_blf),
// `_enc_attn_blf_packed_kernel` (encoder_attention_blf_packed) and
// `_enc_attn_kernel` (encoder_attention, and encoder_attention_padded which
// calls it) of multimodal_embeddings_tpu/kernels/encoder_attention.py. All
// compute, per (batch, head), a softmax over whole score rows whose keys are
// the prefix [0, valid_len) of the L rows:
//
//   s = (q . k) * scale              f32, keys j < valid_len
//   e = exp(s - rowmax(s))           f32
//   denom = sum(e)                   f32
//   o = (cast_T(e) @ v) / max(denom, 1e-30), accumulated in f32, cast to T
//
// Keys at or past valid_len are skipped: the TPU kernel gives them the score
// -1e30, whose e is exactly 0 in f32 once one valid key exists. Every one of
// the L rows is still a query (the Mllama vision tower carries its 7 padding
// rows through every layer). Operands are addressed through (batch, row,
// head) strides, so one kernel reads the split (B, L, H*D) q/k/v slabs of the
// ViT and of the Mllama tower as well as the packed per-head
// [q(kd) | k(kd) | v(hd)] slab of the detector's PSA block.
//
// What bounds it on this card: the arithmetic (4*L*L*D flops per head) runs
// here on CUDA cores out of shared memory, so shared-memory load bandwidth
// bounds it, not HBM (q/k/v are read once per query tile). The design keeps a
// tile of TQ query rows' f32 score rows resident in shared memory (the TPU
// kernel's whole-row VMEM buffer) and streams K and V through a small staged
// tile; register micro-tiles (4 rows per thread) and a transposed Q tile cut
// the shared-memory loads to about one per two FMAs. Loads are scalar: the
// packed k slice starts 72 bytes into each head, which is not 16-byte aligned,
// and kd = 36 / hd = 72 are not multiples of a vector width. L = 784 is not a
// multiple of the tiles; rows past L and keys past valid_len are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TQ = 16;        // query rows per block
constexpr int KT = 64;        // keys per staged K/V tile
constexpr int THREADS = 256;  // (THREADS / KT) row groups of 4 rows == TQ
constexpr int MAX_DIM = 128;  // D and DV bound: PV items per thread <= 2

static_assert((THREADS / KT) * 4 == TQ, "score micro-tiles must cover TQ");
static_assert((TQ / 4) * MAX_DIM <= 2 * THREADS, "PV items per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

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

inline size_t smem_bytes(int L, int D, int DV) {
  return sizeof(float) * ((size_t)D * TQ + (size_t)TQ * score_stride(L) +
                          (size_t)KT * kv_tile_stride(D, DV) + TQ);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    enc_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int L, int NV,
                    int D, int DV, Strides qs, Strides ks, Strides vs,
                    Strides os, float scale) {
  // NV = valid_len: keys [0, NV) take part, 1 <= NV <= L
  extern __shared__ __align__(16) float smem[];
  const int LP = score_stride(L);
  const int DP = k_stride(D);
  float* sQ = smem;                              // [D][TQ], transposed
  float* sS = sQ + D * TQ;                       // [TQ][LP] score rows
  float* sKV = sS + TQ * LP;                     // [KT][stride] K or V tile
  float* sDen = sKV + KT * kv_tile_stride(D, DV);  // [TQ] denominators

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* qb = q + b * qs.batch + (long long)h * qs.head;
  const T* kb = k + b * ks.batch + (long long)h * ks.head;
  const T* vb = v + b * vs.batch + (long long)h * vs.head;
  T* ob = o + b * os.batch + (long long)h * os.head;

  // Q tile, transposed so one thread's 4 rows are one float4; rows past L
  // are zero and never stored
  for (int p = tid; p < TQ * D; p += THREADS) {
    const int r = p / D, d = p % D;
    const int row = row0 + r;
    sQ[d * TQ + r] = row < L ? to_f32(qb[(long long)row * qs.row + d]) : 0.f;
  }

  // scores: thread owns key jj of each tile for rows rg*4 .. rg*4+3
  const int jj = tid % KT;
  const int rg = tid / KT;
  for (int j0 = 0; j0 < NV; j0 += KT) {
    __syncthreads();  // previous tile consumed (and Q stored, first pass)
    for (int p = tid; p < KT * D; p += THREADS) {
      const int j = p / D, d = p % D;
      const int key = j0 + j;
      sKV[j * DP + d] = key < NV ? to_f32(kb[(long long)key * ks.row + d]) : 0.f;
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

  // softmax numerator in place: f32 exp, f32 denominator, then the values
  // the PV product reads are rounded to the input type
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
      srow[j] = to_f32(from_f32<T>(e));
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
      sKV[j * DV + c] = key < NV ? to_f32(vb[(long long)key * vs.row + c]) : 0.f;
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
        if (row < L)
          ob[(long long)row * os.row + c] =
              from_f32<T>(acc[it][i] / fmaxf(sDen[r], 1e-30f));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int L, int NV, int H, int D, int DV, Strides qs, Strides ks,
                   Strides vs, Strides os, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, D, DV);
  cudaError_t err = cudaFuncSetAttribute(
      enc_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + TQ - 1) / TQ, H, B);
  enc_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), L, NV, D, DV, qs, ks, vs,
      os, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs; the wrapper refuses shapes past
// the card's per-block limit before launching.
long long enc_attn_smem_bytes(int L, int D, int DV) {
  return (long long)smem_bytes(L, D, DV);
}

// dtype: 0 = float32, 1 = bfloat16. Keys [0, valid_len) attend. Strides are
// in elements. Returns the cudaError_t of the launch (0 = launched).
int enc_attn_launch(int dtype, const void* q, const void* k, const void* v,
                    void* o, int B, int L, int H, int D, int DV, int valid_len,
                    long long q_batch, int q_row, int q_head,
                    long long k_batch, int k_row, int k_head,
                    long long v_batch, int v_row, int v_head,
                    long long o_batch, int o_row, int o_head, float scale,
                    void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || D <= 0 || DV <= 0 || D > MAX_DIM ||
      DV > MAX_DIM || H > 65535 || B > 65535 || valid_len < 1 ||
      valid_len > L)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_batch, q_row, q_head}, ks{k_batch, k_row, k_head},
      vs{v_batch, v_row, v_head}, os{o_batch, o_row, o_head};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k, v, o, B, L, valid_len, H, D, DV, qs, ks, vs, os,
                        scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, o, B, L, valid_len, H, D, DV, qs, ks,
                                vs, os, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
