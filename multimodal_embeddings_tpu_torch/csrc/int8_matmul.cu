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
// bf16 (exactly: |q| <= 127) only in shared memory, so a bf16 copy of W
// never exists in global memory.
//
// What bounds it on this card: at the text stack's M = 512 rows the product
// does 2*M*K*N flops on K*N weight bytes, about 1000 flops per weight byte,
// far above the H100's ~300 bf16 flops per HBM byte, so the tensor cores
// bound it, not the int8 stream (the cross-attention k/v at M = 12808 even
// more so). The bf16 kernel therefore runs on the tensor cores with
// mma.sync m16n8k16 (bf16 operands, f32 accumulators): 128x128 output tiles
// of 8 warps (each 64x32), K steps of 32, and a two-stage shared-memory ring
// filled from registers that were loaded one step ahead, so the next tile's
// global loads are in flight during the current tile's products. Fragments
// come from shared memory through ldmatrix (x row-major, W transposed on the
// fly with .trans); rows are padded so neither read has bank conflicts.
// wgmma and TMA would be the next step; this is the simple correct form.
//
// The f32 form is for checks only (the page program runs bf16): a CUDA-core
// tiled loop, 64x64 tiles, 4x4 outputs per thread, exact int8 -> f32 weights.
//
// Ragged M, K and N are zero-filled at the tile edges; 16-byte vector loads
// are used where the wrapper says the rows are aligned (K % 8 == 0 and
// N % 16 == 0, 16-byte base addresses) and element loads elsewhere.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// --------------------------------------------------------------------------
// bf16 x, tensor cores
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). x (M, K), q (K, N) int8 and
// y (M, N) are contiguous row-major; scale has N f32 values. vec = 1 allows
// 16-byte loads (the caller checked K % 8, N % 16 and the base alignment).
// Returns the cudaError_t of the launch (0 = launched).
int int8_matmul_launch(int dtype, const void* x, const void* q,
                       const void* scale, void* y, int M, int K, int N,
                       int vec, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    int8_mm_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, K,
        N, vec != 0);
  } else if (dtype == 0) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    int8_mm_f32_kernel<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(y), M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
