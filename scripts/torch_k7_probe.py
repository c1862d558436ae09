#!/usr/bin/env python3
"""Where the device time of K7 goes, at the three path shapes, on the card.

    python3 scripts/torch_k7_probe.py [--baseline DIR]

Builds variants of ``multimodal_embeddings_tpu_torch/csrc/ln_stats.cu``,
each made by exact text edits of the source (the script stops if an edit's
anchor is not found exactly once) or by a kernel added to it, and runs each
through the port's own ``ln_stats``:

  kernel      the source as it is (a lane's 16-byte loads one at a time,
              programmatic launches);
  group4      a lane's 16-byte loads issued in groups of 4, a word past the
              row adding +0; group8, group16: in groups of 8 and 16;
  unrolled    all of a row's 16-byte loads a lane issued at once, the words
              per lane (3, 5 or 10 at the path shapes) a template argument;
  nopdl       launched without programmatic stream serialization: the grid
              is placed only after the previous kernel has ended;
  trigger     each CTA allows the next programmatic launch as it starts
              (``griddepcontrol.launch_dependents``), so that the next grid
              may be placed before this one's blocks have exited;
  loadonly    the loads kept, the f32 sums replaced by one integer xor a word;
  nostore     the means and rstds not written;
  blockstore  a block's 8 rows' statistics gathered in shared memory and
              written by 16 threads (two 32-byte stores a block, in place of
              16 of 4 bytes; rows of 16-byte words only, as at the path
              shapes);
  warps16     blocks of 16 warps (16 rows); warps4: of 4;
  empty       every block returns after the launch's set-up;
  empty_nopdl empty, and launched as nopdl;
  regs        the one-warp-a-row body made persistent (as many CTAs of 8
              warps as the SMs hold), each warp walking rows a grid apart, a
              row's 16-byte loads issued together and the next row loaded
              before this one is reduced; plain launches;
  bulk        the bulk-copy ring: one persistent CTA per SM walks a
              contiguous run of rows in stages of ~24 KB of whole rows, a ring
              of ~144 KB filled by one thread's 1-D ``cp.async.bulk`` copies on
              full/empty mbarriers, 8 consumer warps reducing rows from shared
              memory, the producer warp writing the statistics; plain launches;
  bulk_loadonly  bulk, the consumers releasing each stage unread;
  bulk_best   bulk with the changes that measured faster: CTA j takes the row
              blocks j, j + grid, ... (the card sweeps the array front to
              back), stages of ~40 KB, the producer's lanes computing the
              statistics from the consumers' sums, programmatic launches;
  trace       the kernel with ``%globaltimer`` read by thread 0 of each of the
              first TRACE_CTAS blocks when it is placed, when the previous
              kernel has ended (its wait returns), and when its first row's
              statistics are written.

With ``--baseline DIR`` (a checkout of another commit, such as the parent),
its ``csrc/ln_stats.cu`` is built too and timed through the same wrapper as
``baseline``, right after ``kernel`` and again after the last variant, the
two turns averaged; its launcher takes one more argument (a vector-load
flag, 1 here: every path shape allows it). Whether the kernel's outputs
equal the baseline's bit for bit is printed.

Each mode is timed three ways, as ``chip_smoke.py::k7_times`` times the
kernel: cold, the device time per call of back-to-back launches over
copies of x that together exceed the 50 MB L2 (at least 128 MB); warm,
back to back on one x; and the median of single launches from an idle
card (the wrapper's host time included). ``torch.var_mean`` is timed the
same ways. The trace is read for the last launch of a cold run: how many
blocks were placed before the previous kernel ended, and from the first
block's release to the last row done (the launch's span), against the
device time per call. The outputs of ``loadonly``, ``nostore``, ``empty``,
``empty_nopdl`` and ``bulk_loadonly`` are wrong by design and are not
checked; the others are held to the plain version within
``chip_smoke.py``'s ``K7_RTOL`` before and after their timed runs. Needs
one card and ``nvcc``; the variants are built beside the package's own
libraries.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (shape, dtype) and launches per kernel-route ViT page or tower chunk
# (chip_smoke.py's K7_SHAPES)
SHAPES = {
    "vit final_ln (48,784,768) bf16": (((48, 784, 768), "bfloat16"), 1),
    "mllama local (8,1608,1280) bf16": (((8, 1608, 1280), "bfloat16"), 49),
    "mllama global (8,1608,1280) f32": (((8, 1608, 1280), "float32"), 0),
}
MODES = ("kernel", "group4", "group8", "group16", "unrolled", "nopdl", "trigger", "loadonly",
         "nostore", "blockstore", "warps16", "warps4", "empty", "empty_nopdl", "regs", "bulk",
         "bulk_loadonly", "bulk_best", "trace")
UNCHECKED = ("loadonly", "nostore", "empty", "empty_nopdl", "bulk_loadonly")
K7_RTOL = 1e-5
TRACE_CTAS = 8192

_VEC = ("    for (int k = lane * PER; k < D; k += 32 * PER)\n"
        "      add8(s, s2, *reinterpret_cast<const uint4*>(row + k), row);\n")
# a lane's 16-byte loads in groups of G, issued together
_GROUPED = """    const uint4* w = reinterpret_cast<const uint4*>(row);
    const int words = D / PER;
    for (int k = lane; k < words; k += 32 * G) {
      uint4 v[G];
#pragma unroll
      for (int g = 0; g < G; ++g)  // words past the row add +0 to both sums
        v[g] = k + 32 * g < words ? w[k + 32 * g] : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int g = 0; g < G; ++g) add8(s, s2, v[g], row);
    }
"""
_ATTRS = "  cfg.numAttrs = 1;\n"
_WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
_STORES = "    mean[r] = m;\n    rstd[r] = 1.f / sqrtf(__fadd_rn(var, eps));\n  }\n"
_ROW_EXIT = "  if (r >= rows) return;\n  const T* row"
_GRID_WAIT = "  grid_dependency();\n"
# the block's statistics gathered in shared memory, 16 threads writing them
_BLOCK_STORES = """    block_stats[threadIdx.x >> 5] = make_float3(m, 1.f / sqrtf(__fadd_rn(var, eps)),
                                                r < rows ? 1.f : 0.f);
  }
  __syncthreads();
  const int t = threadIdx.x, w = t % ROWS;
  if (t < 2 * ROWS && block_stats[w].z != 0.f)
    (t < ROWS ? mean : rstd)[(long long)blockIdx.x * ROWS + w] =
        t < ROWS ? block_stats[w].x : block_stats[w].y;
"""
_THREADS = "constexpr int THREADS = 256,"
_DEPENDENCY = "// nothing is read or written before the previous kernel in the stream has"
_LAUNCH = "int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd, long long rows,"

# regs: persistent warps, all of a row's loads at once, the next row's
# loads issued before this row is reduced
_REGS = r"""
namespace {

template <typename T, int NW>
__global__ void __launch_bounds__(256)
    ln_stats_regs_kernel(const T* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ rstd, long long rows, int D, float eps) {
  const int lane = threadIdx.x & 31, words = D * (int)sizeof(T) / 16;
  const long long stride = (long long)gridDim.x * 8;
  long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  uint4 cur[NW], nxt[NW];
  auto load = [&](uint4(&v)[NW], long long row) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const int w = lane + 32 * k;
      v[k] = row < rows && w < words ? __ldg(reinterpret_cast<const uint4*>(x + row * D) + w)
                                     : make_uint4(0, 0, 0, 0);
    }
  };
  load(cur, r);
  for (; r < rows; r += stride) {
    load(nxt, r + stride);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NW; ++k) add8(s, s2, cur[k], x);
    s = warp_sum(s);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float m = __fdiv_rn(s, (float)D), m2 = __fdiv_rn(s2, (float)D);
      const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.f);
      mean[r] = m;
      rstd[r] = 1.f / sqrtf(__fadd_rn(var, eps));
    }
#pragma unroll
    for (int k = 0; k < NW; ++k) cur[k] = nxt[k];
  }
}

template <typename T, int NW>
int regs_launch(const void* x, float* m, float* rs, long long rows, int D, float eps,
                cudaStream_t s) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ln_stats_regs_kernel<T, NW>, 256, 0);
  if (e != cudaSuccess) return (int)e;
  long long grid = (long long)sms * per_sm, need = (rows + 7) / 8;
  ln_stats_regs_kernel<T, NW><<<(unsigned)(grid < need ? grid : need), 256, 0, s>>>(
      static_cast<const T*>(x), m, rs, rows, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd,
                               long long rows, int D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const int nw = (D * (dtype == 1 ? 2 : 4) / 16 + 31) / 32;
  if ((D * (dtype == 1 ? 2 : 4)) % 16 || (uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && nw == 3) return regs_launch<__nv_bfloat16, 3>(x, m, rs, rows, D, eps, s);
  if (dtype == 1 && nw == 5) return regs_launch<__nv_bfloat16, 5>(x, m, rs, rows, D, eps, s);
  if (dtype == 0 && nw == 10) return regs_launch<float, 10>(x, m, rs, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
"""

# unrolled: all of a row's loads a lane issued at once, programmatic launches
_UNROLLED = r"""
namespace {

template <typename T, int NW>
__global__ void __launch_bounds__(256)
    ln_stats_unrolled_kernel(const T* __restrict__ x, float* __restrict__ mean,
                             float* __restrict__ rstd, long long rows, int D, float eps) {
  grid_dependency();
  const int lane = threadIdx.x & 31, words = D * (int)sizeof(T) / 16;
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const uint4* row = reinterpret_cast<const uint4*>(x + r * D);
  uint4 v[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k)  // words past the row add +0 to both sums
    v[k] = lane + 32 * k < words ? row[lane + 32 * k] : make_uint4(0, 0, 0, 0);
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NW; ++k) add8(s, s2, v[k], x);
  s = warp_sum(s);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float m = __fdiv_rn(s, (float)D), m2 = __fdiv_rn(s2, (float)D);
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.f);
    mean[r] = m;
    rstd[r] = 1.f / sqrtf(__fadd_rn(var, eps));
  }
}

template <typename T, int NW>
int unrolled_launch(const void* x, float* m, float* rs, long long rows, int D, float eps,
                    cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + 7) / 8));
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, ln_stats_unrolled_kernel<T, NW>,
                                           static_cast<const T*>(x), m, rs, rows, D, eps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd,
                               long long rows, int D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  const int nw = (D * (dtype == 1 ? 2 : 4) / 16 + 31) / 32;
  if ((D * (dtype == 1 ? 2 : 4)) % 16 || (uintptr_t)x % 16) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && nw == 3) return unrolled_launch<__nv_bfloat16, 3>(x, m, rs, rows, D, eps, s);
  if (dtype == 1 && nw == 5) return unrolled_launch<__nv_bfloat16, 5>(x, m, rs, rows, D, eps, s);
  if (dtype == 0 && nw == 10) return unrolled_launch<float, 10>(x, m, rs, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
"""

# bulk: the bulk-copy ring; the K7B_ switches are set by the variant
_BULK = r"""
namespace {

constexpr bool K7B_INTERLEAVE = false, K7B_FASTCONS = false, K7B_PDL = false;
constexpr bool K7B_LOADONLY = false;
constexpr long long K7B_STAGE = 24576, K7B_RING = 147456;
constexpr int BULK_WARPS = 8, BULK_THREADS = (BULK_WARPS + 1) * 32;

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}

// a wait of more than ~10 s (a barrier that can never complete) traps
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ float2 row_stats(float s, float s2, int D, float eps) {
  const float m = __fdiv_rn(s, (float)D), m2 = __fdiv_rn(s2, (float)D);
  const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m, m)), 0.f);
  return make_float2(m, 1.f / sqrtf(__fadd_rn(var, eps)));
}

// shared memory: S stages of R rows, per stage R and R floats (the rows'
// statistics, or with K7B_FASTCONS their two sums), the S full and S empty
// barriers
template <typename T>
__global__ void __launch_bounds__(BULK_THREADS, 1)
    ln_stats_bulk_kernel(const T* __restrict__ x, float* __restrict__ mean,
                         float* __restrict__ rstd, long long rows, int D, int R, int S,
                         float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int row_bytes = D * (int)sizeof(T), stage_bytes = R * row_bytes;
  float* out = reinterpret_cast<float*>(smem + (size_t)S * stage_bytes);
  const uint32_t stage0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t full0 = (uint32_t)__cvta_generic_to_shared(out + 2 * S * R);
  const uint32_t empty0 = full0 + 8 * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this CTA's row blocks: a contiguous run (runs differ by at most a row),
  // or with K7B_INTERLEAVE the blocks j, j + grid, ... of the array
  const long long base = rows / gridDim.x, rem = rows % gridDim.x;
  const long long r0 = blockIdx.x * base + min((long long)blockIdx.x, rem);
  const int n = (int)(base + (blockIdx.x < rem ? 1 : 0));
  const long long nblocks = (rows + R - 1) / R;
  const int nb = K7B_INTERLEAVE ? (int)((nblocks - blockIdx.x + gridDim.x - 1) / gridDim.x)
                                : (n + R - 1) / R;
  auto first = [&](int i) {
    return K7B_INTERLEAVE ? ((long long)blockIdx.x + (long long)i * gridDim.x) * R
                          : r0 + (long long)i * R;
  };
  auto count = [&](int i) {
    return (int)min((long long)R, (K7B_INTERLEAVE ? rows : r0 + n) - first(i));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full0 + 8 * s, 1);
      bar_init(empty0 + 8 * s, BULK_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (K7B_PDL) {
    asm volatile("griddepcontrol.launch_dependents;");
    asm volatile("griddepcontrol.wait;" ::: "memory");
  }
  if (warp == BULK_WARPS) {
    // the producer: block i - S's statistics out once it has left stage
    // i % S, then block i into that stage
    for (int i = 0; i < nb + S; ++i) {
      const int j = i - S, s = i % S;
      if (j >= 0) {
        bar_wait(empty0 + 8 * s, (j / S) & 1);
        const int nj = count(j);
        if (K7B_FASTCONS) {
          for (int t = lane; t < nj; t += 32) {
            const float2 ms = row_stats(out[2 * s * R + t], out[(2 * s + 1) * R + t], D, eps);
            mean[first(j) + t] = ms.x;
            rstd[first(j) + t] = ms.y;
          }
        } else {
          for (int t = lane; t < 2 * nj; t += 32) {
            const bool m = t < nj;
            (m ? mean : rstd)[first(j) + (m ? t : t - nj)] =
                out[2 * s * R + (m ? t : R + t - nj)];
          }
        }
        __syncwarp();
      }
      if (i < nb && lane == 0) {
        const uint32_t bytes = (uint32_t)(count(i) * row_bytes);
        bar_arrive_tx(full0 + 8 * s, bytes);
        bulk_load(stage0 + s * stage_bytes, x + first(i) * D, bytes, full0 + 8 * s);
      }
    }
    return;
  }
  // the consumers: warp w takes rows w, w + 8, ... of each stage
  const int words = row_bytes / 16;
  for (int i = 0; i < nb; ++i) {
    const int s = i % S, ni = count(i);
    bar_wait(full0 + 8 * s, (i / S) & 1);
    for (int rr = warp; rr < (K7B_LOADONLY ? 0 : ni); rr += BULK_WARPS) {
      const uint4* row =
          reinterpret_cast<const uint4*>(smem + (size_t)s * stage_bytes + rr * row_bytes);
      float sum = 0.f, sum2 = 0.f;
#pragma unroll 4
      for (int k = lane; k < words; k += 32) add8(sum, sum2, row[k], x);
      sum = warp_sum(sum);
      sum2 = warp_sum(sum2);
      if (lane == 0) {
        const float2 ms = K7B_FASTCONS ? make_float2(sum, sum2) : row_stats(sum, sum2, D, eps);
        out[2 * s * R + rr] = ms.x;
        out[(2 * s + 1) * R + rr] = ms.y;
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(empty0 + 8 * s);
  }
}

// a stage of K7B_STAGE bytes of whole rows (1 to 32), a ring of K7B_RING
// bytes (2 to 8 stages), one CTA per SM, never more than row blocks
template <typename T>
int bulk_launch(const void* x, float* mean, float* rstd, long long rows, int D, float eps,
                cudaStream_t stream) {
  const long long row_bytes = (long long)D * sizeof(T);
  if (row_bytes % 16 || (uintptr_t)x % 16 || row_bytes > 40960) return (int)cudaErrorInvalidValue;
  int sms = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long r = K7B_STAGE / row_bytes;
  r = r < 1 ? 1 : (r > 32 ? 32 : r);
  long long grid = (rows + r - 1) / r;
  if (grid > sms) grid = sms;
  if (r > (rows + grid - 1) / grid) r = (rows + grid - 1) / grid;
  long long stages = K7B_RING / (r * row_bytes);
  stages = stages < 2 ? 2 : (stages > 8 ? 8 : stages);
  const long long smem = stages * (r * row_bytes + 8 * r + 16);
  static bool attr_set = false;
  if (!attr_set) {
    e = cudaFuncSetAttribute(ln_stats_bulk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(BULK_THREADS);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = K7B_PDL ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, ln_stats_bulk_kernel<T>, static_cast<const T*>(x), mean, rstd,
                         rows, D, (int)r, (int)stages, eps);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" int ln_stats_launch(int dtype, const void* x, void* mean, void* rstd,
                               long long rows, int D, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bulk_launch<__nv_bfloat16>(x, (float*)mean, (float*)rstd, rows, D, eps, s);
  if (dtype == 0) return bulk_launch<float>(x, (float*)mean, (float*)rstd, rows, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
"""
_BULK_SWITCHES = ("constexpr bool K7B_INTERLEAVE = false, K7B_FASTCONS = false, K7B_PDL = false;\n"
                  "constexpr bool K7B_LOADONLY = false;\n"
                  "constexpr long long K7B_STAGE = 24576, K7B_RING = 147456;\n")

_TRACE_DEFS = f"""__device__ unsigned long long k7_trace[{TRACE_CTAS} * 3];
__device__ __forceinline__ unsigned long long k7_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}

"""
_TRACE_READ = f"""
extern "C" int k7_trace_read(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, k7_trace, sizeof(k7_trace));
}}
"""
_TRACE_EDITS = (
    (_WAIT, f"  const bool tr = threadIdx.x == 0 && blockIdx.x < {TRACE_CTAS};\n"
            "  if (tr) k7_trace[blockIdx.x * 3] = k7_now();\n" + _WAIT
            + "  if (tr) k7_trace[blockIdx.x * 3 + 1] = k7_now();\n"),
    (_STORES, _STORES.replace("  }\n", f"    if (threadIdx.x == 0 && blockIdx.x < {TRACE_CTAS}) "
                                        "k7_trace[blockIdx.x * 3 + 2] = k7_now();\n  }\n")),
)


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once:\n{old}")
    return src.replace(old, new)


def variant_source(src: str, mode: str) -> str:
    """The source of one variant (``MODES``)."""
    if mode.startswith("group"):  # a lane's loads in groups of 4, 8 or 16
        return _edit(src, _VEC, f"    constexpr int G = {int(mode[5:])};\n" + _GROUPED)
    if mode == "unrolled":
        return _edit(src, _LAUNCH, _LAUNCH.replace("ln_stats_launch", "ln_stats_launch_rows")
                     ) + _UNROLLED
    if mode == "nopdl":
        return _edit(src, _ATTRS, "  cfg.numAttrs = 0;\n")
    if mode == "trigger":
        return _edit(src, _WAIT, '  asm volatile("griddepcontrol.launch_dependents;");\n' + _WAIT)
    if mode == "loadonly":
        return _edit(src, _VEC, _VEC.replace(
            "add8(s, s2, *reinterpret_cast<const uint4*>(row + k), row);",
            "{\n        const uint4 u = *reinterpret_cast<const uint4*>(row + k);\n"
            "        s += __uint_as_float((u.x ^ u.y ^ u.z ^ u.w) & 1u);\n      }"))
    if mode == "nostore":
        return _edit(src, _STORES, "    if (m == -1.f && var == -1.f) mean[r] = m;\n  }\n")
    if mode == "blockstore":  # rows of 16-byte words only (every path shape)
        src = _edit(src, _ROW_EXIT, "  const T* row")
        src = _edit(src, _VEC, _VEC.replace("k < D;", "r < rows && k < D;"))
        src = _edit(src, _GRID_WAIT, _GRID_WAIT + "  __shared__ float3 block_stats[ROWS];\n")
        return _edit(src, _STORES, _BLOCK_STORES)
    if mode.startswith("warps"):  # blocks of 16 or 4 warps
        return _edit(src, _THREADS, f"constexpr int THREADS = {32 * int(mode[5:])},")
    if mode == "empty":
        return _edit(src, _ROW_EXIT, _ROW_EXIT.replace("r >= rows", "r >= 0"))
    if mode == "empty_nopdl":
        return variant_source(variant_source(src, "empty"), "nopdl")
    if mode == "regs":
        return _edit(src, _LAUNCH, _LAUNCH.replace("ln_stats_launch", "ln_stats_launch_rows")
                     ) + _REGS
    if mode.startswith("bulk"):
        switches = {
            "bulk": _BULK_SWITCHES,
            "bulk_loadonly": _BULK_SWITCHES.replace("K7B_LOADONLY = false", "K7B_LOADONLY = true"),
            "bulk_best": _BULK_SWITCHES.replace("false, K7B_FASTCONS = false, K7B_PDL = false",
                                                "true, K7B_FASTCONS = true, K7B_PDL = true"
                                                ).replace("24576", "40960"),
        }[mode]
        return _edit(src, _LAUNCH, _LAUNCH.replace("ln_stats_launch", "ln_stats_launch_rows")
                     ) + _edit(_BULK, _BULK_SWITCHES, switches)
    if mode == "trace":
        src = _edit(src, _DEPENDENCY, _TRACE_DEFS + _DEPENDENCY)
        for old, new in _TRACE_EDITS:
            src = _edit(src, old, new)
        return src + _TRACE_READ
    return src


def build_variants(baseline):
    """Each variant's library (and the baseline's, from the checkout at
    ``baseline`` where given), built by one nvcc per source, all at once."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "ln_stats.cu").read_text()
    out = _build.build_dir() / "k7_probe"
    out.mkdir(parents=True, exist_ok=True)
    sources = {mode: variant_source(src, mode) for mode in MODES}
    if baseline:
        sources["baseline"] = (Path(baseline) / "multimodal_embeddings_tpu_torch" / "csrc"
                               / "ln_stats.cu").read_text()
    procs = {}
    t0 = time.perf_counter()
    for mode, text in sources.items():
        cu = out / f"ln_stats_{mode}.cu"
        cu.write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[mode] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for mode, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {mode}:\n{log}")
        if mode in ("kernel", "group8", "unrolled", "regs", "bulk", "bulk_best", "baseline"):
            report = []
            for block in log.split("Compiling entry function '")[1:]:
                name = block.split("'", 1)[0]
                kind = next((k for k in ("regs", "bulk", "unrolled")
                             if f"ln_stats_{k}_kernel" in name), "ln_stats")
                regs = [ln.split(":", 1)[-1].strip() for ln in block.splitlines()
                        if "registers" in ln or "spill" in ln]
                report.append(f"{kind} {name.split('I', 1)[-1][:24]}: {'; '.join(regs)[:100]}")
            print(f"built {mode}:\n  " + "\n  ".join(report))
        lib = ctypes.CDLL(str(out / f"ln_stats_{mode}.so"))
        lib.ln_stats_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float]
            + ([ctypes.c_int] if mode == "baseline" else []) + [ctypes.c_void_p])
        lib.ln_stats_launch.restype = ctypes.c_int
        if mode == "trace":
            lib.k7_trace_read.argtypes = [ctypes.c_void_p]
            lib.k7_trace_read.restype = ctypes.c_int
        libs[mode] = lib if mode != "baseline" else _Baseline(lib)
    print(f"nvcc, {len(sources)} sources together: {time.perf_counter() - t0:.1f} s")
    return libs


class _Baseline:
    """The parent's library behind the port's call: its launcher takes a
    vector-load flag before the stream."""

    def __init__(self, lib):
        self.lib = lib

    def ln_stats_launch(self, *args):
        return self.lib.ln_stats_launch(*args[:-1], 1, args[-1])


def device_ms(calls, reps: int = 5) -> float:
    """Device time per call of ``calls`` run back to back, the card asleep
    while the host enqueues them (as ``chip_smoke.py::device_ms``)."""
    import torch

    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for call in calls:
        call()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(int((2 * host + 1e-3) * 2e9))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median of single launches from an idle card, host time included (as
    ``chip_smoke.py::median_ms``)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_stats(lib, grid: int) -> dict:
    """From the last traced launch (µs, from the first block's release): the
    blocks placed before the previous kernel ended, the median wait of a
    block from its placing to its release, and the launch's span (the first
    release to the last row done)."""
    import numpy as np

    buf = (ctypes.c_ulonglong * (TRACE_CTAS * 3))()
    err = lib.k7_trace_read(buf)
    if err != 0:
        raise RuntimeError(f"k7_trace_read: cudaError {err}")
    n = min(grid, TRACE_CTAS)
    t = np.frombuffer(buf, dtype=np.uint64).astype(np.float64).reshape(TRACE_CTAS, 3)[:n]
    t = (t - t[:, 1].min()) / 1e3
    return {"placed_early": int((t[:, 0] < 0).sum()), "blocks": n,
            "wait": float(np.median(t[:, 1] - t[:, 0])), "span": float(t[:, 2].max())}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe runs on the card", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import ln_stats as k7

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    baseline = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    libs = build_variants(baseline)
    order = MODES[:1] + ("baseline",) + MODES[1:-1] + ("baseline",) if baseline else MODES[:-1]
    saved = k7._lib
    gen = torch.Generator(device="cuda").manual_seed(4)
    totals = {}
    try:
        for label, ((shape, dtype), count) in SHAPES.items():
            x = (torch.randn(shape, generator=gen, device="cuda") * 1.3 + 0.2).to(
                getattr(torch, dtype))
            copies = [x] + [x.clone() for _ in range(
                -(-128 * 2**20 // (x.numel() * x.element_size())) - 1)]
            reps = max(1, 48 // len(copies))
            want_m, want_r = k7.ln_stats_reference(x, 1e-6)
            rms = x.float().pow(2).mean(-1, keepdim=True).sqrt()
            cold, warm, single, bits = {}, {}, {}, {}

            def check(mode):
                if mode in UNCHECKED:
                    return
                m, r = k7.ln_stats(x, 1e-6)
                torch.cuda.synchronize()
                bad = max(((m - want_m).abs() / (K7_RTOL * rms)).max().item(),
                          ((r - want_r).abs() / (K7_RTOL * want_r)).max().item())
                if not bad <= 1.0:
                    raise SystemExit(f"{label} {mode}: error {bad:.3g}x its bound")

            for mode in order + ("trace",):
                lib = libs[mode]
                k7._lib = lambda lib=lib: lib
                check(mode)
                if mode in ("kernel", "baseline"):
                    bits[mode] = k7.ln_stats(x, 1e-6)
                calls = [lambda c=c: k7.ln_stats(c, 1e-6) for c in copies] * reps
                if mode == "trace":
                    device_ms(calls, reps=1)
                    torch.cuda.synchronize()
                    traced = trace_stats(lib, -(-math.prod(shape[:2]) // 8))
                    continue
                ms = device_ms(calls)
                wms = device_ms([lambda: k7.ln_stats(x, 1e-6)] * 48)
                med = median_ms(lambda: k7.ln_stats(x, 1e-6))
                check(mode)  # again, after hundreds of launches
                # the baseline's two turns averaged
                cold[mode] = (cold[mode] + ms) / 2 if mode in cold else ms
                warm[mode] = (warm[mode] + wms) / 2 if mode in warm else wms
                single[mode] = (single[mode] + med) / 2 if mode in single else med
            k7._lib = saved
            same = baseline and all(torch.equal(a, b) for a, b in zip(bits["kernel"],
                                                                      bits["baseline"]))

            def var_mean(t):
                return torch.var_mean(t, dim=-1, keepdim=True, correction=0)

            cold["torch.var_mean"] = device_ms([lambda c=c: var_mean(c) for c in copies] * reps)
            warm["torch.var_mean"] = device_ms([lambda: var_mean(x)] * 48)
            single["torch.var_mean"] = median_ms(lambda: var_mean(x))
            nbytes = x.numel() * x.element_size() + 8 * math.prod(shape[:2])
            bound = nbytes / 3.35e12 * 1e3
            print(f"{label} [{-(-math.prod(shape[:2]) // 8)} blocks, {len(copies)} copies"
                  + ((", bits EQUAL to" if same else ", bits differ from") + " the baseline"
                     if baseline else "")
                  + f"], bound {bound:.4f} ms (bytes): "
                  + "; ".join(f"{mode} {cold[mode]:.4f} ({100 * bound / cold[mode]:.0f}%, "
                              f"{nbytes / cold[mode] / 1e9:.2f} TB/s) warm {warm[mode]:.4f} "
                              f"single {single[mode]:.4f}"
                              for mode in cold)
                  + "; trace (us) " + ", ".join(f"{k} {v:.2f}" if isinstance(v, float)
                                                 else f"{k} {v}" for k, v in traced.items()),
                  flush=True)
            for mode, ms in cold.items():
                totals.setdefault(mode, {})[label] = (ms * count, warm[mode] * count)
            del x, copies, want_m, want_r, rms
            torch.cuda.empty_cache()
    finally:
        k7._lib = saved
    for mode, by in totals.items():
        chunk = by["mllama local (8,1608,1280) bf16"]
        print(f"{mode}: {chunk[0]:.3f} ms cold, {chunk[1]:.3f} warm per tower chunk "
              "(49 launches at the Mllama bf16 shape)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
