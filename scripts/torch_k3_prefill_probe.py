#!/usr/bin/env python3
"""Where the device time of K3's prefill (wgmma) form goes, at the four
Qwen2.5-VL-32B prefill shapes (M = 1535), on the card.

    python3 scripts/torch_k3_prefill_probe.py

Builds variants of ``multimodal_embeddings_tpu_torch/csrc/int4_matmul.cu``,
each made by exact text edits of the source (the script stops if an edit's
anchor is not found exactly once), and runs each through the port's own
``int4_matmul``:

  kernel     the source as it is;
  nodequant  the consumers' A fragments set to a constant: no packed loads,
             no nibble conversion (TMA, products, folds kept);
  nofold     the ``acc += part * scale`` fold cut to one of its 64 FMAs
             (which keeps the products live);
  nomma      no ``wgmma`` products (barriers, dequantisation, folds kept);
  loadonly   all three: the consumers only wait for each stage and release
             it (TMA, barriers, the tile walk and the stores kept);
  stages3,   the TMA ring cut from as many stages as fit (5 at G = 128) to
  stages4    3 or 4;
  cluster1,  clusters of 1 or 4 CTAs (adjacent N tiles sharing each x tile
  cluster4   by multicast) in place of the kernel's 2;
  trace      the kernel with thread 0 of each consumer warpgroup of the first
             TRACE_CTAS CTAs reading ``clock64`` at each step of its first
             TRACE_CHUNKS chunks: chunk start, products issued, next
             chunk's stage landed, its A dequantised, products done, fold
             done; and ``%globaltimer``
             with ``clock64`` at its start and end, for the SM clock.

The trace is read for the last launch of a run at gate,up and down: the
medians over the traced chunks (the first 8 left out) of each step in SM
cycles, the period per chunk, and the offset between the two warpgroups'
"products done" (about one warpgroup's products when they run one after
the other, near 0 when they run together).

Times are device times per launch of back-to-back launches (the card asleep
while the host enqueues them, as ``chip_smoke.py::device_ms``). The
per-prefill line weights each shape by its launches in one prefill (q,o,
k,v, gate,up 128 each, down 64). The outputs of the variants other than
``kernel`` are wrong by design and are not checked. Needs one card and
``nvcc``; the variants are built beside the package's own libraries.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

M = 1535
# (K, N, n_groups, launches per layer); a prefill runs 64 layers
SHAPES = {
    "q,o": (5120, 5120, 40, 2), "k,v": (5120, 1024, 40, 2),
    "gate,up": (5120, 27648, 40, 2), "down": (27648, 5120, 216, 1),
}
MODES = ("kernel", "nodequant", "nofold", "nomma", "loadonly", "stages3", "stages4",
         "cluster1", "cluster4", "trace")
TIMED = MODES[:-1]
TRACE_CTAS, TRACE_CHUNKS = 4, 128

_DEQUANT = ("  constexpr int LOW = KS / 2;\n#pragma unroll\n"
            "  for (int h = 0; h < LOW / 2; ++h) {")
_CONST_A = ("#pragma unroll\n  for (int j = 0; j < KS; ++j)\n"
            "    a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0x3F803F80u ^ pt;\n  return;\n")
_FOLD = ("__device__ __forceinline__ void fold(float (&acc)[64], const float (&part)[64], "
         "float2 sc) {\n")
_MMA = "      wgmma_rs_n128(part, cur[j],"
_STAGES = "    int s = 8;\n    while (fit(s) > SMEM_LIMIT) --s;\n"


_KERNEL = ("template <int KC, typename OutT>\n__global__ void __launch_bounds__(WG_THREADS, 1)\n"
           "    int4_mm_wgmma_kernel(")
_TRACE_DEFS = f'''__device__ unsigned long long k3_trace[{TRACE_CTAS} * 2 * {TRACE_CHUNKS} * 8];
__device__ unsigned long long k3_meta[{TRACE_CTAS} * 2 * 4];
__device__ __forceinline__ unsigned long long k3_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define K3_STAMP(k) \\
  if (tr && it < {TRACE_CHUNKS}) \\
    k3_trace[((blockIdx.x * 2 + g) * {TRACE_CHUNKS} + it) * 8 + (k)] = clock64();

'''
_TRACE_READ = '''
extern "C" int k3_trace_read(unsigned long long* trace, unsigned long long* meta) {
  cudaError_t e = cudaMemcpyFromSymbol(trace, k3_trace, sizeof(k3_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(meta, k3_meta, sizeof(k3_meta));
  return (int)e;
}
'''
_TRACE_EDITS = (
    ("  dequant_chunk<KS>(a0, p_tile(0), lane_off);\n",
     f"  const bool tr = tid == 0 && blockIdx.x < {TRACE_CTAS};\n  int it = 0;\n"
     "  if (tr) k3_meta[(blockIdx.x * 2 + g) * 4] = k3_now(), "
     "k3_meta[(blockIdx.x * 2 + g) * 4 + 1] = clock64();\n"
     "  dequant_chunk<KS>(a0, p_tile(0), lane_off);\n"),
    ("    const bool last = sub == p.cpg - 1;  // the group's last chunk: fold after it\n",
     "    K3_STAMP(0)\n    const bool last = sub == p.cpg - 1;\n"),
    ("    wgmma_commit();\n    const float2 sc", "    wgmma_commit();\n    K3_STAMP(2)\n"
     "    const float2 sc"),
    ("      bar_wait(full_bar(s), ph);\n      dequant_chunk<KS>(nxt, p_tile(s), lane_off);\n    }\n",
     "      bar_wait(full_bar(s), ph);\n      K3_STAMP(6)\n"
     "      dequant_chunk<KS>(nxt, p_tile(s), lane_off);\n    }\n    K3_STAMP(3)\n"),
    ("    wgmma_wait0();\n    fence_regs(part);\n",
     "    wgmma_wait0();\n    fence_regs(part);\n    K3_STAMP(4)\n"),
    ("    if (last) fold(acc, part, sc);\n",
     "    if (last) fold(acc, part, sc);\n    K3_STAMP(5)\n    ++it;\n"),
    ("  while (chunk(a0, a1) && chunk(a1, a0)) {\n  }\n",
     "  while (chunk(a0, a1) && chunk(a1, a0)) {\n  }\n"
     "  if (tr) k3_meta[(blockIdx.x * 2 + g) * 4 + 2] = k3_now(), "
     "k3_meta[(blockIdx.x * 2 + g) * 4 + 3] = clock64();\n"),
)
# (name, from stamp, to stamp)
STEPS = (("issue", 0, 2), ("landed", 2, 6), ("dequant", 6, 3), ("products", 3, 4),
         ("fold", 4, 5))


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once:\n{old}")
    return src.replace(old, new)


def variant_source(src: str, mode: str) -> str:
    """The source of one variant (``MODES``)."""
    if mode == "nodequant":
        return _edit(src, _DEQUANT, _CONST_A + _DEQUANT)
    if mode == "nofold":
        return _edit(src, _FOLD, _FOLD + "  acc[0] = fmaf(part[0], sc.x, acc[0]);\n  return;\n")
    if mode == "nomma":
        return _edit(src, _MMA, "      if (false) wgmma_rs_n128(part, cur[j],")
    if mode == "loadonly":
        for part in ("nodequant", "nofold", "nomma"):
            src = variant_source(src, part)
        return src
    if mode == "trace":
        src = _edit(src, _KERNEL, _TRACE_DEFS + _KERNEL)
        for old, new in _TRACE_EDITS:
            src = _edit(src, old, new)
        return src + _TRACE_READ
    if mode.startswith("cluster"):
        return _edit(src, "constexpr int WC = 2;", f"constexpr int WC = {mode[-1]};")
    if mode.startswith("stages"):
        return _edit(src, _STAGES, f"    int s = {mode[-1]};\n")
    return src


def build_variants():
    """Each variant's library, built by one nvcc per variant, all at once."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "int4_matmul.cu").read_text()
    out = _build.build_dir() / "k3_prefill_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for mode in MODES:
        cu = out / f"int4_matmul_{mode}.cu"
        cu.write_text(variant_source(src, mode))
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[mode] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for mode, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {mode}:\n{log}")
        spills = sorted({ln.strip() for ln in log.splitlines() if "spill" in ln})
        print(f"built {mode}: {' | '.join(spills)}")
        lib = ctypes.CDLL(str(out / f"int4_matmul_{mode}.so"))
        lib.int4_matmul_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
        lib.int4_matmul_launch.restype = ctypes.c_int
        lib.int4_wgmma_resident_ctas.argtypes = [ctypes.c_int] * 2
        lib.int4_wgmma_resident_ctas.restype = ctypes.c_int
        lib.int4_wgmma_cluster.argtypes = []
        lib.int4_wgmma_cluster.restype = ctypes.c_int
        if mode == "trace":
            lib.k3_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.k3_trace_read.restype = ctypes.c_int
        libs[mode] = lib
    print(f"nvcc, {len(MODES)} variants together: {time.perf_counter() - t0:.1f} s")
    return libs


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


def trace_stats(lib) -> dict:
    """Medians (SM cycles) of each step over the traced CTAs, warpgroups
    and chunks 8 .., the period per chunk, the warpgroups' offset at
    "products done", and the SM clock (cycles over ``%globaltimer`` ns)."""
    import numpy as np

    trace = (ctypes.c_ulonglong * (TRACE_CTAS * 2 * TRACE_CHUNKS * 8))()
    meta = (ctypes.c_ulonglong * (TRACE_CTAS * 2 * 4))()
    err = lib.k3_trace_read(trace, meta)
    if err != 0:
        raise RuntimeError(f"k3_trace_read: cudaError {err}")
    t = np.frombuffer(trace, dtype=np.uint64).astype(np.float64)
    t = t.reshape(TRACE_CTAS, 2, TRACE_CHUNKS, 8)[:, :, 8:]
    m = np.frombuffer(meta, dtype=np.uint64).astype(np.float64).reshape(TRACE_CTAS * 2, 4)
    out = {name: float(np.median(t[..., b] - t[..., a])) for name, a, b in STEPS}
    out["period"] = float(np.median(np.diff(t[..., 0], axis=-1)))
    out["wg_offset"] = float(np.median(t[:, 1, :, 4] - t[:, 0, :, 4]))
    out["ghz"] = float(np.median((m[:, 3] - m[:, 1]) / (m[:, 2] - m[:, 0])))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe runs on the card", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import quantization_int4 as k3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    libs = build_variants()
    real_lib = k3._lib
    gen = torch.Generator(device="cuda").manual_seed(11)
    prefill = dict.fromkeys((*TIMED, "bound"), 0.0)
    try:
        for label, (k, n, ng, count) in SHAPES.items():
            x = torch.randn((M, k), generator=gen, device="cuda").bfloat16()
            packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                                   dtype=torch.uint8)
            scale = torch.randn((ng, n), generator=gen, device="cuda") * 0.02
            if k3.form_for(x, packed, scale) != "wgmma":
                raise SystemExit(f"{label}: not on the wgmma form")
            calls = [lambda: k3.int4_matmul(x, packed, scale)] * 20
            times = {}
            for mode in TIMED:
                k3._lib = lambda m=mode: libs[m]
                k3._wgmma_ctas.cache_clear()  # the grid follows the variant's cluster
                times[mode] = device_ms(calls)
            traced = ""
            if label in ("gate,up", "down"):
                k3._lib = lambda: libs["trace"]
                k3._wgmma_ctas.cache_clear()
                device_ms(calls, reps=1)
                torch.cuda.synchronize()
                traced = "; trace (cycles) " + ", ".join(
                    f"{key} {v:.3f}" if key == "ghz" else f"{key} {v:.0f}"
                    for key, v in trace_stats(libs["trace"]).items())
            bound = 2.0 * M * k * n / 989e12 * 1e3
            for mode, ms in times.items():
                prefill[mode] += ms * count * 64
            prefill["bound"] += bound * count * 64
            print(f"{label} ({M},{k})x({k},{n}), bound {bound:.4f} ms: "
                  + "; ".join(f"{mode} {ms:.4f} ms" for mode, ms in times.items()) + traced,
                  flush=True)
    finally:
        k3._lib = real_lib
        k3._wgmma_ctas.cache_clear()
    print("per prefill (448 launches): "
          + "; ".join(f"{key} {v:.1f} ms" for key, v in prefill.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
