#!/usr/bin/env python3
"""Where the device time of K3's decode GEMV goes, at the five
Qwen2.5-VL-32B decode shapes, on the card.

    python3 scripts/torch_k3_gemv_probe.py

Builds variants of ``multimodal_embeddings_tpu_torch/csrc/int4_matmul.cu``,
each made by exact text edits of the source (the script stops if an edit's
anchor is not found exactly once), and runs each through the port's own
``int4_matmul`` on the same plan (the grid of the unedited kernel):

  kernel     the source as it is;
  empty      every CTA returns right after ``griddepcontrol.wait``: the
             launch and CTA scheduling at the plan's grid, nothing else;
  noload     the weight loads replaced by a value made from the address in
             registers (x staging, scales, products, folds and sums kept);
  nocompute  each 32-bit word of weights XORed into one partial instead of
             its eight products (the loads kept live, the rest kept);
  trace      the kernel with thread 0 of each CTA reading ``%globaltimer``
             after ``griddepcontrol.wait`` and after the CTA's last work.

The unedited kernel is also timed with ``gemv_plan``'s least units per CTA
(``_GEMV_MIN_UNITS``, 4) set to each of ``LEAST_UNITS`` in turn: the
readings behind that constant.

Times are device times per launch of back-to-back launches over weight
copies larger than the 50 MB L2 (as ``chip_smoke.py`` phase 11 times the
decode shapes). The trace gives, for the last launch of such a run, the
span from the first CTA start to the last CTA end, the mean CTA busy time,
and the spread of the CTAs' start and end times. The per-step lines weight
each shape by its launches in one decode step (q,o, k,v, gate,up 128 each,
down 64, ``lm_head`` 1). The outputs of ``empty``, ``noload`` and
``nocompute`` are wrong by design and are not checked. Needs one card and
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

# (K, N, n_groups, launches per decode step)
SHAPES = {
    "q,o": (5120, 5120, 40, 128), "k,v": (5120, 1024, 40, 128),
    "gate,up": (5120, 27648, 40, 128), "down": (27648, 5120, 216, 64),
    "lm_head": (5120, 152064, 40, 1),
}
TIMED = ("kernel", "empty", "noload", "nocompute")
MODES = (*TIMED, "trace")
TRACE_CTAS = 4096
LEAST_UNITS = (1, 2, 4, 8, 16)

_WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
_KERNEL = ("template <int MT, typename OutT>\n__global__ void __launch_bounds__(GV_THREADS)\n"
           "    int4_gemv_kernel(")
_LOOP_END = "    cu.next(a.nch, ng);\n  }\n}\n"
_LD = r'''  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
'''
_NOLOAD = '''  const uint32_t a = (uint32_t)reinterpret_cast<uintptr_t>(p);
  return make_uint4(a, a ^ 0x9E3779B9u, a * 3u, a + (uint32_t)policy);
'''
_WORD = '''#pragma unroll
  for (int m = 0; m < MT; ++m) {
    part[m][c0] = fmaf(xv[m].y, d1, fmaf(xv[m].x, d0, part[m][c0]));
'''
_NOCOMPUTE = '''  part[0][c0] = __uint_as_float(__float_as_uint(part[0][c0]) ^ w);
  return;
'''
_TRACE_DEFS = f'''__device__ unsigned long long gv_trace[2 * {TRACE_CTAS}];
__device__ __forceinline__ unsigned long long gv_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}

'''
_TRACE_READ = '''
extern "C" int gv_trace_read(unsigned long long* out, int ctas) {
  return (int)cudaMemcpyFromSymbol(out, gv_trace, sizeof(unsigned long long) * 2 * ctas);
}
'''


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once:\n{old}")
    return src.replace(old, new)


def variant_source(src: str, mode: str) -> str:
    """The source of one variant (``MODES``)."""
    if mode == "empty":
        return _edit(src, _WAIT, _WAIT + "  return;\n")
    if mode == "noload":
        return _edit(src, _LD, _NOLOAD)
    if mode == "nocompute":
        return _edit(src, _WORD, _NOCOMPUTE + _WORD)
    if mode == "trace":
        src = _edit(src, _KERNEL, _TRACE_DEFS + _KERNEL)
        src = _edit(src, _WAIT, _WAIT + f"  if (threadIdx.x == 0 && blockIdx.x < {TRACE_CTAS}) "
                                        "gv_trace[2 * blockIdx.x] = gv_now();\n")
        src = _edit(src, _LOOP_END, "    cu.next(a.nch, ng);\n  }\n  __syncthreads();\n"
                    f"  if (tid == 0 && blockIdx.x < {TRACE_CTAS}) "
                    "gv_trace[2 * blockIdx.x + 1] = gv_now();\n}\n")
        return src + _TRACE_READ
    return src


def build_variants():
    """Each variant's library, built by one nvcc per variant, all at once."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "int4_matmul.cu").read_text()
    out = _build.build_dir() / "k3_probe"
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
        lib.int4_gemv_resident_ctas.argtypes = [ctypes.c_int] * 2
        lib.int4_gemv_resident_ctas.restype = ctypes.c_int
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


def trace_stats(lib, calls, grid: int, reps: int = 5) -> dict:
    """Medians over ``reps`` runs of ``calls`` of the last launch's CTA
    timeline, in µs: span (first start to last end), mean busy (end - start
    per CTA), start spread and end spread (last less first)."""
    import torch

    t0 = time.perf_counter()
    for call in calls:
        call()
    host = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(int((2 * host + 1e-3) * 2e9))
        for call in calls:
            call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * grid))()
        err = lib.gv_trace_read(buf, grid)
        if err != 0:
            raise RuntimeError(f"gv_trace_read: cudaError {err}")
        starts, ends, stamps = buf[0::2], buf[1::2], sorted(set(buf))
        runs.append({
            "span_us": (max(ends) - min(starts)) / 1e3,
            "busy_us": statistics.fmean(e - s for s, e in zip(starts, ends)) / 1e3,
            "start_spread_us": (max(starts) - min(starts)) / 1e3,
            "end_spread_us": (max(ends) - min(ends)) / 1e3,
            # the timer's step: the least nonzero gap between two readings
            "tick_us": min((b - a for a, b in zip(stamps, stamps[1:])), default=0) / 1e3,
        })
    return {key: statistics.median(r[key] for r in runs) for key in runs[0]}


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
    real_lib, real_least = k3._lib, k3._GEMV_MIN_UNITS
    k3._lib = lambda: libs["kernel"]  # the plan's grid comes from the unedited kernel
    dev = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(11)
    step = dict.fromkeys((*TIMED, "span", "busy", "bound"), 0.0)
    try:
        for label, (k, n, ng, per_step) in SHAPES.items():
            x = torch.randn((1, k), generator=gen, device="cuda").bfloat16()
            packed = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                                   dtype=torch.uint8)
            scale = torch.randn((ng, n), generator=gen, device="cuda") * 0.02
            wbytes = packed.numel() + scale.numel() * 4
            copies = [(packed, scale)] + [(packed.clone(), scale.clone())
                                          for _ in range(-(-128 * 2**20 // wbytes) - 1)]
            calls = [lambda p=p, s=s: k3.int4_matmul(x, p, s) for p, s in copies]
            calls = calls * max(1, 64 // len(calls))
            plan = k3.plan_for(x, packed, scale)
            times = {}
            for mode in TIMED:
                k3._lib = lambda m=mode: libs[m]
                times[mode] = device_ms(calls)
            k3._lib = lambda: libs["trace"]
            tr = trace_stats(libs["trace"], calls, plan.grid)
            k3._lib = lambda: libs["kernel"]
            least = []
            for units in LEAST_UNITS:  # the plan's least units per CTA
                k3._GEMV_MIN_UNITS = units
                k3.gemv_plan.cache_clear()
                least.append(f"{units}: grid {k3.plan_for(x, packed, scale).grid} "
                             f"{device_ms(calls):.4f}")
            k3._GEMV_MIN_UNITS = real_least
            k3.gemv_plan.cache_clear()
            bound = (k * n // 2 + 4 * ng * n + 2 * k + 2 * n) / 3.35e12 * 1e3
            for mode, ms in times.items():
                step[mode] += ms * per_step
            step["span"] += tr["span_us"] / 1e3 * per_step
            step["busy"] += tr["busy_us"] / 1e3 * per_step
            step["bound"] += bound * per_step
            print(f"{label} (1,{k})x({k},{n}), grid {plan.grid}, bound {bound:.4f} ms: "
                  + "; ".join(f"{mode} {ms:.4f} ms" for mode, ms in times.items())
                  + "; trace " + ", ".join(f"{key} {v:.2f}" for key, v in tr.items())
                  + "; kernel by least units per CTA: " + "; ".join(least), flush=True)
            del copies, calls
    finally:
        k3._lib, k3._GEMV_MIN_UNITS = real_lib, real_least
        k3.gemv_plan.cache_clear()
    print("per decode step (449 launches): "
          + "; ".join(f"{key} {v:.3f} ms" for key, v in step.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
