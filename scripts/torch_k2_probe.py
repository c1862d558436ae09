#!/usr/bin/env python3
"""Where the device time of K2's wgmma form goes, at the five mmE5-11B text
shapes, on the card.

    python3 scripts/torch_k2_probe.py

Builds variants of ``multimodal_embeddings_tpu_torch/csrc/int8_matmul.cu``,
each made by exact text edits of the source (the script stops if an edit's
anchor is not found exactly once), and runs each through the port's own
``int8_matmul``:

  kernel     the source as it is;
  tm128,      the same library on tiles of 128 or 256 rows of x, whatever
  tm256      ``wgmma_tile_m`` chooses;
  flat       the same library with the stream-K shares cut over all groups
             in one sequence, never per M tile;
  pertile    the same library on a plan of one cluster per tile group (one
             CTA per tile, whole K: no stream-K shares, no partials);
  noconvert  the consumers' A fragments set to a constant: no ldmatrix of
             the weight, no int8 -> bf16 conversion (TMA, products kept);
  nomma      no ``wgmma`` products (barriers, conversion, stores kept);
  loadonly   both: the consumers only wait for each stage and release it
             (TMA, barriers, the share walk, partials and stores kept);
  stagesm1   the TMA ring cut to one stage fewer than fit (3 at 128 rows, 4
             at 256);
  cluster1,  clusters of 1 CTA (no x multicast) or of 4 (x read from L2 once
  cluster4   for four adjacent N tiles) in place of 2;
  trace128,  the kernel with thread 0 of each consumer warpgroup of the
  trace256   first TRACE_CTAS CTAs reading ``clock64`` at each step of its
             first TRACE_CHUNKS chunks: chunk start, products issued, next
             chunk's stage landed, its A converted, products done, segment
             end done; and ``%globaltimer`` with ``clock64`` at its start
             and end, for the SM clock; on tiles of 128 or 256 rows.

The traces are read for the last launch of a run at gate,up: the medians over
the traced chunks (the first 8 left out) of each step in SM cycles, the
period per chunk, and the offset between the two warpgroups' "products
done".

Times are device times per launch of back-to-back launches (the card asleep
while the host enqueues them, as ``chip_smoke.py::device_ms``). The
per-chunk line weights each shape by its launches in one embed chunk of 8
crops (q,o 80, k,v 64, gate,up 80, down 40, cross k,v 16). The outputs of
the variants ``noconvert``, ``nomma`` and ``loadonly`` are wrong by design
and are not checked; the others are held to the plain version within
``chip_smoke.py``'s bound (2K·2^-24·|x|·|q|·scale and 2 bf16 steps).
Needs one card and ``nvcc``; the variants are built beside the package's own
libraries.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (M, K, N) and launches per embed chunk (chip_smoke.py's K2_SHAPES)
SHAPES = {
    "q,o": ((512, 4096, 4096), 80), "k,v": ((512, 4096, 1024), 64),
    "gate,up": ((512, 4096, 14336), 80), "down": ((512, 14336, 4096), 40),
    "cross k,v": ((12808, 4096, 1024), 16),
}
MODES = ("kernel", "tm128", "tm256", "flat", "pertile", "noconvert", "nomma", "loadonly",
         "stagesm1", "cluster1", "cluster4", "trace128", "trace256")
TIMED = MODES[:-2]
UNCHECKED = ("noconvert", "nomma", "loadonly")
SAME_LIBRARY = {"tm128": "kernel", "tm256": "kernel", "flat": "kernel", "pertile": "kernel",
                "trace256": "trace128"}
TILE = {"tm128": 128, "trace128": 128, "tm256": 256, "trace256": 256}
TRACE_CTAS, TRACE_CHUNKS = 4, 96

_CONVERT = ("#pragma unroll\n  for (int h = 0; h < KS / 2; ++h) {  "
            "// k-steps 2h, 2h + 1: weight rows 32h ..\n")
_CONST_A = ("#pragma unroll\n  for (int j = 0; j < KS; ++j)\n"
            "    a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0x3F803F80u ^ wt;\n  return;\n")
_MMA = "      wgmma_rs(acc, cur[j],"
_STAGES = "    while (fit(s) > SMEM_LIMIT) --s;\n    return s;\n"
_KERNEL = ("template <int TM>\n__global__ void __launch_bounds__(WG_THREADS, 1)\n"
           "    int8_mm_wgmma_kernel(")
_TRACE_DEFS = f'''__device__ unsigned long long k2_trace[{TRACE_CTAS} * 2 * {TRACE_CHUNKS} * 8];
__device__ unsigned long long k2_meta[{TRACE_CTAS} * 2 * 4];
__device__ __forceinline__ unsigned long long k2_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define K2_STAMP(k) \\
  if (tr && it < {TRACE_CHUNKS}) \\
    k2_trace[((blockIdx.x * 2 + g) * {TRACE_CHUNKS} + it) * 8 + (k)] = clock64();

'''
_TRACE_READ = '''
extern "C" int k2_trace_read(unsigned long long* trace, unsigned long long* meta) {
  cudaError_t e = cudaMemcpyFromSymbol(trace, k2_trace, sizeof(k2_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(meta, k2_meta, sizeof(k2_meta));
  return (int)e;
}
'''
_TRACE_EDITS = (
    ("  bool seg_start = true;\n",
     f"  bool seg_start = true;\n  const bool tr = tid == 0 && blockIdx.x < {TRACE_CTAS};\n"
     "  int it = 0;\n"
     "  if (tr) k2_meta[(blockIdx.x * 2 + g) * 4] = k2_now(), "
     "k2_meta[(blockIdx.x * 2 + g) * 4 + 1] = clock64();\n"),
    ("    fence_regs(cur);\n    wgmma_fence();\n",
     "    K2_STAMP(0)\n    fence_regs(cur);\n    wgmma_fence();\n"),
    ("    wgmma_commit();\n    const int done = s;\n",
     "    wgmma_commit();\n    K2_STAMP(2)\n    const int done = s;\n"),
    ("      bar_wait(full_bar(s), ph);\n      convert_chunk(nxt, w_tile(s), lane_off);\n    }\n",
     "      bar_wait(full_bar(s), ph);\n      K2_STAMP(6)\n"
     "      convert_chunk(nxt, w_tile(s), lane_off);\n    }\n    K2_STAMP(3)\n"),
    ("    wgmma_wait0();\n    fence_regs(acc);\n",
     "    wgmma_wait0();\n    fence_regs(acc);\n    K2_STAMP(4)\n"),
    ("    if (seg_start) finish();\n",
     "    if (seg_start) finish();\n    K2_STAMP(5)\n    ++it;\n"),
    ("  cluster_sync();\n}\n\n// cuTensorMapEncodeTiled",
     "  if (tr) k2_meta[(blockIdx.x * 2 + g) * 4 + 2] = k2_now(), "
     "k2_meta[(blockIdx.x * 2 + g) * 4 + 3] = clock64();\n"
     "  cluster_sync();\n}\n\n// cuTensorMapEncodeTiled"),
)
# (name, from stamp, to stamp)
STEPS = (("issue", 0, 2), ("landed", 2, 6), ("convert", 6, 3), ("products", 3, 4),
         ("segment_end", 4, 5))


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once:\n{old}")
    return src.replace(old, new)


def variant_source(src: str, mode: str) -> str:
    """The source of one variant (``MODES``; those in ``SAME_LIBRARY`` are
    the kernel's own)."""
    if mode == "noconvert":
        return _edit(src, _CONVERT, _CONST_A + _CONVERT)
    if mode == "nomma":
        return _edit(src, _MMA, "      if (false) wgmma_rs(acc, cur[j],")
    if mode == "loadonly":
        return variant_source(variant_source(src, "noconvert"), "nomma")
    if mode == "stagesm1":
        return _edit(src, _STAGES, "    while (fit(s) > SMEM_LIMIT) --s;\n    return s - 1;\n")
    if mode.startswith("cluster"):
        return _edit(src, "constexpr int WC = 2;", f"constexpr int WC = {mode[-1]};")
    if mode == "trace128":
        src = _edit(src, _KERNEL, _TRACE_DEFS + _KERNEL)
        for old, new in _TRACE_EDITS:
            src = _edit(src, old, new)
        return src + _TRACE_READ
    return src


def build_variants():
    """Each variant's library, built by one nvcc per variant, all at once."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "int8_matmul.cu").read_text()
    out = _build.build_dir() / "k2_probe"
    out.mkdir(parents=True, exist_ok=True)
    built = [m for m in MODES if m not in SAME_LIBRARY]
    procs = {}
    t0 = time.perf_counter()
    for mode in built:
        cu = out / f"int8_matmul_{mode}.cu"
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
        lib = ctypes.CDLL(str(out / f"int8_matmul_{mode}.so"))
        lib.int8_matmul_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
        lib.int8_matmul_launch.restype = ctypes.c_int
        lib.int8_wgmma_resident_ctas.argtypes = [ctypes.c_int]
        lib.int8_wgmma_resident_ctas.restype = ctypes.c_int
        if mode == "trace128":
            lib.k2_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.k2_trace_read.restype = ctypes.c_int
        libs[mode] = lib
    for mode, same in SAME_LIBRARY.items():
        libs[mode] = libs[same]
    print(f"nvcc, {len(built)} variants together: {time.perf_counter() - t0:.1f} s")
    return libs


HOST_US = []  # the host's time per call while enqueueing, of each device_ms


def device_ms(calls, reps: int = 5) -> float:
    """Device time per call of ``calls`` run back to back, the card asleep
    while the host enqueues them (as ``chip_smoke.py::device_ms``); the
    host's enqueue time per call goes to HOST_US."""
    import torch

    for call in calls[:2]:
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for call in calls:
        call()
    host = time.perf_counter() - t0
    HOST_US.append(host / len(calls) * 1e6)
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
    err = lib.k2_trace_read(trace, meta)
    if err != 0:
        raise RuntimeError(f"k2_trace_read: cudaError {err}")
    t = np.frombuffer(trace, dtype=np.uint64).astype(np.float64)
    t = t.reshape(TRACE_CTAS, 2, TRACE_CHUNKS, 8)[:, :, 8:]
    m = np.frombuffer(meta, dtype=np.uint64).astype(np.float64).reshape(TRACE_CTAS * 2, 4)
    out = {name: float(np.median(t[..., b] - t[..., a])) for name, a, b in STEPS}
    out["period"] = float(np.median(np.diff(t[..., 0], axis=-1)))
    out["wg_offset"] = float(np.median(t[:, 1, :, 4] - t[:, 0, :, 4]))
    out["ghz"] = float(np.median((m[:, 3] - m[:, 1]) / (m[:, 2] - m[:, 0])))
    return out


def use(k2, libs, mode: str, shape, rules) -> None:
    """Point the port's wrapper at a variant: its library, and the tile and
    sequence rules, cluster and resident CTAs that go with it."""
    lib = libs[mode]
    k2._lib = lambda: lib
    k2._WG_CLUSTER = int(mode[-1]) if mode.startswith("cluster") else 2
    k2.wgmma_tile_m = (lambda m, k, n, c: TILE[mode]) if mode in TILE else rules[0]
    k2.wgmma_seqs = (lambda mt, clusters: 1) if mode == "flat" else rules[1]
    k2.int8_wgmma_plan.cache_clear()
    k2._launch_args.clear()
    ctas = min(lib.int8_wgmma_resident_ctas(t) for t in (128, 256))
    if mode == "pertile":  # one cluster per tile group: nothing cut
        tile_m = k2.wgmma_tile_m(*shape, ctas)
        ctas = k2._WG_CLUSTER * k2.int8_wgmma_plan(*shape, 1 << 30, tile_m).groups
    k2._wgmma_ctas = lambda index, c=ctas: c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe runs on the card", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import quantization as k2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    libs = build_variants()
    saved = (k2._lib, k2._WG_CLUSTER, k2._wgmma_ctas, k2.wgmma_tile_m, k2.wgmma_seqs)
    rules = saved[3:]
    gen = torch.Generator(device="cuda").manual_seed(2)
    per_chunk = dict.fromkeys((*TIMED, "bound"), 0.0)
    try:
        for label, ((m, k, n), count) in SHAPES.items():
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
            scale = (torch.rand((n,), generator=gen, device="cuda") + 0.5) * (0.02 / 127)
            if k2.form_for(x, q, scale) != "wgmma":
                raise SystemExit(f"{label}: not on the wgmma form")
            want = k2.int8_matmul_reference(x, q, scale)
            step = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                               torch.frexp(want.float().abs().clamp_min(2.0**-126))[1] - 8)
            allowed = (2 * k * 2.0**-24 * (x.float().abs() @ q.float().abs()) * scale.abs()
                       + 2 * step)
            calls = [lambda: k2.int8_matmul(x, q, scale)] * 20
            times = {}
            w = q.to(torch.bfloat16)
            cublas = device_ms([lambda: x @ w] * 20)
            host = {"cuBLAS": HOST_US[-1]}
            del w
            for mode in TIMED:
                use(k2, libs, mode, (m, k, n), rules)
                if mode not in UNCHECKED:
                    got = k2.int8_matmul(x, q, scale)
                    ratio = ((got.float() - want.float()).abs() / allowed).max().item()
                    if ratio > 1.0:
                        raise SystemExit(f"{label} {mode}: error {ratio:.3g}x its bound")
                times[mode] = device_ms(calls)
                if mode == "kernel":
                    host["kernel"] = HOST_US[-1]
            traced = ""
            for mode in ("trace128", "trace256") if label == "gate,up" else ():
                use(k2, libs, mode, (m, k, n), rules)
                device_ms(calls, reps=1)
                torch.cuda.synchronize()
                traced += f"; {mode} (cycles) " + ", ".join(
                    f"{key} {v:.3f}" if key == "ghz" else f"{key} {v:.0f}"
                    for key, v in trace_stats(libs[mode]).items())
            bound = 2.0 * m * k * n / 989e12 * 1e3
            for mode, ms in times.items():
                per_chunk[mode] += ms * count
            per_chunk["bound"] += bound * count
            use(k2, libs, "kernel", (m, k, n), rules)
            plan = k2.plan_for(x, q)
            print(f"{label} ({m},{k})x({k},{n}) [{plan.tile_m} rows, {plan.seqs} sequences], "
                  f"bound {bound:.4f} ms: "
                  + "; ".join(f"{mode} {ms:.4f} ms" for mode, ms in times.items())
                  + f"; cuBLAS bf16 x@W {cublas:.4f} ms; host per call: "
                  + ", ".join(f"{key} {us:.1f} us" for key, us in host.items()) + traced,
                  flush=True)
            del x, q, scale, want, step, allowed
    finally:
        k2._lib, k2._WG_CLUSTER, k2._wgmma_ctas, k2.wgmma_tile_m, k2.wgmma_seqs = saved
        k2._launch_args.clear()
        k2.int8_wgmma_plan.cache_clear()
    print("per embed chunk (280 launches): "
          + "; ".join(f"{key} {v:.2f} ms" for key, v in per_chunk.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
