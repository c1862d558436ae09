#!/usr/bin/env python3
"""Where the device time of K6's wgmma form goes, at the three path shapes,
on the card.

    python3 scripts/torch_k6_probe.py [--baseline DIR]

Builds variants of ``multimodal_embeddings_tpu_torch/csrc/ln_matmul.cu``,
each made by exact text edits of the source (the script stops if an edit's
anchor is not found exactly once), and runs each through the port's own
``ln_matmul``:

  kernel     the source as it is;
  nonorm     the raw x fragment as wgmma's A operand: no normalisation
             (ldmatrix, TMA, products, statistics and stores kept);
  nomma      no ``wgmma`` products (normalisation, barriers, stores kept);
  nostats    no statistics (every row's mean and rstd 0);
  loadonly   no statistics, no normalisation, no products: the consumers
             only wait for each stage and release it (TMA, barriers, the
             run's walk and the stores kept);
  statsonly  the statistics alone: no loads, no chunks, no stores;
  nostore    the epilogue's TMA stores left out (staging kept);
  kg2        product groups of 2 k-steps in place of 4 (the next group is
             normalised while a group's products run);
  trace      the kernel with thread 0 of each consumer warpgroup of the
             first TRACE_CTAS CTAs reading ``clock64`` at each step of its
             first TRACE_GROUPS product groups (group start, products
             issued, the next stage landed, the next group normalised,
             products done) and of its first TRACE_TILES tiles (tile start,
             statistics done, last product done, epilogue done); and
             ``%globaltimer`` with ``clock64`` at its start and end, for the
             SM clock.

With ``--baseline DIR`` (a checkout of another commit, such as the parent),
its ``csrc/ln_matmul.cu`` is built too and timed through the same wrapper
as ``baseline``, right after ``kernel`` and again after every variant,
the two turns averaged (its launcher takes the same arguments; the grid
lands where an older one takes its vector-load flag, which any grid sets).

The trace is read for the last launch of a run at each shape: the medians
over the traced groups (the first 16 left out) of each step in SM cycles,
the period per group, and per tile (the first left out) the statistics, the
main loop and the epilogue.

Times are device times per launch of back-to-back launches (the card asleep
while the host enqueues them, as ``chip_smoke.py::device_ms``). The per-page
line weights the ViT shapes by their launches on a kernel-route page (12
each) and the per-chunk line the Mllama shape by a tower chunk's (32). The
outputs of ``nonorm``, ``nomma``, ``nostats``, ``loadonly``, ``statsonly``
and ``nostore`` are wrong by design and are not checked; the others are
held to the plain version within ``chip_smoke.py``'s bound. Needs one card
and ``nvcc``; the variants are built beside the package's own libraries.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# (M, K, N, bias) and launches per kernel-route ViT page or tower chunk
# (chip_smoke.py's K6_SHAPES)
SHAPES = {
    "vit qkv": ((37632, 768, 2304, False), 12),
    "vit fc1 +bias": ((37632, 768, 3072, True), 12),
    "mllama fc1 +bias": ((12864, 1280, 5120, True), 32),
}
MODES = ("kernel", "nonorm", "nomma", "nostats", "loadonly", "statsonly", "nostore", "kg2",
         "trace")
UNCHECKED = ("nonorm", "nomma", "nostats", "loadonly", "statsonly", "nostore")
TRACE_CTAS, TRACE_GROUPS, TRACE_TILES = 4, 192, 8

_NORM = ("    a[i][0] = norm2(r[0], mu0, rs0, glo);  // row l / 4\n"
         "    a[i][1] = norm2(r[1], mu1, rs1, glo);  // row l / 4 + 8\n"
         "    a[i][2] = norm2(r[2], mu0, rs0, ghi);\n"
         "    a[i][3] = norm2(r[3], mu1, rs1, ghi);\n")
_RAW = ("    a[i][0] = r[0] ^ __float_as_uint(glo.x), a[i][1] = r[1] ^ __float_as_uint(rs1);\n"
        "    a[i][2] = r[2] ^ __float_as_uint(ghi.x), a[i][3] = r[3] ^ __float_as_uint(rs0);\n")
_MMA = "    for (int i = 0; i < KG; ++i) wgmma_rs_n256("
_STATS = "    if (rb != rb_stats) {  // a new row block: its statistics, once\n"
_LOADS = ("      int s = 0, ph = 0;\n      for (int u = u0; u < u1; ++u) {\n"
          "        const int rb = p.by_nt.div(u), nj = u - rb * p.nt;\n")
_STATS_DONE = "      rb_stats = rb;\n    }\n"
_STORE = "        tma_store_2d(&p.ymap,"
_KG = "constexpr int KG = 4;"
_KERNEL = "__global__ void __launch_bounds__(WG_THREADS, 1)\n    ln_mm_wgmma_kernel("
_TRACE_DEFS = f"""__device__ unsigned long long k6_trace[{TRACE_CTAS} * 2 * {TRACE_GROUPS} * 5];
__device__ unsigned long long k6_tiles[{TRACE_CTAS} * 2 * {TRACE_TILES} * 4];
__device__ unsigned long long k6_meta[{TRACE_CTAS} * 2 * 4];
__device__ __forceinline__ unsigned long long k6_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define K6_STAMP(k) \\
  if (tr && it < {TRACE_GROUPS}) \\
    k6_trace[((blockIdx.x * 2 + warp / 4) * {TRACE_GROUPS} + it) * 5 + (k)] = clock64();
#define K6_TILE(k) \\
  if (tr && tile < {TRACE_TILES}) \\
    k6_tiles[((blockIdx.x * 2 + warp / 4) * {TRACE_TILES} + tile) * 4 + (k)] = clock64();

"""
_TRACE_READ = """
extern "C" int k6_trace_read(unsigned long long* trace, unsigned long long* tiles,
                             unsigned long long* meta) {
  cudaError_t e = cudaMemcpyFromSymbol(trace, k6_trace, sizeof(k6_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(tiles, k6_tiles, sizeof(k6_tiles));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(meta, k6_meta, sizeof(k6_meta));
  return (int)e;
}
"""
_META = "k6_meta[(blockIdx.x * 2 + warp / 4) * 4"
_TRACE_EDITS = (
    ("  int c = 0, h = 0;  // the chunk and group in it whose products come next\n",
     "  int c = 0, h = 0;  // the chunk and group in it whose products come next\n"
     f"  const bool tr = lane == 0 && warp % 4 == 0 && blockIdx.x < {TRACE_CTAS};\n"
     "  int it = 0, tile = 0;\n"
     f"  if (tr) {_META}] = k6_now(), {_META} + 1] = clock64();\n"),
    ("    fence_regs(cur);\n    wgmma_fence();\n",
     "    K6_STAMP(0)\n    fence_regs(cur);\n    wgmma_fence();\n"),
    ("    wgmma_commit();\n    const int done = s;\n",
     "    wgmma_commit();\n    K6_STAMP(1)\n    const int done = s;\n"),
    ("      if (chunk_end) bar_wait(full_bar(s), ph);\n",
     "      if (chunk_end) bar_wait(full_bar(s), ph);\n      K6_STAMP(2)\n"),
    ("    wgmma_wait<0>();\n    fence_regs(acc);\n    fence_regs(cur);\n",
     "    K6_STAMP(3)\n    wgmma_wait<0>();\n    fence_regs(acc);\n    fence_regs(cur);\n"
     "    K6_STAMP(4)\n    ++it;\n"),
    ("    if (rb != rb_stats) {  // a new row block: its statistics, once\n",
     "    K6_TILE(0)\n    if (rb != rb_stats) {  // a new row block: its statistics, once\n"),
    ("      rb_stats = rb;\n    }\n", "      rb_stats = rb;\n    }\n    K6_TILE(1)\n"),
    ("    while (group(a0, a1) && group(a1, a0)) {\n    }\n",
     "    while (group(a0, a1) && group(a1, a0)) {\n    }\n    K6_TILE(2)\n"),
    ("      __syncwarp();\n    }\n  }\n  if (lane == 0) asm volatile(\"cp.async.bulk.wait_group 0;",
     "      __syncwarp();\n    }\n    K6_TILE(3)\n    ++tile;\n  }\n"
     f"  if (tr) {_META} + 2] = k6_now(), {_META} + 3] = clock64();\n"
     "  if (lane == 0) asm volatile(\"cp.async.bulk.wait_group 0;"),
)
# (name, from stamp, to stamp) of a group; "landed" and "normalise" only
# where the group had a successor
STEPS = (("issue", 0, 1), ("landed", 1, 2), ("normalise", 2, 3), ("products_end", 3, 4))
TILE_STEPS = (("stats", 0, 1), ("main_loop", 1, 2), ("epilogue", 2, 3))


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"anchor found {src.count(old)} times, not once:\n{old}")
    return src.replace(old, new)


def variant_source(src: str, mode: str) -> str:
    """The source of one variant (``MODES``)."""
    if mode == "nonorm":
        return _edit(src, _NORM, _RAW)
    if mode == "nomma":
        return _edit(src, _MMA, "    for (int i = 0; i < KG; ++i) if (false) wgmma_rs_n256(")
    if mode == "nostats":
        return _edit(src, _STATS, "    if (false) {\n")
    if mode == "loadonly":
        for m in ("nonorm", "nomma", "nostats"):
            src = variant_source(src, m)
        return src
    if mode == "statsonly":  # no loads issued; after the statistics, the next unit
        src = _edit(src, _LOADS, _LOADS.replace("u < u1", "u < u0"))
        return _edit(src, _STATS_DONE, _STATS_DONE + (
            "    if (mu0 + rs0 + mu1 + rs1 == -1.f) p.y[threadIdx.x] = __float2bfloat16_rn(mu0);\n"
            "    continue;\n"))
    if mode == "nostore":
        return _edit(src, _STORE, "        if (false) tma_store_2d(&p.ymap,")
    if mode == "kg2":
        return _edit(src, _KG, f"constexpr int KG = {mode[-1]};")
    if mode == "trace":
        src = _edit(src, _KERNEL, _TRACE_DEFS + _KERNEL)
        for old, new in _TRACE_EDITS:
            src = _edit(src, old, new)
        return src + _TRACE_READ
    return src


def build_variants(baseline):
    """Each variant's library (and the baseline's, from the checkout at
    ``baseline`` where given), built by one nvcc per source, all at once."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    src = (_build.CSRC_DIR / "ln_matmul.cu").read_text()
    out = _build.build_dir() / "k6_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    sources = {mode: variant_source(src, mode) for mode in MODES}
    if baseline:
        sources["baseline"] = (Path(baseline) / "multimodal_embeddings_tpu_torch" / "csrc"
                               / "ln_matmul.cu").read_text()
    for mode, text in sources.items():
        cu = out / f"ln_matmul_{mode}.cu"
        cu.write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[mode] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for mode, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {mode}:\n{log}")
        report = [ln.strip() for ln in log.split("ln_mm_wgmma_kernel", 1)[-1].splitlines()
                  if "registers" in ln or "spill" in ln][:2]
        report += sorted({ln.strip()[:120] for ln in log.splitlines() if "Performance Loss" in ln})
        print(f"built {mode}: {' | '.join(report)}")
        lib = ctypes.CDLL(str(out / f"ln_matmul_{mode}.so"))
        lib.ln_matmul_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.ln_matmul_launch.restype = ctypes.c_int
        if mode != "baseline":
            lib.ln_mm_wgmma_resident_ctas.argtypes = []
            lib.ln_mm_wgmma_resident_ctas.restype = ctypes.c_int
        if mode == "trace":
            lib.k6_trace_read.argtypes = [ctypes.c_void_p] * 3
            lib.k6_trace_read.restype = ctypes.c_int
        libs[mode] = lib
    print(f"nvcc, {len(sources)} sources together: {time.perf_counter() - t0:.1f} s")
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
    """Medians (SM cycles) of each group step over the traced CTAs,
    warpgroups and groups 16 .. (landed and normalise over the groups with a
    successor), the period per group, each tile step over tiles 1 .. (the
    statistics over the tiles that computed them), and the SM clock (cycles
    over ``%globaltimer`` ns)."""
    import numpy as np

    trace = (ctypes.c_ulonglong * (TRACE_CTAS * 2 * TRACE_GROUPS * 5))()
    tiles = (ctypes.c_ulonglong * (TRACE_CTAS * 2 * TRACE_TILES * 4))()
    meta = (ctypes.c_ulonglong * (TRACE_CTAS * 2 * 4))()
    err = lib.k6_trace_read(trace, tiles, meta)
    if err != 0:
        raise RuntimeError(f"k6_trace_read: cudaError {err}")
    t = np.frombuffer(trace, dtype=np.uint64).astype(np.float64)
    t = t.reshape(TRACE_CTAS, 2, TRACE_GROUPS, 5)[:, :, 16:]
    tt = np.frombuffer(tiles, dtype=np.uint64).astype(np.float64)
    tt = tt.reshape(TRACE_CTAS, 2, TRACE_TILES, 4)[:, :, 1:]
    m = np.frombuffer(meta, dtype=np.uint64).astype(np.float64).reshape(TRACE_CTAS * 2, 4)
    succ = t[..., 2] > 0
    out = {}
    for name, a, b in STEPS:
        d = t[..., b] - t[..., a]
        out[name] = float(np.median(d[succ] if name in ("landed", "normalise") else d))
    out["period"] = float(np.median(np.diff(t[..., 0], axis=-1)))
    for name, a, b in TILE_STEPS:
        d = tt[..., b] - tt[..., a]
        if name == "stats":
            d = d[d > 100]  # the tiles that computed statistics
        out[name] = float(np.median(d)) if d.size else 0.0
    out["ghz"] = float(np.median((m[:, 3] - m[:, 1]) / (m[:, 2] - m[:, 0])))
    return out


def use(k6, libs, mode: str) -> None:
    """Point the port's wrapper at a variant's library and its resident
    CTAs."""
    lib = libs[mode]
    k6._lib = lambda: lib
    k6._grids.clear()
    k6.ln_mm_wgmma_plan.cache_clear()
    ctas = 132 if mode == "baseline" else lib.ln_mm_wgmma_resident_ctas()
    k6._wgmma_ctas = lambda index, c=ctas: c


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe runs on the card", file=sys.stderr)
        return 1
    from multimodal_embeddings_tpu_torch.kernels import ln_matmul as k6

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    baseline = sys.argv[sys.argv.index("--baseline") + 1] if "--baseline" in sys.argv else None
    libs = build_variants(baseline)
    order = (MODES[:1] + ("baseline",) + MODES[1:-1] + ("baseline",) + MODES[-1:]
             if baseline else MODES)
    saved = (k6._lib, k6._wgmma_ctas)
    gen = torch.Generator(device="cuda").manual_seed(4)
    totals = {}
    try:
        for label, ((m, k, n, with_bias), count) in SHAPES.items():
            x = (torch.randn((m, k), generator=gen, device="cuda") * 1.5 + 0.3).bfloat16()
            gamma = torch.rand((k,), generator=gen, device="cuda") + 0.5
            beta = torch.randn((k,), generator=gen, device="cuda") * 0.2
            w = (torch.randn((k, n), generator=gen, device="cuda") / k**0.5).bfloat16()
            bias = ((torch.randn((n,), generator=gen, device="cuda") * 0.5).bfloat16()
                    if with_bias else None)
            if k6.form_for(x, w, bias) != "wgmma":
                raise SystemExit(f"{label}: not on the wgmma form")
            want = k6.ln_matmul_reference(x, gamma, beta, w, bias)
            xf = x.float()
            xc = xf - xf.mean(-1, keepdim=True)
            xn = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + 1e-6) * gamma
                  + beta).bfloat16().float()
            del xf, xc
            def step(t):
                t = t.float()
                return torch.ldexp(torch.ones_like(t), torch.frexp(t.abs().clamp_min(2.0**-126))[1] - 8)

            # as chip_smoke.py's gate: the sums' order, one flipped normalised
            # input per row, 2 steps of the product's rounding and 2 of the
            # output's (with a bias the output rounds twice)
            pre = want if bias is None else k6.ln_matmul_reference(x, gamma, beta, w)
            wabs = w.float().abs()
            allowed = (2 * k * 2.0**-24 * (xn.abs() @ wabs)
                       + torch.outer(step(xn).amax(-1), wabs.amax(0))
                       + 2 * step(pre) + 2 * step(want))
            del xn, wabs, pre
            calls = [lambda: k6.ln_matmul(x, gamma, beta, w, bias=bias)] * 20
            times = {}
            for mode in order:
                use(k6, libs, mode)
                if mode not in UNCHECKED:
                    got = k6.ln_matmul(x, gamma, beta, w, bias=bias)
                    ratio = ((got.float() - want.float()).abs() / allowed).max().item()
                    if ratio > 1.0:
                        raise SystemExit(f"{label} {mode}: error {ratio:.3g}x its bound")
                if mode == "trace":
                    device_ms(calls, reps=1)
                    torch.cuda.synchronize()
                    traced = trace_stats(libs[mode])
                else:  # the baseline's two turns averaged
                    ms = device_ms(calls)
                    times[mode] = (times[mode] + ms) / 2 if mode in times else ms
            bound = 2.0 * m * k * n / 989e12 * 1e3
            for mode, ms in times.items():
                totals.setdefault(mode, {})
                totals[mode][label] = ms * count
            use(k6, libs, "kernel")
            plan = k6.plan_for(x, w)
            print(f"{label} ({m},{k})x({k},{n}) [{plan.units} units over {plan.grid} CTAs, "
                  f"{plan.stages} stages], bound {bound:.4f} ms: "
                  + "; ".join(f"{mode} {ms:.4f} ms" for mode, ms in times.items())
                  + "; trace (cycles) " + ", ".join(
                      f"{key} {v:.3f}" if key == "ghz" else f"{key} {v:.0f}"
                      for key, v in traced.items()), flush=True)
            del x, w, want, allowed
            torch.cuda.empty_cache()
    finally:
        k6._lib, k6._wgmma_ctas = saved
        k6._grids.clear()
        k6.ln_mm_wgmma_plan.cache_clear()
    for mode, by in totals.items():
        page = by["vit qkv"] + by["vit fc1 +bias"]
        print(f"{mode}: {page:.2f} ms per kernel-route ViT page (24 launches), "
              f"{by['mllama fc1 +bias']:.2f} ms per tower chunk (32 launches)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
