"""Per-kernel attribution from ``torch.profiler`` Chrome traces.

Port of ``multimodal_embeddings_tpu/utils/trace_analysis.py``, which reads
``jax.profiler`` xplane protobufs. This one reads the Chrome trace JSON that
``utils/profiling.py::trace`` (``torch.profiler``'s ``export_chrome_trace``)
writes, takes its device kernels (events of ``cat == "kernel"``, durations
in µs), and aggregates them by name and by category: the port's hand-written
kernels K1-K8 by the symbols of ``csrc/*.cu``, then cuDNN convolutions,
cuBLAS/CUTLASS GEMMs, memcpy/memset, sort, reduce and elementwise kernels,
and the rest as other — the tool that turns a trace into an optimization
worklist.

Usage::

    python -m multimodal_embeddings_tpu_torch.utils.trace_analysis trace_dir_or_json
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# (category, lower-case name fragments), first match wins: the port's kernels
# by their csrc/*.cu symbols, then the library families (cuDNN names its
# kernels *_implicit_gemm_*, so convolutions come before GEMMs)
CATEGORIES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("K1 enc_attn", ("enc_attn",)),
    ("K2 int8_mm", ("int8_mm",)),
    ("K3 int4", ("int4_mm", "int4_gemv")),
    ("K4 flash", ("flash_wgmma", "flash_f32", "flash_v2_f32")),
    ("K5 conv3x3", ("conv3x3_bf16", "conv3x3_f32")),
    ("K6 ln_mm", ("ln_mm_wgmma", "ln_mm_bf16", "ln_mm_f32")),
    ("K7 ln_stats", ("ln_stats_kernel",)),
    ("K8 sr_quantize", ("sr_quantize",)),
    ("conv (cuDNN)", ("conv", "cudnn", "implicit", "fprop")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("sort", ("sort", "radix")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


@dataclasses.dataclass
class OpStat:
    name: str
    category: str
    total_us: float
    count: int


def category_of(name: str) -> str:
    """The category of a kernel by its name (``CATEGORIES``, else other)."""
    low = name.lower()
    for category, fragments in CATEGORIES:
        if any(f in low for f in fragments):
            return category
    return "other"


def _trace_file(trace_path: str) -> str:
    """``trace_path`` itself, or the last ``*.json`` (by name) in it."""
    if not os.path.isdir(trace_path):
        return trace_path
    paths = sorted(glob.glob(os.path.join(trace_path, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {trace_path}")
    return paths[-1]


def aggregate_kernels(trace_path: str) -> List[OpStat]:
    """Aggregate the trace's device kernel events by (name, category),
    largest total first."""
    with open(_trace_file(trace_path)) as f:
        events = json.load(f)["traceEvents"]
    totals: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for event in events:
        if event.get("cat") != "kernel":
            continue
        totals[event.get("name", "?")][0] += event.get("dur", 0)
        totals[event.get("name", "?")][1] += 1
    return sorted(
        (
            OpStat(name=name, category=category_of(name), total_us=v[0], count=v[1])
            for name, v in totals.items()
        ),
        key=lambda s: -s.total_us,
    )


def category_summary(stats: List[OpStat]) -> Dict[str, float]:
    by_cat: Dict[str, float] = defaultdict(float)
    for stat in stats:
        by_cat[stat.category or "uncategorized"] += stat.total_us
    return dict(sorted(by_cat.items(), key=lambda kv: -kv[1]))


def print_report(
    trace_path: str, top: int = 30, category: Optional[str] = None
) -> None:
    stats = aggregate_kernels(trace_path)
    grand = sum(s.total_us for s in stats)
    launches = sum(s.count for s in stats)
    print(f"device kernel time: {grand / 1e3:.2f} ms over {launches} launches "
          f"of {len(stats)} distinct kernels")
    print("\nby category:")
    for cat, us in category_summary(stats).items():
        share = 100 * us / grand if grand else 0.0
        print(f"  {cat:<28s} {us / 1e3:9.2f} ms  ({share:4.1f}%)")
    if category:
        stats = [s for s in stats if category.lower() in s.category.lower()]
        print(f"\ntop {top} kernels in category '{category}':")
    else:
        print(f"\ntop {top} kernels:")
    for stat in stats[:top]:
        print(
            f"  {stat.total_us / 1e3:8.2f} ms  x{stat.count:<4d} "
            f"[{stat.category:<16s}] {stat.name[:160]}"
        )


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("trace_path", help="a Chrome trace JSON, or a folder of them")
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument(
        "--category",
        default=None,
        help="only list kernels whose category contains this substring "
        "(e.g. 'K1' or 'gemm')",
    )
    args = parser.parse_args()
    print_report(args.trace_path, top=args.top, category=args.category)
