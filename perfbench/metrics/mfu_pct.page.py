"""The whole page program's share of the card's bf16 peak over the traced
span, in %: the operations of a page (counted by ``FlopCounterMode`` over
the benchmark's reference at one view and one crop, times the views and
the regions) times the pages traced, over the span's seconds, over
989 TFLOP/s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib.roofline import PEAK_FLOPS  # noqa: E402


def read(run):
    t = run.trace
    pages = run.work.get("pages_traced")
    if t is None or not pages or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * pages * run.work["flops_per_page"] / t.window_s / PEAK_FLOPS["bfloat16"]
