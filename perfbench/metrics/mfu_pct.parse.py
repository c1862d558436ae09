"""The whole parse's share of the card's bf16 peak over the window's call,
in %: the operations of its prefills and decode steps, counted from the
published widths (``drivers/parse.py::prefill_flops`` and ``step_flops``;
a step computes every row), over the call's seconds, over 989 TFLOP/s."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib.roofline import PEAK_FLOPS  # noqa: E402


def read(run):
    w = run.work
    if not w.get("window_flops") or w.get("window_s", 0) <= 0:
        return None
    return 100.0 * w["window_flops"] / w["window_s"] / PEAK_FLOPS["bfloat16"]
