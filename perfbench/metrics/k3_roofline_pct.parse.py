"""K3's share of its roofline in the traced window's call, in %: the least time the
card could take for K3's work there (449 launches a prefill, at the
prompt's rows and the ``lm_head`` at one; 449 a decode step at the cell's
rows; ``drivers/parse.py::k3_bound_s``) over K3's traced device time."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib.families import family_of  # noqa: E402


def read(run):
    t, w = run.trace, run.work
    if t is None or not w.get("trace_pages"):
        return None
    k3 = t.seconds(lambda name: family_of(name) == "K3")
    if k3 <= 0:
        return None
    bound = w["trace_pages"] * w["prefill_k3_bound_s"] + w["trace_steps"] * w["step_k3_bound_s"]
    return 100.0 * bound / k3
