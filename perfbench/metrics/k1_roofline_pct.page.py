"""K1's share of its roofline on the page program, in %: the least time
the card could take for K1's work on the traced pages, over K1's traced
device time. The work a page (``drivers/page.py::Session.page_flops``, from
the reference's shapes): the ViT tower's attention in each layer at (48
crops, 784 rows, 12 heads of 64) and the detector's PSA block at (30 views,
1024 rows, 4 heads of q, k 36 and v 72), each input read and each output
written once."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchlib.families import family_of  # noqa: E402


def read(run):
    t = run.trace
    pages = run.work.get("pages_traced")
    if t is None or not pages:
        return None
    k1 = t.seconds(lambda name: family_of(name) == "K1")
    if k1 <= 0:
        return None
    return 100.0 * pages * run.work["k1_bound_s_per_page"] / k1
