"""A parse queue: pages for the document parser and the output length at
which each is stopped.

Parameters (a traffic file of kind ``parse_queue``): ``page_hw`` [height,
width] of every page, ``pool`` how many distinct pages, ``queue_len`` how
many pages a run queues, ``stop_range`` [lo, hi] of the forced output
lengths (random weights never emit EOS, so a run injects each page's stop).
Every seed gets the same stops, evenly spread over the range, in one fixed
shuffled order: the order sets how the decoder packs its rows, so it is part
of the work, and a seed changes only which pages are read (and the
weights)."""

from __future__ import annotations

import numpy as np

from benchlib.pages import make_page


class ParseQueue:
    """``pool[i]``: ``(H, W, 3)`` uint8 pages; ``pages``: the pool index of
    each queued page, in turn; ``stops``: each queued page's output length."""

    def __init__(self, params: dict, seed: int):
        rng = np.random.default_rng([seed, 3])
        h, w = params["page_hw"]
        n = params["queue_len"]
        self.pool = [make_page(h, w, int(s))
                     for s in rng.integers(0, 2**62, size=params["pool"])]
        self.pages = rng.integers(0, params["pool"], size=n)
        lo, hi = params["stop_range"]
        even = np.linspace(lo, hi, n).round().astype(np.int64)
        self.stops = np.random.default_rng([int(lo), int(hi), n]).permutation(even)


def make(params: dict, seed: int) -> ParseQueue:
    return ParseQueue(params, seed)
