"""Pages: a pool of distinct synthetic newspaper pages made from the seed,
and the order in which a run sends them.

Parameters (a traffic file of kind ``pages``): ``page_hw`` [height, width]
of every page, ``pool`` how many distinct pages, ``order_len`` how many
draws to make ahead (a run sends as many as its window takes, in this
order). The page generator is a copy of the program's synthetic page (dark
text-line bands in six columns over a paper background), so a seed always
gives the same pages."""

from __future__ import annotations

import numpy as np

from benchlib.pages import make_page


class Pages:
    """``pool[i]``: ``(H, W, 3)`` uint8 pages; ``order``: pool indices to
    send, in turn."""

    def __init__(self, params: dict, seed: int):
        rng = np.random.default_rng([seed, 1])
        h, w = params["page_hw"]
        page_seeds = rng.integers(0, 2**62, size=params["pool"])
        self.pool = [make_page(h, w, int(s)) for s in page_seeds]
        self.order = rng.integers(0, params["pool"], size=params.get("order_len", 100000))


def make(params: dict, seed: int) -> Pages:
    return Pages(params, seed)
