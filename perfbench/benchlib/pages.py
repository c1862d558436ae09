"""Synthetic newspaper pages from a seed: dark text-line bands in six
columns over a paper background (a copy of the program's synthetic page
generator, kept with the benchmark so that the inputs stay fixed)."""

from __future__ import annotations

import numpy as np


def make_page(height: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    page = np.full((height, width, 3), 232, np.uint8)
    n_cols = 6
    col_w = width // n_cols
    for c in range(n_cols):
        x0 = c * col_w + col_w // 10
        x1 = (c + 1) * col_w - col_w // 10
        y = 40
        while y < height - 40:
            lh = int(rng.integers(8, 14))
            page[y : y + lh, x0:x1] = int(rng.integers(20, 60))
            y += lh + int(rng.integers(6, 12))
    return page
