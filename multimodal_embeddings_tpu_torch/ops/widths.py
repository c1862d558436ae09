"""Text-width binning and median extraction (stage 4): a copy of
``multimodal_embeddings_tpu/ops/widths.py`` (``tests/test_torch_stages.py``
holds the sources equal).

Reference semantics (``4_extract_median_widths.py:49-101``): widths are
greedily first-fit into bins whose keys are the first width seen for that
bin; candidate bins are scanned in ascending key order and a width joins the
first bin within ``min_margin = page_width * margin% / 100``. The median is
taken over the count-expanded bin keys.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def bin_widths(
    widths: Sequence[float], min_margin_percent: float, page_width: float
) -> Dict[float, int]:
    """Greedy first-fit width binning; exact reference behavior including
    insertion-order-sensitive bin keys."""
    if not widths:
        return {}
    min_margin = page_width * (min_margin_percent / 100)
    bins: Dict[float, int] = {}
    for width in widths:
        assigned = False
        for bin_width in sorted(bins.keys()):
            if abs(width - bin_width) <= min_margin:
                bins[bin_width] += 1
                assigned = True
                break
        if not assigned:
            bins[width] = 1
    return bins


def median_from_bins(bins: Dict[float, int]) -> float:
    """Median over count-expanded bin keys (``np.median``), 0 for empty.

    Expansion iterates the dict in insertion order, matching
    ``4_extract_median_widths.py:96-98`` — np.median sorts internally so the
    iteration order only matters for bit-level reproducibility of ties.
    """
    if not bins:
        return 0
    expanded = []
    for width, count in bins.items():
        expanded.extend([width] * count)
    return float(np.median(expanded))


def plain_text_widths(boxes: Sequence[Sequence[float]], class_names: Sequence[str]) -> list[float]:
    """Widths of ``plain_text`` boxes in input order
    (``4_extract_median_widths.py:134-141``)."""
    out = []
    for i, name in enumerate(class_names):
        if name == "plain_text" and i < len(boxes):
            box = boxes[i]
            out.append(box[2] - box[0])
    return out
