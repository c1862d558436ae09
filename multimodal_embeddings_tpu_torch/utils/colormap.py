"""Bit-plane colormap shared by all visualizations: a copy of
``multimodal_embeddings_tpu/utils/colormap.py`` (``tests/test_torch_stages.py``
holds the sources equal).

Same palette construction as the reference's repeated ``colormap`` helper
(``1_doclayout_bboxes.py:244-271`` and duplicates): color ``i`` packs the
bits of ``i`` across R/G/B from MSB down, giving the familiar PASCAL-VOC
label palette.
"""

from __future__ import annotations

import numpy as np


def colormap(n: int = 256, normalized: bool = False) -> np.ndarray:
    ids = np.arange(n, dtype=np.uint32)
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for j in range(8):
        cmap[:, 0] |= (((ids >> 0) & 1) << (7 - j)).astype(np.uint8)
        cmap[:, 1] |= (((ids >> 1) & 1) << (7 - j)).astype(np.uint8)
        cmap[:, 2] |= (((ids >> 2) & 1) << (7 - j)).astype(np.uint8)
        ids >>= 3
    if normalized:
        return cmap.astype(np.float32) / 255.0
    return cmap
