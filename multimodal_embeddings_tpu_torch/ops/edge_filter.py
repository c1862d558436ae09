"""Internal-edge box filter (stage 2).

Port of ``multimodal_embeddings_tpu/ops/edge_filter.py``: a cell edge is
internal when it lies more than ``threshold`` px from the page edge, and a
box is rejected when it comes within ``threshold`` px of an internal edge
(inclusive comparisons), in page coordinates. ``internal_edge_mask_np`` is
the stage's host float64 copy (``tests/test_torch_stages.py`` holds the
sources equal); ``internal_edge_mask`` the batched device form.
"""

from __future__ import annotations

import numpy as np
import torch


def internal_edge_mask_np(
    boxes: np.ndarray,
    cell_bounds: tuple[float, float, float, float],
    image_width: float,
    image_height: float,
    threshold: float = 10.0,
) -> np.ndarray:
    """Boolean mask, True where the box touches an internal cell edge
    (i.e. should be removed). Exact float64 reproduction of the reference
    predicate including its comparison directions."""
    b = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    cx_min, cy_min, cx_max, cy_max = (float(v) for v in cell_bounds)

    right_internal = abs(cx_max - image_width) > threshold
    bottom_internal = abs(cy_max - image_height) > threshold
    left_internal = cx_min > threshold
    top_internal = cy_min > threshold

    touching = np.zeros(b.shape[0], dtype=bool)
    if right_internal:
        touching |= b[:, 2] >= (cx_max - threshold)
    if bottom_internal:
        touching |= b[:, 3] >= (cy_max - threshold)
    if left_internal:
        touching |= b[:, 0] <= (cx_min + threshold)
    if top_internal:
        touching |= b[:, 1] <= (cy_min + threshold)
    return touching


def internal_edge_mask(
    boxes: torch.Tensor,  # (..., N, 4) page-coordinate boxes
    cell_bounds: torch.Tensor,  # (..., 4) [x_start, y_start, x_end, y_end]
    image_size: torch.Tensor,  # (..., 2) [width, height]
    threshold: float = 10.0,
) -> torch.Tensor:
    """One cell per leading index; True = remove the box."""
    cx_min = cell_bounds[..., 0:1]
    cy_min = cell_bounds[..., 1:2]
    cx_max = cell_bounds[..., 2:3]
    cy_max = cell_bounds[..., 3:4]
    width = image_size[..., 0:1]
    height = image_size[..., 1:2]

    right_internal = (cx_max - width).abs() > threshold
    bottom_internal = (cy_max - height).abs() > threshold
    left_internal = cx_min > threshold
    top_internal = cy_min > threshold

    touching = right_internal & (boxes[..., 2] >= cx_max - threshold)
    touching |= bottom_internal & (boxes[..., 3] >= cy_max - threshold)
    touching |= left_internal & (boxes[..., 0] <= cx_min + threshold)
    touching |= top_internal & (boxes[..., 1] <= cy_min + threshold)
    return touching
