"""Internal-edge box filter (stage 2), batched on the device.

Port of ``multimodal_embeddings_tpu/ops/edge_filter.py::internal_edge_mask``:
a cell edge is internal when it lies more than ``threshold`` px from the
page edge, and a box is rejected when it comes within ``threshold`` px of an
internal edge (inclusive comparisons), in page coordinates.
"""

from __future__ import annotations

import torch


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
