"""Pairwise IoU on padded box sets (port of
``multimodal_embeddings_tpu/ops/iou.py::iou_matrix``).

Reference semantics: clamped intersection, union = a1 + a2 − inter, IoU 0
where the union is not positive, in float32.
"""

from __future__ import annotations

from typing import Optional

import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(..., N, 4)`` × ``(..., M, 4)`` xyxy → ``(..., N, M)``. All-zero
    padding rows have IoU 0 against everything."""
    a = boxes_a
    b = a if boxes_b is None else boxes_b
    x_left = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y_top = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x_right = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y_bottom = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x_right - x_left).clamp_min(0.0) * (y_bottom - y_top).clamp_min(0.0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0), 0.0)
