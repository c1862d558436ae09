"""Pairwise IoU (port of ``multimodal_embeddings_tpu/ops/iou.py``).

Reference semantics: clamped intersection, union = a1 + a2 − inter, IoU 0
where the union is not positive. ``iou_matrix_np`` is the host float64 copy
(``tests/test_torch_stages.py`` holds the sources equal); ``iou_matrix`` is
the same math in float32 on padded device tensors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def iou_matrix_np(boxes_a: np.ndarray, boxes_b: np.ndarray | None = None) -> np.ndarray:
    """Exact float64 IoU matrix between two box sets ``[x1, y1, x2, y2]``.

    Matches the reference's scalar expression order so results are
    bit-identical to looping ``calculate_iou`` over all pairs.
    """
    a = np.asarray(boxes_a, dtype=np.float64)
    b = a if boxes_b is None else np.asarray(boxes_b, dtype=np.float64)
    a = a.reshape(-1, 4)
    b = b.reshape(-1, 4)

    x_left = np.maximum(a[:, None, 0], b[None, :, 0])
    y_top = np.maximum(a[:, None, 1], b[None, :, 1])
    x_right = np.minimum(a[:, None, 2], b[None, :, 2])
    y_bottom = np.minimum(a[:, None, 3], b[None, :, 3])

    inter = np.maximum(0.0, x_right - x_left) * np.maximum(0.0, y_bottom - y_top)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


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
