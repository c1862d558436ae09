"""Detection decoding: DFL expectation, anchors, one-to-one top-k and the
per-view padded NMS, all on the device with static shapes.

Port of ``multimodal_embeddings_tpu/models/yolo_decode.py``. Top-k keeps
``jax.lax.top_k``'s tie order (lower index first) through a stable
descending sort. ``scale_boxes_to_original`` (host numpy, float64) undoes a
letterbox.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.models.yolo import REG_MAX, STRIDES
from multimodal_embeddings_tpu_torch.ops.nms import batched_nms_padded


class Detections(NamedTuple):
    """Padded per-image detections."""

    boxes: torch.Tensor  # (B, max_det, 4) xyxy in model-input pixels
    scores: torch.Tensor  # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor  # (B, max_det) bool


def _anchors_for(shapes: Sequence[Tuple[int, int]]) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor centres (input pixels) and per-anchor stride over all levels."""
    points, strides = [], []
    for (h, w), s in zip(shapes, STRIDES):
        ys, xs = np.meshgrid(
            np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij"
        )
        points.append(np.stack([(xs + 0.5) * s, (ys + 0.5) * s], axis=-1).reshape(-1, 2))
        strides.append(np.full((h * w,), s, np.float32))
    return np.concatenate(points), np.concatenate(strides)


@functools.lru_cache(maxsize=16)
def _anchors_on(shapes: Tuple[Tuple[int, int], ...], device: torch.device):
    """``_anchors_for`` on ``device``, uploaded once per level layout (an
    upload after the detector's forward would hold the host until it is
    done)."""
    points, strides = _anchors_for(shapes)
    with torch.inference_mode(False):
        return torch.from_numpy(points).to(device), torch.from_numpy(strides).to(device)


def dfl_expectation(reg: torch.Tensor) -> torch.Tensor:
    """(…, 4·REG_MAX) logits → (…, 4) expected distances, in f32."""
    probs = torch.softmax(reg.reshape(*reg.shape[:-1], 4, REG_MAX).float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32, device=reg.device)
    return (probs * bins).sum(dim=-1)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties by lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def decode_predictions(
    level_outputs,  # per stride: (reg (B, h, w, 4·REG_MAX), cls (B, h, w, C))
    max_det: int = 300,
    conf_threshold: float = 0.1,
    iou_threshold: float = 0.45,
    with_nms: bool = True,
) -> Detections:
    """Raw head maps → padded detections, NMS'd and in selection order; with
    ``with_nms=False``, the one-to-one top-``max_det`` in top-k order with
    ``valid = score ≥ conf_threshold``."""
    regs, clss, shapes = [], [], []
    for reg, cls in level_outputs:
        b, h, w, _ = reg.shape
        shapes.append((h, w))
        regs.append(reg.reshape(b, h * w, -1))
        clss.append(cls.reshape(b, h * w, -1))
    reg = torch.cat(regs, dim=1)  # (B, A, 64)
    cls = torch.cat(clss, dim=1)  # (B, A, C)
    device = reg.device

    points, strides = _anchors_on(tuple(shapes), device)
    strides = strides[None, :, None]

    dist = dfl_expectation(reg)  # (B, A, 4) in stride units
    x1y1 = points[None] - dist[..., :2] * strides
    x2y2 = points[None] + dist[..., 2:] * strides
    boxes = torch.cat([x1y1, x2y2], dim=-1)

    probs = torch.sigmoid(cls.float())
    best_score, best_class = probs.max(dim=-1)
    best_class = best_class.to(torch.int32)

    k = min(max_det, best_score.shape[1])
    top_scores, top_idx = top_k(best_score, k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(best_class, 1, top_idx)
    valid = top_scores >= conf_threshold
    if not with_nms:
        return Detections(top_boxes, top_scores, top_classes, valid)
    keep, order = batched_nms_padded(
        top_boxes, top_scores, top_classes, valid,
        iou_threshold=iou_threshold, class_aware=False,
    )
    return Detections(
        torch.gather(top_boxes, 1, order[..., None].expand(-1, -1, 4)),
        torch.gather(top_scores, 1, order),
        torch.gather(top_classes, 1, order),
        keep,
    )


def scale_boxes_to_original(
    boxes: np.ndarray,
    scale: float,
    pad: Tuple[int, int],
    original_hw: Tuple[int, int],
) -> np.ndarray:
    """Undo letterboxing: model-input pixel boxes → original image coords,
    clipped to the image (ultralytics scale_boxes convention)."""
    pad_top, pad_left = pad
    out = boxes.astype(np.float64).copy()
    out[..., [0, 2]] -= pad_left
    out[..., [1, 3]] -= pad_top
    out /= scale
    h, w = original_hw
    out[..., [0, 2]] = np.clip(out[..., [0, 2]], 0, w)
    out[..., [1, 3]] = np.clip(out[..., [1, 3]], 0, h)
    return out
