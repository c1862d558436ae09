"""Greedy NMS on padded box sets, on the device with static shapes.

Port of ``multimodal_embeddings_tpu/ops/nms.py`` (``nms_padded``,
``batched_nms_padded``): boxes go into stable descending-score order
(invalid rows last), and the greedy keep set is reached as the same Jacobi
fixpoint — ``keep_i = valid_i ∧ ¬∃ j<i (keep_j ∧ suppress_ji)`` — which
settles in (suppression-chain depth + 1) sweeps instead of N sequential
steps. Each sweep's convergence test reads one flag back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodal_embeddings_tpu_torch.ops.iou import iou_matrix


def batched_nms_padded(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    classes: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N) bool
    iou_threshold: float = 0.45,
    class_aware: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a batch of padded sets. Returns ``(keep, order)``:
    ``order`` is each set's descending-score permutation and ``keep[b, i]``
    says whether box ``order[b, i]`` survives; kept boxes in selection order
    are ``order[keep]``."""
    n = boxes.shape[1]
    sort_scores = torch.where(valid, scores, float("-inf"))
    order = torch.sort(sort_scores, dim=1, descending=True, stable=True)[1]
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    v = torch.gather(valid, 1, order)

    suppress = iou_matrix(b) > iou_threshold
    if class_aware:
        c = torch.gather(classes, 1, order)
        suppress &= c[:, :, None] == c[:, None, :]
    idx = torch.arange(n, device=boxes.device)
    # j kills i only when j ranks earlier; padding rows can't be killed and
    # dead rows never kill
    sup_earlier = suppress & (idx[:, None] < idx[None, :])
    sup_earlier &= v[:, None, :] & v[:, :, None]

    keep, prev = v, ~v
    for _ in range(n):
        if not bool((keep != prev).any()):
            break
        killed = (sup_earlier & keep[:, :, None]).any(dim=1)
        keep, prev = v & ~killed, keep
    return keep, order


def nms_padded(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.45,
    class_aware: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over one padded ``(N, 4)`` set; see ``batched_nms_padded``."""
    keep, order = batched_nms_padded(
        boxes[None], scores[None], classes[None], valid[None],
        iou_threshold=iou_threshold, class_aware=class_aware,
    )
    return keep[0], order[0]
