"""Greedy non-maximum suppression (port of
``multimodal_embeddings_tpu/ops/nms.py``).

On the host: ``greedy_nms_np`` is the exact float64 greedy scan, a copy of
the JAX function (``tests/test_torch_stages.py`` holds the sources equal);
``greedy_nms_host``, which the stages call, runs the native C++ kernel
(bit-identical to it, held in tests), whose build raises where it fails.

On the device (``nms_padded``, ``batched_nms_padded``): boxes go into
stable descending-score order (invalid rows last), and the greedy keep set
is reached as the same Jacobi fixpoint —
``keep_i = valid_i ∧ ¬∃ j<i (keep_j ∧ suppress_ji)`` — which settles in
(suppression-chain depth + 1) sweeps instead of N sequential steps. Each
sweep's convergence test reads one flag back to the host.
``nms_indices_from_padded`` (a copy of the JAX function) turns a device
``(keep, order)`` pair into the kept indices in selection order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.ops.iou import iou_matrix, iou_matrix_np


def greedy_nms_host(
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray | None = None,
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """Host greedy NMS on the native C++ kernel (bit-identical to
    ``greedy_nms_np``, held in tests; its build raises where it fails).
    Production host callers use this; ``greedy_nms_np`` stays pure for
    parity testing."""
    from multimodal_embeddings_tpu_torch.utils.native import greedy_nms_native

    return greedy_nms_native(boxes, scores, classes, iou_threshold)


def greedy_nms_np(
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray | None = None,
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """Exact greedy NMS on the host. Returns kept indices in selection order
    (descending score, first index wins ties — matching
    ``scores_copy.index(max(scores_copy))`` at ``3_combine_grids.py:112``).

    ``classes=None`` gives torchvision-style class-agnostic behavior.
    """
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    scores = np.asarray(scores, dtype=np.float64).reshape(-1)
    n = boxes.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)

    iou = iou_matrix_np(boxes)
    if classes is not None:
        cls = np.asarray(classes, dtype=np.float64).reshape(-1)
        same = cls[:, None] == cls[None, :]
    else:
        same = np.ones((n, n), dtype=bool)
    suppress = (iou > iou_threshold) & same

    alive = np.ones(n, dtype=bool)
    keep: list[int] = []
    neg_inf = -np.inf
    masked = scores.copy()
    for _ in range(n):
        i = int(np.argmax(masked))  # first max index, like list.index(max(...))
        if not alive[i]:
            break
        keep.append(i)
        # Suppress same-class overlaps (the selected box suppresses itself too).
        dead = suppress[i] & alive
        dead[i] = True
        alive &= ~dead
        masked[dead] = neg_inf
        if not alive.any():
            break
    return np.asarray(keep, dtype=np.int64)


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


def nms_indices_from_padded(keep: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Convert a device ``(keep_mask, order)`` pair into kept original indices
    in selection order (the host-path return convention).

    ``keep`` is a mask over *sorted* positions (``keep[i]`` refers to box
    ``order[i]``) and sorted order is selection order, so the kept original
    indices in selection order are ``order`` at the true positions of ``keep``.
    """
    keep = np.asarray(keep)
    order = np.asarray(order)
    return order[np.nonzero(keep)[0]]
