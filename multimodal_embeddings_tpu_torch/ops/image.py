"""Resampling of the page program: view extraction and region crops as
dense matrix products on the device.

Port of ``multimodal_embeddings_tpu/ops/image.py``'s ``_interp_matrix``,
``resize_matmul``, ``extract_views_matmul``, ``letterbox_views_matmul`` and
``crop_and_resize_mxu``. Images are ``(H, W, C)`` / ``(B, H, W, C)`` as in
the JAX package. ``resize_bilinear_host`` is the one host resize of the
port (the detector's ``_letterbox_host``): the same interpolation matrices
on a numpy image.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# crops per crop_and_resize_mxu step (the JAX package's default chunk)
_CROP_CHUNK = 8


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix with half-pixel
    centres and edge clamping — row i holds the (≤2) source weights of
    output pixel i (cv2 INTER_LINEAR)."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = src - lo
    mat = np.zeros((out_size, in_size), np.float32)
    lo_c = np.clip(lo, 0, in_size - 1)
    hi_c = np.clip(lo + 1, 0, in_size - 1)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo_c), (1.0 - frac).astype(np.float32))
    np.add.at(mat, (rows, hi_c), frac.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=64)
def _interp_on(in_size: int, out_size: int, device: torch.device, dtype) -> torch.Tensor:
    """``_interp_matrix`` on ``device`` in ``dtype``, uploaded once: a copy
    from pageable host memory in the middle of a page would hold the host
    until the card's queued work is done."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(in_size, out_size)).to(device, dtype)


def resize_matmul(
    images: torch.Tensor, out_h: int, out_w: int, dtype=torch.float32
) -> torch.Tensor:
    """Bilinear resize ``(B, H, W, C) → (B, out_h, out_w, C)`` as two
    contractions with static interpolation matrices, each rounded to
    ``dtype`` (as the JAX version's ``preferred_element_type``)."""
    h, w = int(images.shape[1]), int(images.shape[2])
    ry = _interp_on(h, out_h, images.device, dtype)
    rx = _interp_on(w, out_w, images.device, dtype)
    tmp = torch.einsum("oh,bhwc->bowc", ry, images.to(dtype))
    return torch.einsum("pw,bowc->bopc", rx, tmp)


def resize_bilinear_host(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-centre, edge-clamped bilinear resize of an ``(H, W, C)``
    numpy image → ``(out_h, out_w, C)`` float32 (cv2 ``INTER_LINEAR``'s
    convention): the interpolation matrices of ``resize_matmul``, applied in
    float64."""
    h, w = image.shape[:2]
    ry = _interp_matrix(h, out_h).astype(np.float64)
    rx = _interp_matrix(w, out_w).astype(np.float64)
    img = np.asarray(image, np.float64)
    return np.einsum("oh,hwc,pw->opc", ry, img, rx, optimize=True).astype(np.float32)


def extract_views_matmul(
    page: torch.Tensor,
    view_bounds: List[Tuple[int, int, int, int]],
    out_size: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """All page views (full page and grid cells, ``(x0, y0, x1, y1)`` ints)
    as static slices + matmul resizes, one batched resize per distinct
    slice shape. Returns ``(V, out_size, out_size, C)`` in bound order."""
    groups: dict = {}
    for idx, (x0, y0, x1, y1) in enumerate(view_bounds):
        groups.setdefault((y1 - y0, x1 - x0), []).append((idx, x0, y0))

    slots = [None] * len(view_bounds)
    page = page.to(dtype)
    for (gh, gw), members in groups.items():
        stack = torch.stack([page[y0 : y0 + gh, x0 : x0 + gw] for _, x0, y0 in members])
        resized = resize_matmul(stack, out_size, out_size, dtype=dtype)
        for slot, (idx, _, _) in enumerate(members):
            slots[idx] = resized[slot]
    return torch.stack(slots)


def letterbox_views_matmul(
    page: torch.Tensor,
    view_bounds: List[Tuple[int, int, int, int]],
    out_size: int,
    pad_value: float = 114.0,
):
    """All page views (static slices) letterboxed on the device: an
    aspect-preserving matmul resize (f32) placed on a ``pad_value`` gray
    canvas at the host letterbox's round-half-even scale and ``//2``
    offsets, one batched resize per distinct slice shape.

    Returns ``(views (V, S, S, C) float32, metas)``, ``metas[i] = (scale,
    (pad_top, pad_left))`` per view, for ``scale_boxes_to_original``."""
    groups: dict = {}
    for idx, (x0, y0, x1, y1) in enumerate(view_bounds):
        groups.setdefault((y1 - y0, x1 - x0), []).append((idx, x0, y0))

    c = page.shape[2]
    slots = [None] * len(view_bounds)
    metas = [None] * len(view_bounds)
    for (gh, gw), members in groups.items():
        scale = min(out_size / gh, out_size / gw)
        new_h, new_w = int(round(gh * scale)), int(round(gw * scale))
        top = (out_size - new_h) // 2
        left = (out_size - new_w) // 2
        stack = torch.stack([page[y0 : y0 + gh, x0 : x0 + gw] for _, x0, y0 in members])
        canvas = torch.full((len(members), out_size, out_size, c), pad_value,
                            dtype=torch.float32, device=page.device)
        canvas[:, top : top + new_h, left : left + new_w] = resize_matmul(stack, new_h, new_w)
        for slot, (idx, _, _) in enumerate(members):
            slots[idx] = canvas[slot]
            metas[idx] = (scale, (top, left))
    return torch.stack(slots), metas


def crop_and_resize_mxu(
    image: torch.Tensor,  # (H, W, C)
    boxes: torch.Tensor,  # (N, 4) [x1, y1, x2, y2] pixel coordinates
    out_size: int = 448,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Bilinear, border-clamped crop+resize of N dynamic boxes → ``(N, S,
    S, C)`` f32. Vertically: two row gathers blended in ``compute_dtype``;
    horizontally: a per-crop hat-function matrix, contracted with f32
    accumulation. Crops run ``_CROP_CHUNK`` at a time to bound the
    ``(chunk, S, W, C)`` transient."""
    h, w = image.shape[0], image.shape[1]
    n = boxes.shape[0]
    dev = image.device
    imgf = image.to(compute_dtype)
    idx = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    cols = torch.arange(w, dtype=torch.float32, device=dev)

    def one_chunk(cb):
        b = cb.shape[0]
        x1, y1, x2, y2 = cb.unbind(dim=1)
        ch = (y2 - y1).clamp_min(1.0)
        cw = (x2 - x1).clamp_min(1.0)
        src_y = (y1[:, None] + idx[None, :] * ch[:, None] - 0.5).clamp(0.0, h - 1.0)
        src_x = (x1[:, None] + idx[None, :] * cw[:, None] - 0.5).clamp(0.0, w - 1.0)

        y0 = torch.floor(src_y)
        wy = (src_y - y0)[..., None, None].to(compute_dtype)
        y0i = y0.to(torch.int64).clamp(0, h - 1)
        y1i = (y0i + 1).clamp(0, h - 1)
        rows0 = imgf.index_select(0, y0i.reshape(-1)).reshape(b, out_size, w, -1)
        rows1 = imgf.index_select(0, y1i.reshape(-1)).reshape(b, out_size, w, -1)
        rows = rows0 * (1.0 - wy) + rows1 * wy  # (b, S, W, C)

        rx = (1.0 - (src_x[..., None] - cols).abs()).clamp_min(0.0)
        rx = rx.to(compute_dtype)  # (b, X, W)
        # products of compute_dtype values are exact in f32: f32 contraction
        return torch.einsum("bswc,bxw->bsxc", rows.float(), rx.float())

    pad = (-n) % _CROP_CHUNK
    boxes_p = F.pad(boxes.float(), (0, 0, 0, pad))
    outs = [
        one_chunk(boxes_p[i : i + _CROP_CHUNK]) for i in range(0, n + pad, _CROP_CHUNK)
    ]
    return torch.cat(outs)[:n]
