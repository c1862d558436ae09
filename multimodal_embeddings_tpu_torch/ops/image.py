"""Image ops on the device: stage 0's filters and warps, and the page
program's resampling as dense matrix products.

Port of ``multimodal_embeddings_tpu/ops/image.py``. Stage 0 (``ops/skew.py``,
``pipeline/orientation.py``): ``rgb_to_gray``, ``gaussian_blur``,
``adaptive_threshold_gaussian``, ``sobel_gradients``, ``edge_map``,
``bilinear_sample``, ``rotate_bound`` and ``resize_bilinear``, f32 tensor
functions on the input's device (``letterbox`` and ``crop_and_resize`` are
built on the last two). The separable filters are shifted f32
multiply-adds on the reflect-101 padded image, each product and sum its own
correctly rounded op: JAX runs them at ``Precision.HIGHEST`` because they
feed thresholds, and a convolution could run in TF32 on the card. The
page program: ``_interp_matrix``, ``resize_matmul``,
``extract_views_matmul``, ``letterbox_views_matmul`` and
``crop_and_resize_mxu``. Images are ``(H, W, C)`` / ``(B, H, W, C)`` as in
the JAX package. ``resize_bilinear_host`` is the one host resize of the
port (the detector's ``_letterbox_host``): the same interpolation matrices
on a numpy image.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# crops per crop_and_resize_mxu step (the JAX package's default chunk)
_CROP_CHUNK = 8


# ---------------------------------------------------------------------------
# Color / filtering (stage 0)
# ---------------------------------------------------------------------------


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (identical weights to cv2.cvtColor BGR2GRAY/RGB2GRAY)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array(
        [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125], np.float32
    ),
}


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics: fixed binomial kernels for
    sigma <= 0 with ksize <= 7, otherwise the derived-sigma Gaussian."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return _SMALL_GAUSSIAN[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _sep_filter(image: torch.Tensor, kx: np.ndarray, ky: np.ndarray) -> torch.Tensor:
    """Separable 2-D filter with reflect-101 padding (cv2's default border):
    one shifted f32 multiply-add per tap, rows then columns, taps in order.
    No convolution: the products stay f32 on any device (no TF32)."""
    h, w = image.shape
    pad_y, pad_x = len(ky) // 2, len(kx) // 2
    img = F.pad(image[None, None], (pad_x, pad_x, pad_y, pad_y), mode="reflect")[0, 0]
    out = None
    for i, tap in enumerate(ky.tolist()):
        term = tap * img[i : i + h, :]
        out = term if out is None else out + term
    img, out = out, None
    for i, tap in enumerate(kx.tolist()):
        term = tap * img[:, i : i + w]
        out = term if out is None else out + term
    return out


def gaussian_blur(image: torch.Tensor, ksize: int = 5, sigma: float = 0.0) -> torch.Tensor:
    k = _gaussian_kernel1d(ksize, sigma)
    return _sep_filter(image, k, k)


def adaptive_threshold_gaussian(
    image: torch.Tensor,
    block_size: int = 11,
    c: float = 2.0,
    max_value: float = 255.0,
    inverse: bool = True,
) -> torch.Tensor:
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY_INV)
    semantics: threshold = Gaussian-weighted local mean − C."""
    k = _gaussian_kernel1d(block_size, 0.0)
    local_mean = _sep_filter(image, k, k)
    thresh = local_mean - c
    if inverse:
        return torch.where(image > thresh, 0.0, max_value)
    return torch.where(image > thresh, max_value, 0.0)


def sobel_gradients(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx/dy (separable: smooth [1,2,1] ⊗ diff [-1,0,1])."""
    smooth = np.array([1.0, 2.0, 1.0], np.float32)
    diff = np.array([-1.0, 0.0, 1.0], np.float32)
    gx = _sep_filter(image, diff, smooth)
    gy = _sep_filter(image, smooth, diff)
    return gx, gy


def edge_map(image: torch.Tensor, low: float = 50.0, high: float = 150.0) -> torch.Tensor:
    """Canny-style strong-edge map: Sobel magnitude, 4-direction non-maximum
    suppression, double threshold with one-hop hysteresis (strong edges plus
    weak edges adjacent to strong ones), as the JAX function computes it."""
    gx, gy = sobel_gradients(image)
    mag = torch.hypot(gx, gy)
    angle = torch.atan2(gy, gx)

    # Quantize gradient direction into 4 sectors (0, 45, 90, 135 degrees);
    # a true division by the f32 constant (a Python divisor may become a
    # reciprocal multiply on the card)
    quarter = torch.tensor(math.pi / 4, dtype=angle.dtype, device=angle.device)
    sector = torch.round(angle / quarter).to(torch.int32) % 4

    def shift(arr, dy, dx):
        return torch.roll(arr, (dy, dx), dims=(0, 1))

    neighbors = [
        (shift(mag, 0, 1), shift(mag, 0, -1)),  # sector 0: horizontal
        (shift(mag, 1, 1), shift(mag, -1, -1)),  # sector 1: diagonal
        (shift(mag, 1, 0), shift(mag, -1, 0)),  # sector 2: vertical
        (shift(mag, 1, -1), shift(mag, -1, 1)),  # sector 3: anti-diagonal
    ]
    is_max = torch.zeros_like(mag, dtype=torch.bool)
    for s, (n1, n2) in enumerate(neighbors):
        is_max = torch.where(sector == s, (mag >= n1) & (mag >= n2), is_max)

    thin = torch.where(is_max, mag, 0.0)
    strong = thin >= high
    weak = thin >= low
    # One-hop hysteresis: dilate strong by 3x3 and intersect with weak.
    strong_f = strong.to(torch.float32)
    dilated = torch.zeros_like(strong_f)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dilated = torch.maximum(dilated, shift(strong_f, dy, dx))
    return (strong | (weak & (dilated > 0))).to(torch.float32)


# ---------------------------------------------------------------------------
# Geometric warps (stage 0)
# ---------------------------------------------------------------------------


def bilinear_sample(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an HxW(xC) image at float coordinates; out-of-range
    samples return 0 (cv2 BORDER_CONSTANT)."""
    h, w = image.shape[0], image.shape[1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    dy = ys - y0
    dx = xs - x0
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        vals = image[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        if image.ndim == 3:
            valid = valid[..., None]
        return torch.where(valid, vals, 0.0)

    w00 = (1 - dy) * (1 - dx)
    w01 = (1 - dy) * dx
    w10 = dy * (1 - dx)
    w11 = dy * dx
    if image.ndim == 3:
        w00, w01, w10, w11 = (wt[..., None] for wt in (w00, w01, w10, w11))
    return (
        gather(y0i, x0i) * w00
        + gather(y0i, x0i + 1) * w01
        + gather(y0i + 1, x0i) * w10
        + gather(y0i + 1, x0i + 1) * w11
    )


def rotate_bound_shape(h: int, w: int, angle_degrees: float) -> Tuple[int, int]:
    """Expanded canvas size for a no-crop rotation (imutils.rotate_bound
    convention: new_w = h|sin| + w|cos|, rounded via int())."""
    rad = math.radians(angle_degrees)
    cos, sin = abs(math.cos(rad)), abs(math.sin(rad))
    return int(h * cos + w * sin), int(h * sin + w * cos)


def _iota(out_h: int, out_w: int, dim: int, device) -> torch.Tensor:
    """``lax.broadcasted_iota(float32, (out_h, out_w), dim)``."""
    if dim == 0:
        return torch.arange(out_h, dtype=torch.float32, device=device)[:, None].expand(out_h, out_w)
    return torch.arange(out_w, dtype=torch.float32, device=device)[None, :].expand(out_h, out_w)


def rotate_bound(image: torch.Tensor, angle_degrees: float) -> torch.Tensor:
    """Rotate by ``angle_degrees`` (positive = counter-clockwise in image
    coordinates, matching cv2.getRotationMatrix2D) expanding the canvas so
    nothing is cropped; bilinear, black border.

    The reference applies ``imutils.rotate_bound(image, -detected_angle)``
    (``0_orientation.py:263``); note imutils' ``angle`` argument is clockwise,
    i.e. ``rotate_bound(img, a)`` here equals ``imutils.rotate_bound(img, -a)``.
    """
    h, w = int(image.shape[0]), int(image.shape[1])
    out_h, out_w = rotate_bound_shape(h, w, angle_degrees)
    rad = math.radians(angle_degrees)
    cos, sin = math.cos(rad), math.sin(rad)
    cx_in, cy_in = (w - 1) / 2.0, (h - 1) / 2.0
    cx_out, cy_out = (out_w - 1) / 2.0, (out_h - 1) / 2.0

    yy = _iota(out_h, out_w, 0, image.device) - cy_out
    xx = _iota(out_h, out_w, 1, image.device) - cx_out
    # Inverse rotation of output coords into input space.
    xs = cos * xx - sin * yy + cx_in
    ys = sin * xx + cos * yy + cy_in
    return bilinear_sample(image.to(torch.float32), ys, xs)


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel-centers bilinear resize (cv2.INTER_LINEAR convention).

    Coordinates are clamped to the image (border replicate) — cv2's resize
    behavior; zero-border sampling is only correct for warps.
    """
    h, w = image.shape[0], image.shape[1]
    sy, sx = h / out_h, w / out_w
    ys = (_iota(out_h, out_w, 0, image.device) + 0.5) * sy - 0.5
    xs = (_iota(out_h, out_w, 1, image.device) + 0.5) * sx - 0.5
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    return bilinear_sample(image.to(torch.float32), ys, xs)


def letterbox(
    image: torch.Tensor, size: int, pad_value: float = 114.0
) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Aspect-preserving resize onto a ``size``×``size`` canvas with centered
    gray padding (YOLO preprocessing convention). Returns
    ``(canvas, scale, (pad_top, pad_left))`` for box back-projection.

    Host-computed placement; the resize itself is on the input's device.
    """
    h, w = int(image.shape[0]), int(image.shape[1])
    scale = min(size / h, size / w)
    new_h = int(round(h * scale))
    new_w = int(round(w * scale))
    resized = resize_bilinear(image, new_h, new_w)
    pad_top = (size - new_h) // 2
    pad_left = (size - new_w) // 2
    canvas = torch.full(
        (size, size) + tuple(image.shape[2:]), pad_value, dtype=resized.dtype,
        device=resized.device,
    )
    canvas[pad_top : pad_top + new_h, pad_left : pad_left + new_w] = resized
    return canvas, scale, (pad_top, pad_left)


def crop_and_resize(
    image: torch.Tensor,  # (H, W, C)
    boxes: torch.Tensor,  # (N, 4) [x1, y1, x2, y2] pixel coords
    out_size: int = 448,
) -> torch.Tensor:
    """Batched region crops resampled to a fixed square: one gather-based
    bilinear sample gives all N crops as a single (N, S, S, C) f32 batch
    (the reference's per-region PIL crop + LANCZOS resize,
    ``doclayout_detector.py:165-194``, ``region_processor.py:115-117``).
    Samples outside the image are 0, as in JAX."""
    boxes = boxes.to(device=image.device, dtype=torch.float32)
    x1, y1, x2, y2 = (boxes[:, i, None, None] for i in range(4))
    h = torch.clamp(y2 - y1, min=1.0)
    w = torch.clamp(x2 - x1, min=1.0)
    ys = y1 + (_iota(out_size, out_size, 0, image.device) + 0.5) * (h / out_size) - 0.5
    xs = x1 + (_iota(out_size, out_size, 1, image.device) + 0.5) * (w / out_size) - 0.5
    return bilinear_sample(image.to(torch.float32), ys, xs)


# ---------------------------------------------------------------------------
# The page program's resampling
# ---------------------------------------------------------------------------


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
