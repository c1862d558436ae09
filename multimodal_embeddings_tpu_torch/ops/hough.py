"""Host-side NumPy re-derivation of the reference's Hough skew chain.

A copy of ``multimodal_embeddings_tpu/ops/hough.py`` (NumPy only;
``tests/test_torch_analysis.py`` holds the sources equal and the angles
equal on rotated synthetic pages).

The reference's primary skew estimator is OpenCV:
Gaussian blur (5×5) → adaptive Gaussian threshold (11, C=2, BINARY_INV) →
Canny (50, 150, aperture 3) → probabilistic Hough segments (1px, 1°,
votes ≥ 100, minLineLength = min(W//2, 200), maxLineGap = 10) → median
segment angle with |angle| < 45° per-line filter and a std < 10°
reliability gate (the reference's ``0_orientation.py:131-201``).

This module re-derives that chain with deterministic NumPy — no OpenCV —
as the test oracle bounding the projection-profile estimator's
(``ops/skew.py``) disagreement with the reference algorithm, and as a
dependency-free estimator. The one deliberate difference:
``cv2.HoughLinesP`` samples edge points in random order; here peaks are
taken from the full (deterministic) accumulator in descending vote order
and segments are traced along each peak line with the same min-length /
max-gap semantics, so results are reproducible.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# cv2's fixed small-aperture Gaussian coefficients (getGaussianKernel with
# sigma<=0 and ksize<=7 uses the binomial table; 5 taps = [1,4,6,4,1]/16)
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        if ksize <= 7:
            pascal = {1: [1.0], 3: [1, 2, 1], 5: [1, 4, 6, 4, 1],
                      7: [1, 6, 15, 20, 15, 6, 1]}[ksize]
            k = np.asarray(pascal, np.float64)
            return k / k.sum()
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return k / k.sum()


def _sepconv(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable correlation with BORDER_REFLECT_101 (cv2's default)."""
    pad = len(k) // 2
    out = np.asarray(img, np.float64)
    for axis in (0, 1):
        width = [(pad, pad) if i == axis else (0, 0) for i in range(2)]
        ap = np.pad(out, width, mode="reflect")
        acc = np.zeros_like(out)
        for i, kv in enumerate(k):
            sl = [slice(None)] * 2
            sl[axis] = slice(i, i + out.shape[axis])
            acc += kv * ap[tuple(sl)]
        out = acc
    return out


def gaussian_blur5(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (5, 5), 0) equivalent."""
    return _sepconv(img, _K5)


def adaptive_threshold_inv(
    img: np.ndarray, block_size: int = 11, c: float = 2.0
) -> np.ndarray:
    """cv2.adaptiveThreshold(..., ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY_INV, block_size, c): 255 where src <= local Gaussian
    mean − c, else 0."""
    sigma = 0.3 * ((block_size - 1) * 0.5 - 1) + 0.8
    mean = _sepconv(img, _gaussian_kernel1d(block_size, sigma))
    return np.where(np.asarray(img, np.float64) <= mean - c, 255.0, 0.0)


def canny(
    img: np.ndarray, low: float = 50.0, high: float = 150.0
) -> np.ndarray:
    """Canny edges, aperture-3 Sobel, L1 magnitude (cv2's default), 4-sector
    non-max suppression, hysteresis by strong→weak flood fill."""
    a = np.pad(np.asarray(img, np.float64), 1, mode="reflect")
    # Sobel x/y (correlation form): gx = [[-1,0,1],[-2,0,2],[-1,0,1]]
    gx = (
        (a[:-2, 2:] + 2 * a[1:-1, 2:] + a[2:, 2:])
        - (a[:-2, :-2] + 2 * a[1:-1, :-2] + a[2:, :-2])
    )
    gy = (
        (a[2:, :-2] + 2 * a[2:, 1:-1] + a[2:, 2:])
        - (a[:-2, :-2] + 2 * a[:-2, 1:-1] + a[:-2, 2:])
    )
    mag = np.abs(gx) + np.abs(gy)

    # sector quantization exactly as cv2: tan(22.5°) boundaries
    tg22 = 0.4142135623730951
    ax, ay = np.abs(gx), np.abs(gy)
    horiz = ay < tg22 * ax          # gradient ~horizontal → compare L/R
    vert = ay > (1 / tg22) * ax     # gradient ~vertical → compare U/D
    diag = ~(horiz | vert)
    same_sign = (gx * gy) >= 0

    m = np.pad(mag, 1, mode="constant")
    c0 = m[1:-1, 1:-1]
    nbr = {
        "l": m[1:-1, :-2], "r": m[1:-1, 2:],
        "u": m[:-2, 1:-1], "d": m[2:, 1:-1],
        "ul": m[:-2, :-2], "ur": m[:-2, 2:],
        "dl": m[2:, :-2], "dr": m[2:, 2:],
    }
    keep = np.zeros_like(c0, bool)
    keep |= horiz & (c0 > nbr["l"]) & (c0 >= nbr["r"])
    keep |= vert & (c0 > nbr["u"]) & (c0 >= nbr["d"])
    keep |= diag & same_sign & (c0 > nbr["ul"]) & (c0 >= nbr["dr"])
    keep |= diag & ~same_sign & (c0 > nbr["ur"]) & (c0 >= nbr["dl"])

    strong = keep & (mag >= high)
    weak = keep & (mag >= low)
    # hysteresis: iterative dilation of strong within weak
    out = strong.copy()
    while True:
        p = np.pad(out, 1, mode="constant")
        grown = (
            p[:-2, :-2] | p[:-2, 1:-1] | p[:-2, 2:]
            | p[1:-1, :-2] | p[1:-1, 2:]
            | p[2:, :-2] | p[2:, 1:-1] | p[2:, 2:]
        )
        new = out | (weak & grown)
        if new.sum() == out.sum():
            break
        out = new
    return out.astype(np.float64)


def hough_segments(
    edges: np.ndarray,
    threshold: int = 100,
    min_line_length: float = 100.0,
    max_line_gap: float = 10.0,
    max_peaks: int = 200,
) -> List[Tuple[float, float, float, float]]:
    """Deterministic probabilistic-Hough surrogate: accumulate all edge
    points over 180 1° theta bins × 1px rho bins; repeatedly take the
    highest-vote line, trace its points (sorted along the line) into
    segments split at gaps > ``max_line_gap``, keep segments longer than
    ``min_line_length``, remove their points, and re-accumulate."""
    ys, xs = np.nonzero(edges)
    if len(xs) == 0:
        return []
    thetas = np.deg2rad(np.arange(0.0, 180.0))
    cos_t, sin_t = np.cos(thetas), np.sin(thetas)
    h, w = edges.shape
    diag = int(np.ceil(np.hypot(h, w)))

    alive = np.ones(len(xs), bool)
    segments: List[Tuple[float, float, float, float]] = []

    # (npts, 180) rho-bin index table, built once
    rho_idx = np.rint(
        xs[:, None] * cos_t[None, :] + ys[:, None] * sin_t[None, :]
    ).astype(np.int32) + diag
    n_rho = 2 * diag + 1

    for _ in range(max_peaks):
        idx = np.nonzero(alive)[0]
        if len(idx) < threshold:
            break
        acc = np.zeros((180, n_rho), np.int32)
        cols = rho_idx[idx]
        for t in range(180):
            acc[t] = np.bincount(cols[:, t], minlength=n_rho)
        t_best, r_best = np.unravel_index(np.argmax(acc), acc.shape)
        if acc[t_best, r_best] < threshold:
            break
        # cv2's segment walk rasterizes the line and accepts edge pixels on
        # it — an effective ~1px corridor, wider than one rho bin
        on_line = idx[np.abs(cols[:, t_best] - r_best) <= 1]
        # order along the line direction (−sinθ, cosθ)
        t_pos = -xs[on_line] * sin_t[t_best] + ys[on_line] * cos_t[t_best]
        order = np.argsort(t_pos)
        on_line = on_line[order]
        t_sorted = t_pos[order]
        gaps = np.nonzero(np.diff(t_sorted) > max_line_gap)[0]
        starts = np.concatenate([[0], gaps + 1])
        ends = np.concatenate([gaps, [len(t_sorted) - 1]])
        for s, e in zip(starts, ends):
            if t_sorted[e] - t_sorted[s] >= min_line_length:
                i0, i1 = on_line[s], on_line[e]
                x1, y1, x2, y2 = xs[i0], ys[i0], xs[i1], ys[i1]
                if x2 < x1:  # x-ascending endpoints → angles in (−90, 90]
                    x1, y1, x2, y2 = x2, y2, x1, y1
                segments.append((float(x1), float(y1), float(x2), float(y2)))
        # guarantee progress: all points of this line leave the pool
        alive[on_line] = False
    return segments


def detect_skew_hough(
    gray: np.ndarray,
    sensitivity_unused: float = 0.5,
) -> Optional[float]:
    """The reference's detect_skew_opencv decision chain, deterministically:
    median of |angle| < 45° segment angles, None when no segments survive or
    the angle spread exceeds the std < 10° reliability gate
    (``0_orientation.py:175-195``)."""
    gray = np.asarray(gray, np.float64)
    if gray.ndim == 3:
        # cv2 grayscale read: ITU-R BT.601 luma
        gray = gray @ np.array([0.299, 0.587, 0.114])
    blurred = gaussian_blur5(gray)
    binary = adaptive_threshold_inv(blurred, 11, 2.0)
    edges = canny(binary, 50.0, 150.0)
    min_len = min(gray.shape[1] // 2, 200)
    segs = hough_segments(
        edges, threshold=100, min_line_length=min_len, max_line_gap=10.0
    )
    angles = []
    for x1, y1, x2, y2 in segs:
        ang = np.degrees(np.arctan2(y2 - y1, x2 - x1))
        if abs(ang) < 45.0:
            angles.append(ang)
    if not angles:
        return None
    arr = np.asarray(angles)
    if arr.std() > 10.0:
        return None
    return float(np.median(arr))
