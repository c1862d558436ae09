"""Skew-angle estimation on the device (stage 0).

Port of ``multimodal_embeddings_tpu/ops/skew.py``: the projection-profile
estimator. For each candidate angle, every edge pixel votes (bilinearly)
into the bin of its rotated row coordinate, and the profile's sharpness
(mean squared first difference) scores the angle; the true skew maximizes
it because text lines collapse into narrow peaks. The scan runs coarse →
fine (1° over ±45°, 91 angles; then 0.05° around the winner, 41 angles), all
on the input's device. Confidence = peak sharpness over the median of the
coarse scan; ``detect_skew`` gates on it.

The votes are added exactly: each one is rounded to a fixed-point integer
(2⁻³² steps) and the profile is an int64 ``index_add_``, so the sum does not
depend on the order in which the card's atomics land. Two runs on the card
give the same profile bit for bit, and so the same angle. JAX adds f32
votes in index order; the two profiles differ by f32 rounding (the CPU
tests hold the angles equal). Pixels without a vote (``edges == 0``) are
left out of the scatter, which adds only zeros for them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.ops.image import (
    adaptive_threshold_gaussian,
    edge_map,
    gaussian_blur,
    resize_bilinear,
    rgb_to_gray,
)

WORK_SIZE = 768  # static working resolution for the estimator
COARSE_RANGE = 45.0
COARSE_STEP = 1.0
FINE_STEP = 0.05
FINE_HALF_WIDTH = 1.0

_VOTE_SCALE = 2.0**32  # fixed-point step of one vote: 2^-32
_ANGLE_CHUNK = 32  # angles scored per scatter (bounds the (angles, voters) temporaries)


class SkewEstimate(NamedTuple):
    angle: torch.Tensor  # degrees; positive = text lines rotated CCW
    confidence: torch.Tensor  # peak/median sharpness ratio of the coarse scan


def _angles(start: float, stop: float, step: float, device) -> torch.Tensor:
    """``jnp.arange(start, stop, step, dtype=float32)`` on ``device``."""
    return torch.from_numpy(np.arange(start, stop, step, dtype=np.float32)).to(device)


def _profile_sharpness(edges: torch.Tensor, angles_deg: torch.Tensor) -> torch.Tensor:
    """Sharpness score per candidate angle.

    For angle θ each edge pixel votes (bilinearly) into the bin of its
    rotated row coordinate ``r = y·cosθ − x·sinθ``; the score is the mean
    squared first-difference of the resulting profile.
    """
    h, w = edges.shape
    device = edges.device
    n_bins = int(np.ceil(np.hypot(h, w))) + 2
    offset = (n_bins - 1) / 2.0
    flat_edges = edges.reshape(-1)
    voters = flat_edges.nonzero()[:, 0]
    ys_f = (voters // w).to(torch.float32) - (h - 1) / 2
    xs_f = (voters % w).to(torch.float32) - (w - 1) / 2
    weights = flat_edges[voters]

    scores = []
    for first in range(0, angles_deg.shape[0], _ANGLE_CHUNK):
        theta_deg = angles_deg[first : first + _ANGLE_CHUNK]
        n = theta_deg.shape[0]
        theta = theta_deg * (math.pi / 180.0)
        r = ys_f[None, :] * torch.cos(theta)[:, None] - xs_f[None, :] * torch.sin(theta)[:, None]
        r = r + offset
        r0 = torch.floor(r)
        frac = r - r0
        r0i = r0.to(torch.int64).clamp(0, n_bins - 1)
        r1i = (r0i + 1).clamp(0, n_bins - 1)
        row = torch.arange(n, device=device)[:, None] * n_bins
        votes0 = (weights * (1 - frac)).double() * _VOTE_SCALE
        votes1 = (weights * frac).double() * _VOTE_SCALE
        profile = torch.zeros(n * n_bins, dtype=torch.int64, device=device)
        profile.index_add_(0, (row + r0i).reshape(-1), torch.round(votes0).to(torch.int64).reshape(-1))
        profile.index_add_(0, (row + r1i).reshape(-1), torch.round(votes1).to(torch.int64).reshape(-1))
        profile = (profile.double() / _VOTE_SCALE).to(torch.float32).reshape(n, n_bins)
        diff = profile[:, 1:] - profile[:, :-1]
        scores.append((diff * diff).mean(dim=1))
    return torch.cat(scores)


def _estimate_skew_worked(gray_work: torch.Tensor, mask: torch.Tensor) -> SkewEstimate:
    """Core estimator on a fixed WORK_SIZE×WORK_SIZE grayscale canvas.

    ``mask`` zeroes edge votes outside the (aspect-preserved, centered)
    content region so the canvas border contributes no artificial
    axis-aligned lines.
    """
    blurred = gaussian_blur(gray_work, ksize=5, sigma=0.0)
    binary = adaptive_threshold_gaussian(blurred, block_size=11, c=2.0)
    edges = edge_map(binary, low=50.0, high=150.0) * mask

    coarse_angles = _angles(-COARSE_RANGE, COARSE_RANGE + COARSE_STEP, COARSE_STEP,
                            gray_work.device)
    coarse = _profile_sharpness(edges, coarse_angles)
    best_idx = torch.argmax(coarse)
    best_coarse = coarse_angles[best_idx]
    # jnp.median averages the two middle values, torch.median takes the
    # lower one: they agree on an odd count
    assert coarse.shape[0] % 2 == 1, coarse.shape
    confidence = coarse[best_idx] / (torch.median(coarse) + 1e-12)

    fine_angles = best_coarse + _angles(
        -FINE_HALF_WIDTH, FINE_HALF_WIDTH + FINE_STEP, FINE_STEP, gray_work.device
    )
    fine = _profile_sharpness(edges, fine_angles)
    best_fine = fine_angles[torch.argmax(fine)]
    return SkewEstimate(angle=best_fine, confidence=confidence)


@torch.inference_mode()
def detect_skew(
    image: np.ndarray,
    min_confidence: float = 1.6,
    max_abs_angle: float = 45.0,
    device="cuda",
) -> Optional[float]:
    """Estimate page skew in degrees; None when the estimate is unreliable
    (flat sharpness landscape — the analogue of the reference's std>10° and
    no-lines rejections, ``0_orientation.py:175-195``).

    Positive return value means the content is rotated counter-clockwise and
    the page should be rotated clockwise by the same amount to correct —
    the same sign convention as the reference's detector/corrector pair.
    ``image`` (H×W or H×W×3 RGB, uint8 or float) is uploaded once; the gray
    conversion, the resize and the scan run on ``device``.
    """
    device = resolve_device(device)
    arr = torch.from_numpy(np.require(image, requirements=["C", "W"])).to(device).to(torch.float32)
    if arr.ndim == 3:
        gray = rgb_to_gray(arr)
    else:
        gray = arr

    # Aspect-preserving placement onto the static canvas (a square resize
    # would distort the angle being measured).
    h, w = gray.shape
    scale = WORK_SIZE / max(h, w)
    new_h = max(1, int(round(h * scale)))
    new_w = max(1, int(round(w * scale)))
    resized = resize_bilinear(gray, new_h, new_w)
    canvas = torch.zeros((WORK_SIZE, WORK_SIZE), dtype=torch.float32, device=device)
    top = (WORK_SIZE - new_h) // 2
    left = (WORK_SIZE - new_w) // 2
    canvas[top : top + new_h, left : left + new_w] = resized
    mask = torch.zeros((WORK_SIZE, WORK_SIZE), dtype=torch.float32, device=device)
    inset = 4  # keep canvas-border transition edges out of the vote
    mask[top + inset : top + new_h - inset, left + inset : left + new_w - inset] = 1.0

    est = _estimate_skew_worked(canvas, mask)
    angle = float(est.angle)
    confidence = float(est.confidence)
    if confidence < min_confidence:
        return None
    if abs(angle) >= max_abs_angle:
        return None
    return angle
