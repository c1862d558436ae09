"""Column-center detection (stage 5): a copy of
``multimodal_embeddings_tpu/ops/columns.py`` (``tests/test_torch_stages.py``
holds the sources equal).

Signal-processing reproduction of ``find_column_centers``
(``5_detect_column_centers.py:91-224``): filter to confident text boxes,
build a triangular-weighted 1-D horizontal density map at
``page_width/1000``-px resolution, Gaussian-smooth it, find peaks
(height ≥ 0.2·max, distance ≥ median/(1.5·res), prominence ≥ 0.05·max), then
derive per-column widths from inter-peak local minima with median-based
clamping.

The density accumulation is vectorized with ``np.add.at`` over a
box-by-box-concatenated index array, which performs the same additions in
the same order as the reference's nested loops → bit-identical float64 map.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from multimodal_embeddings_tpu_torch.ops.peaks import find_peaks_np, smooth_density


def build_density_map(
    boxes: Sequence[Sequence[float]],
    page_width: int,
    median_width: float,
    min_width_ratio: float = 0.33,
    max_width_ratio: float = 2.0,
) -> Tuple[np.ndarray, int]:
    """Triangular-weighted horizontal density map
    (``5_detect_column_centers.py:118-144``). Returns ``(density, resolution)``."""
    resolution = max(1, int(page_width / 1000))
    num_bins = page_width // resolution + 1
    density = np.zeros(num_bins, dtype=np.float64)

    all_bins: list[np.ndarray] = []
    all_weights: list[np.ndarray] = []
    for box in boxes:
        x1 = int(box[0])
        x2 = int(box[2])
        width = x2 - x1
        if not (min_width_ratio * median_width <= width <= max_width_ratio * median_width):
            continue
        left_bin = max(0, x1 // resolution)
        right_bin = min(num_bins - 1, x2 // resolution)
        center_bin = (x1 + x2) // (2 * resolution)
        bins = np.arange(left_bin, right_bin + 1)
        dist = np.abs(bins - center_bin) / ((right_bin - left_bin) / 2 + 1e-6)
        weights = 1.0 - 0.5 * np.minimum(1.0, dist)
        all_bins.append(bins)
        all_weights.append(weights)

    if all_bins:
        np.add.at(density, np.concatenate(all_bins), np.concatenate(all_weights))
    return density, resolution


def column_widths_from_peaks(
    smoothed: np.ndarray,
    peaks: np.ndarray,
    resolution: int,
    median_width: float,
    min_peak_height: float,
) -> List[float]:
    """Column width per peak from inter-peak local minima, clamped to
    ``[median, 2·median]`` when outside ``[0.5·median, 2.5·median]``
    (``5_detect_column_centers.py:178-224``)."""
    widths: List[float] = []
    n = len(smoothed)
    for i, peak in enumerate(peaks):
        left_idx = peak
        if i > 0:
            prev_peak = peaks[i - 1]
            for j in range(peak - 1, prev_peak, -1):
                if j < 0 or j >= n:
                    continue
                if smoothed[j] < smoothed[left_idx]:
                    left_idx = j
                if smoothed[j] < min_peak_height * 0.1:
                    break
            if left_idx == peak:
                left_idx = (peak + prev_peak) // 2

        right_idx = peak
        if i < len(peaks) - 1:
            next_peak = peaks[i + 1]
            for j in range(peak + 1, next_peak):
                if j < 0 or j >= n:
                    continue
                if smoothed[j] < smoothed[right_idx]:
                    right_idx = j
                if smoothed[j] < min_peak_height * 0.1:
                    break
            if right_idx == peak:
                right_idx = (peak + next_peak) // 2

        width = (right_idx - left_idx) * resolution
        if width < 0.5 * median_width:
            width = median_width
        elif width > 2.5 * median_width:
            width = 2.0 * median_width
        widths.append(width)
    return widths


def find_column_centers(
    boxes: Sequence[Sequence[float]],
    class_names: Sequence[str],
    scores: Sequence[float],
    page_width: int,
    page_height: int,
    median_width: float,
    min_confidence: float = 0.3,
) -> Tuple[List[float], List[float]]:
    """Full stage-5 analysis; returns ``(column_centers, column_widths)``."""
    filtered = [
        box
        for box, name, score in zip(boxes, class_names, scores)
        if name in ("plain_text", "title") and score >= min_confidence
    ]
    if not filtered:
        return [], []

    density, resolution = build_density_map(filtered, page_width, median_width)

    window_size = max(5, int(median_width / (4 * resolution)))
    if window_size % 2 == 0:
        window_size += 1
    sigma = window_size / 6.0
    smoothed = smooth_density(density, window_size, sigma)

    min_peak_height = max(smoothed) * 0.2
    min_distance = max(1, int(median_width / (1.5 * resolution)))
    peaks, _ = find_peaks_np(
        smoothed,
        height=min_peak_height,
        distance=min_distance,
        prominence=max(smoothed) * 0.05,
    )
    if len(peaks) == 0:
        return [], []

    centers = [float(peak * resolution) for peak in peaks]
    widths = column_widths_from_peaks(
        smoothed, peaks, resolution, median_width, min_peak_height
    )
    return centers, [float(w) for w in widths]
