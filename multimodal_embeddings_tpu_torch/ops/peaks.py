"""1-D peak finding and Gaussian smoothing windows: a copy of
``multimodal_embeddings_tpu/ops/peaks.py`` (``tests/test_torch_stages.py``
holds the sources equal).

Self-contained reimplementation of the ``scipy.signal`` behavior the
reference depends on (``5_detect_column_centers.py:146-169``): a Gaussian
window (``scipy.signal.windows.gaussian``) and ``find_peaks`` with the
``height`` / ``distance`` / ``prominence`` conditions, applied in scipy's
documented order (local maxima → height → distance → prominence). Verified
bit-equal against scipy in tests; the framework itself does not import scipy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_window(m: int, std: float) -> np.ndarray:
    """``w[k] = exp(-0.5 * ((k - (m-1)/2) / std)^2)`` for ``k in [0, m)``."""
    n = np.arange(0, m, dtype=np.float64) - (m - 1.0) / 2.0
    sig2 = 2 * std * std
    return np.exp(-(n**2) / sig2)


def smooth_density(density: np.ndarray, window_size: int, sigma: float) -> np.ndarray:
    """Normalized-Gaussian smoothing via ``np.convolve(..., mode='same')``
    (``5_detect_column_centers.py:151-156``)."""
    win = gaussian_window(window_size, sigma)
    win = win / win.sum()
    return np.convolve(density, win, mode="same")


def _local_maxima(x: np.ndarray) -> np.ndarray:
    """Indices of local maxima; plateaus yield their (floor) midpoint.
    Endpoints can never be maxima."""
    mids = []
    i = 1
    i_max = x.shape[0] - 1
    while i < i_max:
        if x[i - 1] < x[i]:
            ahead = i + 1
            while ahead < i_max and x[ahead] == x[i]:
                ahead += 1
            if x[ahead] < x[i]:
                left_edge = i
                right_edge = ahead - 1
                mids.append((left_edge + right_edge) // 2)
                i = ahead
        i += 1
    return np.asarray(mids, dtype=np.intp)


def _select_by_distance(peaks: np.ndarray, priority: np.ndarray, distance: float) -> np.ndarray:
    """Highest-priority-first thinning: any peak strictly closer than
    ``ceil(distance)`` to an already-accepted higher-priority peak is dropped.
    Returns a keep mask over ``peaks`` (which must be sorted ascending)."""
    distance_ = int(np.ceil(distance))
    n = peaks.shape[0]
    keep = np.ones(n, dtype=bool)
    # Iterate peaks from highest priority to lowest; ties broken by position
    # order (argsort is stable, highest priority visited last → reverse).
    for j in np.argsort(priority, kind="stable")[::-1]:
        if not keep[j]:
            continue
        k = j - 1
        while k >= 0 and peaks[j] - peaks[k] < distance_:
            keep[k] = False
            k -= 1
        k = j + 1
        while k < n and peaks[k] - peaks[j] < distance_:
            keep[k] = False
            k += 1
    return keep


def peak_prominences(x: np.ndarray, peaks: np.ndarray) -> np.ndarray:
    """Prominence of each peak over the whole signal (no wlen): descend left
    and right until the signal exceeds the peak or the border is hit; the
    prominence is ``x[peak] - max(left_min, right_min)``."""
    proms = np.empty(peaks.shape[0], dtype=np.float64)
    n = x.shape[0]
    for idx, peak in enumerate(peaks):
        peak_height = x[peak]

        i = peak
        left_min = peak_height
        while i > 0 and x[i - 1] <= peak_height:
            i -= 1
            if x[i] < left_min:
                left_min = x[i]

        i = peak
        right_min = peak_height
        while i < n - 1 and x[i + 1] <= peak_height:
            i += 1
            if x[i] < right_min:
                right_min = x[i]

        proms[idx] = peak_height - max(left_min, right_min)
    return proms


def find_peaks_np(
    x: np.ndarray,
    height: float | None = None,
    distance: float | None = None,
    prominence: float | None = None,
) -> Tuple[np.ndarray, dict]:
    """``scipy.signal.find_peaks`` subset with identical condition order."""
    x = np.asarray(x, dtype=np.float64)
    if distance is not None and distance < 1:
        raise ValueError("`distance` must be greater or equal to 1")

    peaks = _local_maxima(x)
    props: dict = {}

    if height is not None:
        peak_heights = x[peaks]
        keep = peak_heights >= height
        peaks = peaks[keep]
        props["peak_heights"] = peak_heights[keep]

    if distance is not None:
        keep = _select_by_distance(peaks, x[peaks], distance)
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}

    if prominence is not None:
        proms = peak_prominences(x, peaks)
        keep = proms >= prominence
        peaks = peaks[keep]
        props = {k: v[keep] for k, v in props.items()}
        props["prominences"] = proms[keep]

    return peaks, props
