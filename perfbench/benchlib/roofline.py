"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work could take on it, and the work of the kernels the per-layer
metrics read. Counted from shapes alone, so a later change to the program
that computes the same work differently leaves every count as it is.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989 TFLOP/s
bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM. A card set
below 700 W reaches less; the run reports its power limit beside the shares.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """The least time the card could take: max(operations / the type's peak
    rate, bytes / the HBM rate), in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def attention_work(b: int, h: int, l: int, n: int, d: int, dv: int, elem: int = 2):
    """(operations, bytes) of one whole-row attention over ``n`` keys: the QK
    and PV products; q and o over ``l`` rows, k and v over ``n`` keys, each
    read or written once."""
    flops = 2.0 * b * h * l * n * (d + dv)
    nbytes = elem * b * h * (l * d + n * d + n * dv + l * dv)
    return flops, nbytes


def int4_matmul_work(m: int, k: int, n: int, group: int = 128, x_elem: int = 2):
    """(operations, bytes) of one int4 weight product ``(m, k) @ (k, n)``:
    2·m·k·n operations; x read once, the packed nibbles (k·n / 2 bytes) and
    the f32 scales (k / group · n) read once, y written once."""
    flops = 2.0 * m * k * n
    nbytes = x_elem * m * k + k * n / 2 + 4 * (k // group) * n + x_elem * m * n
    return flops, nbytes


def union_seconds(intervals) -> float:
    """Length covered by the union of ``(start, end)`` intervals (any unit
    in, the same unit out): kernels that overlap count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps in ``[start, end]`` that no interval covers, as ``(start,
    end)`` pairs, longest first."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
