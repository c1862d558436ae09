"""Reduction of a ``torch.profiler`` window to what the per-layer metrics
and the result's ``device`` and ``breakdown`` read: the device operations
(kernels, copies, sets) with their times, the seconds in which any of them
ran (the union of their intervals, so kernels that overlap count once), the
operations that took most time, and the longest idle gaps named by what the
host was doing."""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Tuple

from benchlib.roofline import idle_gaps, union_seconds


class Trace:
    """A profiled window: ``ops`` are ``(name, start_s, end_s)`` device
    operations, times in seconds from the window's start."""

    def __init__(self, ops, host, window_s: float):
        self.ops: List[Tuple[str, float, float]] = ops
        self.host = host  # (name, start_s, end_s, is_span) host events
        self.window_s = window_s
        self.busy_s = union_seconds((s, e) for _, s, e in ops)

    def time_by_name(self) -> Dict[str, float]:
        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[name] += e - s
        return by

    def time_by_family(self) -> Dict[str, float]:
        from benchlib.families import family_of

        by: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            by[family_of(name)] += e - s
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def seconds(self, predicate) -> float:
        return sum(e - s for name, s, e in self.ops if predicate(name))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.time_by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = idle_gaps([(s, e) for _, s, e in self.ops], 0.0, self.window_s)[:top]
        return {
            "device_ops": [[name[:200], sec] for name, sec in ops],
            "idle_gaps": [[self._host_at((s + e) / 2), e - s] for s, e in gaps],
        }

    def _host_at(self, t: float) -> str:
        """The harness span and the innermost host operation running at
        ``t``, as ``span/op``."""
        import numpy as np

        if not hasattr(self, "_host_arrays"):
            self._host_arrays = (np.array([h[1] for h in self.host], np.float64),
                                 np.array([h[2] for h in self.host], np.float64),
                                 np.array([h[3] for h in self.host], bool))
        starts, ends, spans = self._host_arrays
        parts = []
        for want in (spans, ~spans):
            hit = np.nonzero((starts <= t) & (t <= ends) & want)[0]
            if len(hit):
                parts.append(self.host[hit[np.argmin(ends[hit] - starts[hit])]][0])
        return "/".join(parts) if parts else "host idle"


def from_profiler(prof, export_dir: str = None) -> Trace:
    """The device operations of a stopped ``torch.profiler.profile``; the
    window runs from its first to its last recorded event. With
    ``export_dir``, the Chrome trace is written there as ``trace.json``."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        start, end = e.start_ns(), e.end_ns()
        if end <= start:
            continue
        if e.device_type() == DeviceType.CUDA:
            device.append((e.name(), start, end, bool(e.is_user_annotation())))
        else:
            host.append((e.name(), start, end, bool(e.is_user_annotation())))
    # the device's copy of a host span covers kernels and the gaps between
    # them: not a device operation
    span_names = {h[0] for h in host if h[3]}
    device = [(n, s, e) for n, s, e, ann in device if not ann and n not in span_names]
    spans = [h for h in host if h[3]]
    t0 = min([s for _, s, _ in device] + [s for _, s, _, _ in spans] or [0])
    t1 = max([e for _, _, e in device] + [e for _, _, e, _ in spans] or [0])
    ops = [(n, (s - t0) / 1e9, (e - t0) / 1e9) for n, s, e in device]
    host = [(n, (s - t0) / 1e9, (e - t0) / 1e9, sp) for n, s, e, sp in host
            if e >= t0 and s <= t1]
    if export_dir:
        os.makedirs(export_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(export_dir, "trace.json"))
    return Trace(ops, host, (t1 - t0) / 1e9)
