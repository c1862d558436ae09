"""Per-stage timing and traces: ``StageTimer``, ``trace`` and ``annotate``
of ``multimodal_embeddings_tpu/utils/profiling.py`` (``StageTimer``'s
``summary`` and ``log_summary`` are copies; ``tests/test_torch_pipeline.py``
holds the sources equal).

The reference's only measurement machinery is a stage-0 elapsed-time log
(``0_orientation.py:372-382``). Every stage of the cached runner is wrapped
in a ``StageTimer`` (wall time + throughput summary). The JAX ``stage`` is a
generator with ``try``/``finally``; here it is a context manager object
whose ``__exit__`` records the time, on an error too (the package keeps no
``try``).

``trace(log_dir)`` captures a run with ``torch.profiler`` (host ops, and the
card's kernels where there is a card) and writes one Chrome trace JSON into
``log_dir`` on the way out, on an error too; with no ``log_dir`` it does
nothing (JAX's writes a ``jax.profiler`` trace for tensorboard).
``annotate(name)`` is a named span in that trace
(``torch.profiler.record_function``, JAX's ``TraceAnnotation``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger

logger = get_logger("profiling")


class _StageSpan:
    """One ``StageTimer.stage`` block: its time is added on the way out."""

    def __init__(self, timer: "StageTimer", name: str, items: int):
        self.timer, self.name, self.items = timer, name, items
        self.start = 0.0

    def __enter__(self) -> None:
        self.start = time.perf_counter()

    def __exit__(self, *exc) -> None:
        self.timer.add(self.name, time.perf_counter() - self.start, self.items)


class StageTimer:
    """Accumulates named stage timings; prints a one-block summary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._order: List[str] = []

    def stage(self, name: str, items: int = 1) -> _StageSpan:
        return _StageSpan(self, name, items)

    def add(self, name: str, elapsed: float, items: int = 1) -> None:
        if name not in self.totals:
            self.totals[name] = 0.0
            self.counts[name] = 0
            self._order.append(name)
        self.totals[name] += elapsed
        self.counts[name] += items

    def summary(self) -> str:
        lines = ["stage timing summary:"]
        grand = sum(self.totals.values())
        for name in self._order:
            total = self.totals[name]
            count = self.counts[name]
            rate = count / total if total > 0 else 0.0
            lines.append(
                f"  {name:<28s} {total:8.2f}s  {count:5d} items "
                f"({rate:7.2f}/s, {100 * total / grand if grand else 0:4.1f}%)"
            )
        lines.append(f"  {'TOTAL':<28s} {grand:8.2f}s")
        return "\n".join(lines)

    def log_summary(self) -> None:
        logger.info("%s", self.summary())


class _Trace:
    """One ``trace`` block: a ``torch.profiler`` capture whose Chrome trace
    is written into ``log_dir`` on the way out."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self.profiler = None
        self.path: Optional[str] = None

    def __enter__(self) -> "_Trace":
        if not self.log_dir:
            return self
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profiler = torch.profiler.profile(activities=activities)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.profiler is None:
            return
        self.profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.path = os.path.join(self.log_dir, f"trace_{stamp}_{os.getpid()}.json")
        self.profiler.export_chrome_trace(self.path)
        logger.info("profiler trace written to %s", self.log_dir)


def trace(log_dir: Optional[str]) -> _Trace:
    """torch.profiler trace wrapper; no-op when ``log_dir`` is None."""
    return _Trace(log_dir)


def annotate(name: str) -> torch.profiler.record_function:
    """Named region in profiler traces (``record_function``)."""
    return torch.profiler.record_function(name)
