"""Per-stage timing: ``StageTimer`` of
``multimodal_embeddings_tpu/utils/profiling.py`` (its ``summary`` and
``log_summary`` are copies; ``tests/test_torch_pipeline.py`` holds the
sources equal).

The reference's only measurement machinery is a stage-0 elapsed-time log
(``0_orientation.py:372-382``). Every stage of the cached runner is wrapped
in a ``StageTimer`` (wall time + throughput summary). The JAX ``stage`` is a
generator with ``try``/``finally``; here it is a context manager object
whose ``__exit__`` records the time, on an error too (the package keeps no
``try``).
"""

from __future__ import annotations

import time
from typing import Dict, List

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
