"""Pieces every driver uses: the run's record, weights drawn on the device
from the seed in one large call, the work a module does counted over the
benchmark's own reference, and spans that cost nothing when off."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import torch
from torch import nn


@dataclasses.dataclass
class RunResult:
    """What a run hands the metric readers (``metrics/<name>.py``) and the
    result line."""

    attempted: int = 0
    failed: int = 0
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)  # name → ms
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None  # benchlib.trace.Trace of the profiled span
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


class Clock:
    """Set-up's phases timed on the host clock (after a device sync), kept
    as notes for standard error."""

    def __init__(self, sync):
        self.sync, self.notes = sync, {}
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.notes[f"setup.{phase}_s"] = now - self.t
        self.t = now


def span(name: str, on: bool):
    """A host span in the profiler's trace, or nothing when ``on`` is
    false."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def init_stds(module: nn.Module, conv_gain=None):
    """``(tensor, std)`` for every parameter: convolutions LeCun-normal
    (``conv_gain(name)`` × 1/√fan-in), other matrices and position tables
    N(0, 0.02), biases 0, norm scales 1 (std None: a constant)."""
    out = []
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if isinstance(m, nn.Conv2d) and pname == "weight":
                gain = conv_gain(mname) if conv_gain else 1.0
                out.append((p, gain / math.sqrt(p[0].numel()), 0.0))
            elif pname == "bias":
                out.append((p, None, 0.0))
            elif pname == "scale":
                out.append((p, None, 1.0))
            else:
                out.append((p, 0.02, 0.0))
    return out


@torch.no_grad()
def fill_from_seed(leaves, generator: torch.Generator, device) -> None:
    """Fills ``(tensor, std, constant)`` leaves: one normal draw of every
    random leaf's elements on ``device``, sliced and scaled."""
    total = sum(p.numel() for p, std, _ in leaves if std is not None)
    buf = torch.randn(total, generator=generator, device=device)
    at = 0
    for p, std, const in leaves:
        if std is None:
            p.fill_(const)
        else:
            p.copy_(buf[at:at + p.numel()].view_as(p) * std)
            at += p.numel()


def count_flops(fn, *args) -> float:
    """Operations that ``fn(*args)`` asks for, counted by
    ``FlopCounterMode`` (matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def quantile(values, q: float) -> float:
    """The ``q`` quantile with linear interpolation between order
    statistics."""
    import numpy as np

    return float(np.quantile(np.asarray(values, np.float64), q))
