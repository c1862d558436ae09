"""Checkpoint / resume tracking: a copy of
``multimodal_embeddings_tpu/io/progress.py`` (``tests/test_torch_serve.py``
holds the sources equal but for the load, and the files the two write
equal).

The reference keeps six independent JSON id-lists with a full
load-append-rewrite per item (``progress_tracker.py``, O(n²) over a run).
This tracker keeps the same on-disk artifact (a JSON list, so resume state
remains human-inspectable and reference-compatible) but holds an in-memory
set and appends in O(1), flushing the list on each mark. A file that does
not parse as a JSON list loads as no progress, as in the JAX package; the
load suppresses the parse error instead of catching it (the package keeps no
``try``).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import Iterable, List


class ProgressTracker:
    """One named phase's completed-id set, persisted as a JSON list."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._ids: List[str] = []
        self._set = set()
        if os.path.exists(path):
            with contextlib.suppress(ValueError, TypeError, OSError):
                with open(path, "r") as f:
                    ids = list(json.load(f))
                self._ids, self._set = ids, set(ids)

    def is_completed(self, item_id: str) -> bool:
        return item_id in self._set

    def mark_completed(self, item_id: str) -> None:
        with self._lock:
            if item_id in self._set:
                return
            self._set.add(item_id)
            self._ids.append(item_id)
            self._flush()

    def mark_many(self, item_ids: Iterable[str]) -> None:
        with self._lock:
            changed = False
            for item_id in item_ids:
                if item_id not in self._set:
                    self._set.add(item_id)
                    self._ids.append(item_id)
                    changed = True
            if changed:
                self._flush()

    def reset(self) -> None:
        with self._lock:
            self._ids, self._set = [], set()
            if os.path.exists(self.path):
                os.remove(self.path)

    def completed(self) -> List[str]:
        return list(self._ids)

    def _flush(self) -> None:
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._ids, f)
        os.replace(tmp, self.path)


# Phase names matching the reference's progress files
# (deprecated_package/config.py:40-44).
PHASES = (
    "processed_images",
    "cross_compare",
    "region_detection",
    "region_embedding",
    "region_comparison",
    "orientation",
)


def tracker_for(output_folder: str, phase: str) -> ProgressTracker:
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; expected one of {PHASES}")
    return ProgressTracker(os.path.join(output_folder, f"{phase}_progress.json"))
