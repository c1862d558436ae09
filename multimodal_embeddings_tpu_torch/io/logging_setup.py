"""Structured logging: a copy of ``multimodal_embeddings_tpu/io/logging_setup.py``
(``tests/test_torch_serve.py`` holds the two sources equal).

File + console singleton like the reference (``logger_setup.py:9-23``) with
per-component child loggers instead of one global.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

_ROOT_NAME = "mmtpu"
_configured = False


def configure(log_file: Optional[str] = None, level: int = logging.INFO) -> None:
    """Idempotent for the console handler; a ``log_file`` is attached even
    when called after earlier configuration (module-level get_logger calls
    run at import time, long before CLIs pick their log file)."""
    global _configured
    root = logging.getLogger(_ROOT_NAME)
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not _configured:
        console = logging.StreamHandler()
        console.setFormatter(fmt)
        root.addHandler(console)
        root.propagate = False
        _configured = True
    if log_file:
        target = os.path.abspath(log_file)
        have = {
            getattr(h, "baseFilename", None)
            for h in root.handlers
            if isinstance(h, logging.FileHandler)
        }
        if target not in have:
            os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
            fh = logging.FileHandler(target)
            fh.setFormatter(fmt)
            root.addHandler(fh)


def get_logger(name: str) -> logging.Logger:
    if not _configured:
        configure()
    return logging.getLogger(f"{_ROOT_NAME}.{name}")
