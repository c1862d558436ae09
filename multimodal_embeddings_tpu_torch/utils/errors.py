"""Errors held as values on the host.

The JAX package's stages catch every exception per file or per page, log
it and go on (``pipeline/stages.py``, ``pipeline/detect.py``,
``pipeline/orientation.py``). The port keeps no ``try``: ``Held`` is
``contextlib.suppress(Exception)`` that keeps what it suppressed, so the
stage logs the same line and counts the same error. Only host work goes in
its block (JSON reads and writes, image decode and encode, drawing, host
float64 math); a call that launches work on the card is never held, so a
failure there stops the run.
"""

from __future__ import annotations

import contextlib
from typing import Optional


class Held(contextlib.suppress):
    """``with Held() as held: ...`` then ``held.error``: the exception the
    block raised, or None."""

    def __init__(self):
        super().__init__(Exception)
        self.error: Optional[Exception] = None

    def __enter__(self) -> "Held":
        return self

    def __exit__(self, exctype, excinst, exctb) -> bool:
        suppressed = bool(super().__exit__(exctype, excinst, exctb))
        if suppressed:
            self.error = excinst
        return suppressed
