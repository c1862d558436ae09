"""Threaded data-loader: decode/prepare items ahead of device execution.

Port of ``multimodal_embeddings_tpu/io/prefetch.py`` with the same
semantics. ``Prefetcher`` maps ``fn`` over ``items`` on one worker thread,
``depth`` items ahead of the consumer, in order, so host preparation of page
N+1 overlaps the card's work on page N (CUDA launches return before the
kernels finish): decode (thread) → execute (device) → finalize (host).

The worker is a one-thread ``ThreadPoolExecutor`` holding a window of
``depth`` futures; the executor keeps what ``fn`` raised in its future. The
package keeps no ``try``, so an error reaches the consumer as a value:
``next_entry()`` gives ``(item, result, error)`` with a ``PrefetchError`` in
``error`` at the failed item's position, and iteration goes on after it.
``next()`` raises that ``PrefetchError`` instead, as the JAX iterator does.
Used as a context manager, it is closed on the way out, an error included.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Generic, Iterable, Iterator, Optional, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_END = object()


class PrefetchError(RuntimeError):
    """Wraps an exception raised while prefetching one item."""

    def __init__(self, item, cause: BaseException):
        super().__init__(f"prefetch failed on {item!r}: {cause}")
        self.item = item
        self.cause = cause


class Prefetcher(Generic[T, R]):
    """Iterate ``(item, fn(item))`` with ``depth`` items prepared ahead.

    ``depth=2`` keeps one result buffered while the consumer holds
    another — enough to hide preparation latency without unbounded
    memory growth (each prepared page can be a full padded uint8 canvas).
    """

    def __init__(self, items: Iterable[T], fn: Callable[[T], R], depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._items = iter(list(items))
        self._fn = fn
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._window: collections.deque = collections.deque()
        self._done = False
        for _ in range(depth):
            self._submit_next()

    def _submit_next(self) -> None:
        item = next(self._items, _END)
        if item is not _END:
            self._window.append((item, self._pool.submit(self._fn, item)))

    def next_entry(self) -> Optional[Tuple[T, Optional[R], Optional[PrefetchError]]]:
        """The next ``(item, result, None)``, or ``(item, None, error)`` for
        an item whose ``fn`` raised; None once the items (or the
        prefetcher) are done."""
        if self._done or not self._window:
            return None
        item, future = self._window.popleft()
        self._submit_next()
        cause = future.exception()
        if cause is not None:
            return item, None, PrefetchError(item, cause)
        return item, future.result(), None

    def __iter__(self) -> Iterator[Tuple[T, R]]:
        return self

    def __next__(self) -> Tuple[T, R]:
        """Raises PrefetchError for a failed item; the stream stays
        consumable — the next ``next()`` yields the following item."""
        entry = self.next_entry()
        if entry is None:
            raise StopIteration
        item, result, error = entry
        if error is not None:
            raise error from error.cause
        return item, result

    def __enter__(self) -> "Prefetcher[T, R]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the worker and join it; safe to call mid-iteration.
        Iteration after close() terminates."""
        self._done = True
        for _, future in self._window:
            future.cancel()
        self._window.clear()
        self._pool.shutdown(wait=True)
