"""ctypes bindings to the repo's native host kernels (``native/``).

Port of ``multimodal_embeddings_tpu/utils/native.py``: exact float64
greedy NMS, the IoU matrix, the edge-filter predicate, the masked cosine
top-k and the HNSW graph index (``HnswIndex``), from
``native/mmtpu_native.cpp`` and ``native/hnsw.cpp``.

At first use the two sources are compiled by ``g++`` with the flags of
``native/Makefile`` into ``_build/libmmtpu-<hash>.so`` (the build directory of
``kernels/_build.py``, git-ignored; the hash covers the sources and the
flags). The library tracked in ``native/`` is neither rebuilt nor loaded. A
failed build raises with the compiler's output: no binding returns None.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.kernels._build import PKG_DIR, build_library

logger = get_logger("native")

NATIVE_DIR = PKG_DIR.parent / "native"
SOURCES = ("mmtpu_native.cpp", "hnsw.cpp")
# native/Makefile's CXXFLAGS (-ffp-contract=off: float64 results bit-identical
# to the NumPy host path), plus -shared
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++17", "-Wall",
             "-shared")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile the native sources unless a library of the same sources and
    flags is already built; raises with g++'s output on failure."""
    return build_library("mmtpu", [NATIVE_DIR / name for name in SOURCES], CXX_FLAGS,
                         lambda: os.environ.get("CXX", "g++")).path


def load() -> ctypes.CDLL:
    """The native library, built and bound on the first call in the
    process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            c_double_p = ctypes.POINTER(ctypes.c_double)
            c_float_p = ctypes.POINTER(ctypes.c_float)
            c_i64_p = ctypes.POINTER(ctypes.c_int64)
            c_u8_p = ctypes.POINTER(ctypes.c_uint8)
            i64, dbl = ctypes.c_int64, ctypes.c_double
            signatures = {
                "greedy_nms": (i64, [c_double_p, c_double_p, c_double_p, i64, dbl, c_i64_p]),
                "iou_matrix": (None, [c_double_p, i64, c_double_p, i64, c_double_p]),
                "cosine_topk": (i64, [c_float_p, i64, i64, c_float_p, c_u8_p, i64, c_i64_p,
                                      c_float_p]),
                "internal_edge_mask": (None, [c_double_p, i64, c_double_p, dbl, dbl, dbl,
                                              c_u8_p]),
                "hnsw_new": (ctypes.c_void_p, [i64, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_uint64]),
                "hnsw_free": (None, [ctypes.c_void_p]),
                "hnsw_size": (i64, [ctypes.c_void_p]),
                "hnsw_add": (None, [ctypes.c_void_p, c_float_p, i64]),
                "hnsw_search": (i64, [ctypes.c_void_p, c_float_p, i64, i64, i64, c_u8_p,
                                      c_i64_p, c_float_p]),
            }
            for name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            logger.info("native host kernels loaded from %s", path)
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_nms_native(
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: Optional[np.ndarray],
    iou_threshold: float,
) -> np.ndarray:
    """Greedy NMS in float64: kept indices in selection order (descending
    score, the first index on a tie); class-aware when ``classes`` is
    given."""
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
    scores = np.ascontiguousarray(scores, np.float64)
    n = boxes.shape[0]
    keep = np.empty(n, np.int64)
    cls_ptr = None
    if classes is not None:
        classes = np.ascontiguousarray(classes, np.float64)
        cls_ptr = _ptr(classes, ctypes.c_double)
    count = lib.greedy_nms(
        _ptr(boxes, ctypes.c_double), _ptr(scores, ctypes.c_double), cls_ptr, n,
        float(iou_threshold), _ptr(keep, ctypes.c_int64),
    )
    return keep[:count]


def iou_matrix_native(
    boxes_a: np.ndarray, boxes_b: Optional[np.ndarray] = None
) -> np.ndarray:
    lib = load()
    a = np.ascontiguousarray(boxes_a, np.float64).reshape(-1, 4)
    b = a if boxes_b is None else np.ascontiguousarray(boxes_b, np.float64).reshape(-1, 4)
    out = np.empty((a.shape[0], b.shape[0]), np.float64)
    lib.iou_matrix(
        _ptr(a, ctypes.c_double), a.shape[0], _ptr(b, ctypes.c_double), b.shape[0],
        _ptr(out, ctypes.c_double),
    )
    return out


def cosine_topk_native(
    corpus: np.ndarray,
    query: np.ndarray,
    k: int,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force top-k of ``query · row`` over unit rows (float32, in
    sequence): ``(indices, similarities)``, best first, the lower index
    first on a tie; ``mask`` filters rows."""
    lib = load()
    corpus = np.ascontiguousarray(corpus, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    n, d = corpus.shape
    idx = np.empty(k, np.int64)
    sims = np.empty(k, np.float32)
    mask_ptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
        mask_ptr = _ptr(mask, ctypes.c_uint8)
    count = lib.cosine_topk(
        _ptr(corpus, ctypes.c_float), n, d, _ptr(query, ctypes.c_float),
        mask_ptr, k, _ptr(idx, ctypes.c_int64), _ptr(sims, ctypes.c_float),
    )
    return idx[:count], sims[:count]


def internal_edge_mask_native(
    boxes: np.ndarray,
    cell_bounds,
    image_width: float,
    image_height: float,
    threshold: float,
) -> np.ndarray:
    lib = load()
    boxes = np.ascontiguousarray(boxes, np.float64).reshape(-1, 4)
    cell = np.asarray(cell_bounds, np.float64)
    out = np.empty(boxes.shape[0], np.uint8)
    lib.internal_edge_mask(
        _ptr(boxes, ctypes.c_double), boxes.shape[0], _ptr(cell, ctypes.c_double),
        float(image_width), float(image_height), float(threshold),
        _ptr(out, ctypes.c_uint8),
    )
    return out.astype(bool)


class HnswIndex:
    """Native HNSW index over cosine space (``native/hnsw.cpp``), the
    in-repo equivalent of the reference's hnswlib dependency
    (``deprecated_package/db_operations.py:28-33``: space=cosine, M=32,
    ef_construction=200, ef=200). Labels are insertion order (the store
    maps them to ids)."""

    def __init__(self, dim: int, m: int = 32, ef_construction: int = 200, seed: int = 0):
        self._lib = load()
        self.dim = int(dim)
        self._handle = ctypes.c_void_p(
            self._lib.hnsw_new(self.dim, int(m), int(ef_construction), int(seed))
        )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.hnsw_free(handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.hnsw_size(self._handle))

    def add(self, vectors: np.ndarray) -> None:
        """Append rows (n, dim); normalized into the index (cosine)."""
        vecs = np.ascontiguousarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"rows of width {vecs.shape[1]}, index of width {self.dim}")
        self._lib.hnsw_add(self._handle, _ptr(vecs, ctypes.c_float), vecs.shape[0])

    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: int = 200,
        mask: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Filtered k-NN: returns (indices, cosine distances), each
        (nq, k); missing results are (-1, inf) padded (fewer than k nodes
        matching the mask)."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != self.dim:
            raise ValueError(f"queries of width {q.shape[1]}, index of width {self.dim}")
        nq = q.shape[0]
        idx = np.empty((nq, k), np.int64)
        dist = np.empty((nq, k), np.float32)
        mask_ptr = None
        if mask is not None:
            mask = np.ascontiguousarray(mask, np.uint8)
            if mask.shape[0] != len(self):
                raise ValueError(f"mask of {mask.shape[0]} rows, index of {len(self)}")
            mask_ptr = _ptr(mask, ctypes.c_uint8)
        self._lib.hnsw_search(
            self._handle, _ptr(q, ctypes.c_float), nq, int(k), int(max(ef, k)), mask_ptr,
            _ptr(idx, ctypes.c_int64), _ptr(dist, ctypes.c_float),
        )
        return idx, dist
