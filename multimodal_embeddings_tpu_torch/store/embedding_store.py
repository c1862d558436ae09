"""Embedding store: exact cosine top-k retrieval with metadata filters.

Port of ``multimodal_embeddings_tpu/store/embedding_store.py`` (which
replaces ChromaDB/hnswlib, ``db_operations.py:17-61``), with the same API
and the same persistence: one ``collection.npz`` per collection directory
(``embeddings`` float32, ``ids_json``, ``metadata_json``) replaced
atomically, so each package loads the other's files.

* ``initialize_db(path) -> (client, collection)``
  (``db_operations.py:17-61``);
* ``collection.upsert/get/query/count/delete`` with ``where`` filters
  supporting ``{"field": {"$eq"|"$ne"|"$in": v}}``, ``{"field": v}``,
  ``{"$and": [...]}`` and ``{"$or": [...]}``;
* ``get_embedding_from_db(collection, id)`` (``db_operations.py:65-85``).

Exact retrieval runs on the collection's device (the card unless the caller
asks for the CPU): the unit-normalised corpus is cached there, and a query
batch is one f32 ``torch.matmul`` of the unit queries by the corpus, the
rows outside the filter set to −2, and one ``torch.topk`` over a key that
orders by similarity, then by the lower row index on a tie — the order of
``jax.lax.top_k`` and of the native ``cosine_topk``, which ``torch.topk``
alone does not promise on CUDA. k is not rounded up to a power of two (the
JAX store does so to bound its compiled programs); the sharded query
rounds it, as JAX's ``_sharded_query`` does, then cuts it to k. ``index="hnsw"`` walks
the native graph index (``utils/native.py::HnswIndex``) built with the
collection's ``hnsw:*`` metadata; without the native library it raises.
Distances are cosine distances (1 − cosine similarity).

``set_mesh(mesh)`` shards the corpus rows over the mesh's data axis, as the
JAX store does: each rank of the mesh keeps one contiguous block of the
zero-padded rows on its device, scores it by one f32 matmul and a local
top-k, and the ranks all-gather k candidates each (never the score matrix)
for a final top-k (``sharded_masked_topk``). Every rank of the mesh runs the
same ``query``; each gets the single-device answer, ties included.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = get_logger("store")

DEFAULT_COLLECTION = "newspaper_image_embeddings"
HNSW_COMPAT_METADATA = {
    "hnsw:space": "cosine",
    "hnsw:M": 32,
    "hnsw:construction_ef": 200,
    "hnsw:search_ef": 200,
}
# rows outside a query's filter score below every cosine similarity
_MASKED = -2.0
_LOW31 = (1 << 31) - 1


def _matches(meta: Dict[str, Any], where: Optional[Dict[str, Any]]) -> bool:
    if not where:
        return True
    for key, cond in where.items():
        if key == "$and":
            if not all(_matches(meta, c) for c in cond):
                return False
        elif key == "$or":
            if not any(_matches(meta, c) for c in cond):
                return False
        elif isinstance(cond, dict):
            for op, val in cond.items():
                value = meta.get(key)
                if op == "$eq" and value != val:
                    return False
                if op == "$ne" and value == val:
                    return False
                if op == "$in" and value not in val:
                    return False
        else:
            if meta.get(key) != cond:
                return False
    return True


def masked_topk(corpus: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor, k: int):
    """(N, D) unit corpus × (Q, D) unit queries → the top-k ``(similarities,
    indices)`` among mask-true rows, each (Q, k): descending similarity, the
    lower index first on a tie."""
    sims = torch.matmul(queries, corpus.T)
    sims = torch.where(mask[None, :], sims, _MASKED)
    rows = torch.arange(sims.shape[1], device=sims.device, dtype=torch.int64)
    pos = _ordered_topk(sims, rows.expand_as(sims), k)
    return torch.gather(sims, 1, pos), pos


def _ordered_topk(sims: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of the top-k of each row of ``sims`` (Q, M): descending
    similarity, the lower ``rows`` entry (Q, M), a non-negative row index
    below 2³¹, first on a tie.

    The tie order is made explicit: each similarity's f32 bits are mapped to
    an int32 of the same order, shifted up by 31 bits, and the complement of
    the row index fills the low 31 bits, so every key is distinct and
    ``torch.topk`` over the int64 keys has one answer."""
    bits = sims.view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ _LOW31, bits).to(torch.int64)
    keys = (ordered << 31) | (_LOW31 - rows)
    return torch.topk(keys, k, dim=1).indices


def _pad_rows(arr: np.ndarray, n_shards: int) -> np.ndarray:
    """Zero-pad the leading axis to a multiple of ``n_shards``."""
    pad = (-arr.shape[0]) % n_shards
    if not pad:
        return arr
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths)


def _k_bucket(k: int, n: int) -> int:
    """k rounded up to a power of two, at most ``n``: JAX's bucket."""
    bucket = 1
    while bucket < k:
        bucket *= 2
    return min(bucket, n)


def _sharded_query(corpus_blk: torch.Tensor, queries, mask, k: int, n: int, mesh,
                   axis_name: str):
    """The sharded top-k against this rank's block of the padded corpus
    (on its device). ``mask`` is host-side with the corpus's PADDED length
    (pads False); ``n`` is the true row count (bounds the k bucket).

    Each rank scores its contiguous row block (one f32 matmul, the mask,
    a local top-k), the ranks all-gather k candidates each, and a final
    top-k merges them, ties by the lower global row: the single-device
    result, values and indices."""
    bucket = _k_bucket(k, n)
    dev = corpus_blk.device
    rows = corpus_blk.shape[0]
    lo = mesh.axis_index(axis_name) * rows
    mask_blk = torch.from_numpy(np.ascontiguousarray(mask[lo : lo + rows])).to(dev)
    q = torch.as_tensor(np.asarray(queries, np.float32)).to(dev)
    sims, idx = masked_topk(corpus_blk, q, mask_blk, min(bucket, rows))
    s_all = mesh.all_gather(sims, axis_name, dim=1)
    g_all = mesh.all_gather(idx + lo, axis_name, dim=1)
    pos = _ordered_topk(s_all, g_all, bucket)
    sims, idx = torch.gather(s_all, 1, pos), torch.gather(g_all, 1, pos)
    if bucket != k:
        sims, idx = sims[:, :k], idx[:, :k]
    return sims, idx


def sharded_masked_topk(corpus, queries, mask, k: int, mesh, axis_name: str = "data",
                        device="cuda"):
    """Masked cosine top-k with the corpus rows sharded over ``axis_name``
    of ``mesh``: every rank of the mesh passes the same global ``corpus``
    (N, D) and ``mask`` (N,) and keeps its block on ``device`` (this rank's
    card, or the CPU). Pads the row count to the shard multiple (padded rows
    are masked out) and returns exactly the single-device result."""
    from multimodal_embeddings_tpu_torch.core.mesh import rank_device

    n_shards = mesh.shape[axis_name]
    n = corpus.shape[0]
    corpus_p = _pad_rows(np.asarray(corpus, np.float32), n_shards)
    mask_p = _pad_rows(np.asarray(mask, bool), n_shards)
    rows = corpus_p.shape[0] // n_shards
    lo = mesh.axis_index(axis_name) * rows
    block = torch.from_numpy(corpus_p[lo : lo + rows]).to(rank_device(device))
    return _sharded_query(block, queries, mask_p, k, n, mesh, axis_name)


class Collection:
    """One named embedding collection with exact cosine retrieval on
    ``device``."""

    def __init__(
        self,
        path: str,
        name: str,
        metadata: Optional[Dict] = None,
        index: str = "exact",
        device="cuda",
    ):
        if index not in ("exact", "hnsw"):
            raise ValueError(f"index must be 'exact' or 'hnsw', got {index!r}")
        self.path = os.path.join(path, name)
        self.name = name
        self.metadata = dict(metadata or HNSW_COMPAT_METADATA)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._ids: List[str] = []
        self._id_index: Dict[str, int] = {}
        self._embeddings: Optional[np.ndarray] = None  # (N, D) float32
        self._metadatas: List[Dict[str, Any]] = []
        self._device_cache: Optional[torch.Tensor] = None
        self._mesh = None
        self._mesh_axis = "data"
        # retrieval mode: "exact" (matmul + top-k on the device) or "hnsw"
        # (the native graph index, built with this collection's hnsw:*
        # metadata)
        self._index_mode = index
        self._hnsw = None
        self._hnsw_rows = 0  # corpus rows already inserted into the index
        self._load()

    def set_mesh(self, mesh, axis_name: str = "data") -> None:
        """Shard subsequent queries' corpus matmul over ``axis_name`` of
        ``mesh`` (exact, tie-identical to single-device — see
        ``sharded_masked_topk``). Pass ``None`` to return to one device.
        Every rank of the mesh must run the same queries."""
        with self._lock:
            self._mesh = mesh
            self._mesh_axis = axis_name
            self._device_cache = None

    # -- persistence --------------------------------------------------------

    def _load(self) -> None:
        bundle = os.path.join(self.path, "collection.npz")
        if os.path.exists(bundle):
            with np.load(bundle, allow_pickle=False) as data:
                self._embeddings = data["embeddings"]
                self._ids = json.loads(str(data["ids_json"]))
                self._metadatas = json.loads(str(data["metadata_json"]))
        elif os.path.exists(os.path.join(self.path, "embeddings.npy")):
            # legacy triple-file layout (pre-atomic)
            self._embeddings = np.load(os.path.join(self.path, "embeddings.npy"))
            with open(os.path.join(self.path, "ids.json")) as f:
                self._ids = json.load(f)
            self._metadatas = []
            with open(os.path.join(self.path, "metadata.jsonl")) as f:
                for line in f:
                    self._metadatas.append(json.loads(line))
        else:
            return
        n = min(len(self._ids), len(self._metadatas), len(self._embeddings))
        if n != len(self._ids) or n != len(self._embeddings) or n != len(self._metadatas):
            logger.warning(
                "collection %s inconsistent (%d ids / %d rows) — truncating to %d",
                self.name, len(self._ids), len(self._embeddings), n,
            )
            self._ids = self._ids[:n]
            self._metadatas = self._metadatas[:n]
            self._embeddings = self._embeddings[:n]
        self._id_index = {i: n_ for n_, i in enumerate(self._ids)}
        logger.info("loaded collection %s: %d embeddings", self.name, len(self._ids))

    def persist(self) -> None:
        """Atomic persistence: everything goes into ONE .npz replaced in a
        single os.replace, so a crash can never leave ids/embeddings/
        metadata mutually inconsistent."""
        with self._lock:
            os.makedirs(self.path, exist_ok=True)
            if self._embeddings is None:
                # collection emptied: remove stale bundles so deleted rows
                # cannot resurrect on the next load
                for name in ("collection.npz", "embeddings.npy", "ids.json", "metadata.jsonl"):
                    target = os.path.join(self.path, name)
                    if os.path.exists(target):
                        os.remove(target)
                return
            tmp = os.path.join(self.path, ".tmp_collection.npz")
            np.savez(
                tmp,
                embeddings=self._embeddings,
                ids_json=np.asarray(json.dumps(self._ids)),
                metadata_json=np.asarray(json.dumps(self._metadatas)),
            )
            os.replace(tmp, os.path.join(self.path, "collection.npz"))

    # -- mutation -----------------------------------------------------------

    def upsert(
        self,
        ids: Sequence[str],
        embeddings: Sequence[Sequence[float]],
        metadatas: Optional[Sequence[Dict[str, Any]]] = None,
        documents: Optional[Sequence[str]] = None,
    ) -> None:
        with self._lock:
            embs = np.asarray(embeddings, np.float32)
            if embs.ndim == 1:
                embs = embs[None]
            metadatas = list(metadatas or [{} for _ in ids])
            if documents is not None:
                for m, d in zip(metadatas, documents):
                    m.setdefault("document", d)
            # duplicate ids within one call: last occurrence wins (Chroma
            # semantics) — dedup before touching indices
            latest = {}
            for i, item_id in enumerate(ids):
                latest[item_id] = i
            new_rows = []
            for i, (item_id, emb) in enumerate(zip(ids, embs)):
                if latest[item_id] != i:
                    continue
                if item_id in self._id_index:
                    idx = self._id_index[item_id]
                    if idx < self._hnsw_rows and not np.array_equal(self._embeddings[idx], emb):
                        # an in-place vector change invalidates the graph:
                        # rebuild lazily; metadata-only re-upserts keep it
                        self._hnsw = None
                        self._hnsw_rows = 0
                    self._embeddings[idx] = emb
                    self._metadatas[idx] = dict(metadatas[i])
                else:
                    self._id_index[item_id] = len(self._ids) + len(new_rows)
                    new_rows.append((item_id, emb, dict(metadatas[i])))
            if new_rows:
                add = np.stack([r[1] for r in new_rows])
                self._embeddings = (
                    add if self._embeddings is None else np.concatenate([self._embeddings, add])
                )
                self._ids.extend(r[0] for r in new_rows)
                self._metadatas.extend(r[2] for r in new_rows)
            self._device_cache = None
            if self._index_mode == "hnsw":
                # index construction amortized across ingest batches
                self._sync_hnsw()
            self.persist()

    def delete(self, ids: Sequence[str]) -> None:
        with self._lock:
            drop = {i for i in ids if i in self._id_index}
            if not drop:
                return
            keep = [n for n, i in enumerate(self._ids) if i not in drop]
            self._embeddings = self._embeddings[keep] if len(keep) else None
            self._ids = [self._ids[n] for n in keep]
            self._metadatas = [self._metadatas[n] for n in keep]
            self._id_index = {i: n for n, i in enumerate(self._ids)}
            self._device_cache = None
            self._hnsw = None  # row renumbering — rebuild lazily
            self._hnsw_rows = 0
            self.persist()

    def set_index(self, mode: str) -> None:
        """Switch retrieval between ``"exact"`` and ``"hnsw"``."""
        if mode not in ("exact", "hnsw"):
            raise ValueError(f"index must be 'exact' or 'hnsw', got {mode!r}")
        with self._lock:
            self._index_mode = mode

    def _sync_hnsw(self):
        """Build/extend the native graph index to cover the corpus (call
        under the lock); returns the index."""
        from multimodal_embeddings_tpu_torch.utils.native import HnswIndex

        n = len(self._ids)
        if self._hnsw is None:
            self._hnsw = HnswIndex(
                int(self._embeddings.shape[1]),
                m=int(self.metadata.get("hnsw:M", 32)),
                ef_construction=int(self.metadata.get("hnsw:construction_ef", 200)),
                seed=0,
            )
            self._hnsw_rows = 0
        if self._hnsw_rows < n:
            self._hnsw.add(self._embeddings[self._hnsw_rows : n])
            self._hnsw_rows = n
        return self._hnsw

    # -- reads --------------------------------------------------------------

    def count(self) -> int:
        return len(self._ids)

    def get(
        self,
        ids: Optional[Sequence[str]] = None,
        where: Optional[Dict] = None,
        include: Sequence[str] = ("metadatas",),
        limit: Optional[int] = None,
    ) -> Dict[str, Any]:
        with self._lock:
            if ids is not None:
                idxs = [self._id_index[i] for i in ids if i in self._id_index]
            else:
                idxs = [n for n, m in enumerate(self._metadatas) if _matches(m, where)]
            if limit is not None:
                idxs = idxs[:limit]
            out: Dict[str, Any] = {"ids": [self._ids[n] for n in idxs]}
            if "embeddings" in include and self._embeddings is not None:
                out["embeddings"] = [self._embeddings[n].tolist() for n in idxs]
            elif "embeddings" in include:
                out["embeddings"] = []
            if "metadatas" in include:
                out["metadatas"] = [self._metadatas[n] for n in idxs]
            return out

    def _device_embeddings(self) -> torch.Tensor:
        """The unit-normalised corpus, cached on the collection's device:
        whole by default; after ``set_mesh``, this rank's block of the rows
        padded to the shard multiple."""
        with self._lock:
            if self._device_cache is None:
                norms = np.linalg.norm(self._embeddings, axis=1, keepdims=True)
                normed = self._embeddings / np.clip(norms, 1e-12, None)
                if self._mesh is not None:
                    n_shards = self._mesh.shape[self._mesh_axis]
                    padded = _pad_rows(normed.astype(np.float32), n_shards)
                    rows = padded.shape[0] // n_shards
                    lo = self._mesh.axis_index(self._mesh_axis) * rows
                    normed = padded[lo : lo + rows]
                self._device_cache = torch.from_numpy(normed).to(self.device)
            return self._device_cache

    def query(
        self,
        query_embeddings: Sequence[Sequence[float]],
        n_results: int = 10,
        where: Optional[Dict] = None,
        include: Sequence[str] = ("metadatas", "distances"),
    ) -> Dict[str, Any]:
        """Cosine top-k. Default ("exact"): one matmul + mask + top-k on the
        collection's device for the whole query batch. ``index="hnsw"``
        collections walk the native graph index instead — approximate,
        built with this collection's ``hnsw:*`` metadata parameters."""
        with self._lock:
            n = len(self._ids)
            if n == 0:
                empty = [[] for _ in query_embeddings]
                return {"ids": empty, "distances": empty, "metadatas": empty}
            if self._index_mode == "hnsw":
                self._sync_hnsw()
                return self._query_hnsw(query_embeddings, n_results, where, include)
            corpus = self._device_embeddings()
            mask = np.fromiter((_matches(m, where) for m in self._metadatas), bool, count=n)
            metadatas = list(self._metadatas)
            ids = list(self._ids)

        q = np.asarray(query_embeddings, np.float32)
        if q.ndim == 1:
            q = q[None]
        qn = q / np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-12, None)

        k = min(n_results, int(mask.sum()))
        if k == 0:
            empty = [[] for _ in range(q.shape[0])]
            return {"ids": empty, "distances": empty, "metadatas": empty}

        if self._mesh is not None:
            mask_p = _pad_rows(mask, self._mesh.shape[self._mesh_axis])
            top_sims, top_idx = _sharded_query(corpus, qn, mask_p, k, n, self._mesh,
                                               self._mesh_axis)
        else:
            top_sims, top_idx = masked_topk(
                corpus, torch.from_numpy(qn).to(self.device),
                torch.from_numpy(mask).to(self.device), k,
            )
        top_sims, top_idx = top_sims.cpu().numpy(), top_idx.cpu().numpy()

        out: Dict[str, Any] = {"ids": [[ids[j] for j in row] for row in top_idx]}
        if "distances" in include:
            out["distances"] = (1.0 - top_sims).tolist()
        if "metadatas" in include:
            out["metadatas"] = [[metadatas[j] for j in row] for row in top_idx]
        if "embeddings" in include:
            with self._lock:
                out["embeddings"] = [
                    [self._embeddings[j].tolist() for j in row] for row in top_idx
                ]
        return out

    def _query_hnsw(
        self,
        query_embeddings,
        n_results: int,
        where: Optional[Dict],
        include: Sequence[str],
    ) -> Dict[str, Any]:
        """Native-graph retrieval (called under the lock with the index
        synced). Same response shape as the exact path; rows with fewer
        than ``n_results`` filter matches return short lists."""
        n = len(self._ids)
        q = np.asarray(query_embeddings, np.float32)
        if q.ndim == 1:
            q = q[None]
        mask = None
        if where:
            mask = np.fromiter(
                (_matches(m, where) for m in self._metadatas), np.uint8, count=n
            )
        k = min(n_results, n if mask is None else int(mask.sum()))
        if k == 0:
            empty = [[] for _ in range(q.shape[0])]
            return {"ids": empty, "distances": empty, "metadatas": empty}
        ef = max(int(self.metadata.get("hnsw:search_ef", 200)), k)
        idx, dist = self._hnsw.search(q, k=k, ef=ef, mask=mask)
        # -1 padding (fewer than k matches reachable) sits at the tail
        rows = [[int(j) for j in row if j >= 0] for row in idx]
        out: Dict[str, Any] = {"ids": [[self._ids[j] for j in row] for row in rows]}
        if "distances" in include:
            out["distances"] = [
                [float(dist[i][p]) for p in range(len(row))] for i, row in enumerate(rows)
            ]
        if "metadatas" in include:
            out["metadatas"] = [[self._metadatas[j] for j in row] for row in rows]
        if "embeddings" in include:
            out["embeddings"] = [[self._embeddings[j].tolist() for j in row] for row in rows]
        return out


class Client:
    """Minimal persistent client (ChromaDB-shaped); its collections keep
    their corpus on ``device``."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = resolve_device(device)
        os.makedirs(path, exist_ok=True)
        self._collections: Dict[str, Collection] = {}

    def get_or_create_collection(
        self, name: str, metadata: Optional[Dict] = None, index: str = "exact"
    ) -> Collection:
        if name not in self._collections:
            self._collections[name] = Collection(
                self.path, name, metadata, index=index, device=self.device
            )
        return self._collections[name]

    def delete_collection(self, name: str) -> None:
        import shutil

        self._collections.pop(name, None)
        target = os.path.join(self.path, name)
        if os.path.isdir(target):
            shutil.rmtree(target)

    def list_collections(self) -> List[str]:
        stored = [
            d for d in os.listdir(self.path) if os.path.isdir(os.path.join(self.path, d))
        ]
        return sorted(set(stored) | set(self._collections))


def initialize_db(
    path: str = "db",
    collection_name: str = DEFAULT_COLLECTION,
    index: str = "exact",
    device="cuda",
) -> Tuple[Client, Collection]:
    """Reference-shaped entry point (``db_operations.py:17-61``).
    ``index="hnsw"`` opts into the native graph index built with the
    collection's ``hnsw:*`` metadata instead of exact retrieval."""
    client = Client(path, device=device)
    collection = client.get_or_create_collection(
        collection_name, metadata=HNSW_COMPAT_METADATA, index=index
    )
    logger.info(
        "store ready at %s, collection %r (%d items)",
        path, collection_name, collection.count(),
    )
    return client, collection


def get_embedding_from_db(collection: Collection, item_id: str) -> Optional[List[float]]:
    """Fetch one embedding with validity check (``db_operations.py:65-85``)."""
    result = collection.get(ids=[item_id], include=("embeddings",))
    if result["ids"] and result.get("embeddings"):
        emb = result["embeddings"][0]
        if emb and len(emb) > 0:
            return emb
    return None
