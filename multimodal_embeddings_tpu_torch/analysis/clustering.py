"""Region-area-weighted page similarity and hierarchical clustering.

Port of ``multimodal_embeddings_tpu/analysis/clustering.py`` (a
re-derivation of ``weighted_region_clustering.py``). The host code is
copied verbatim (``PageRegions``, ``group_regions_by_page``, ``_pad_pages``,
``average_linkage``, ``labels_from_linkage``,
``silhouette_score_precomputed``, ``ClusteringResult``, ``cluster_pages``;
``tests/test_torch_analysis.py`` holds the sources equal), and the one
device pass, ``compute_similarity_matrix``, runs in torch on ``device``
(the card unless the caller asks for the CPU):

* The reference computes page-pair similarity with up to N²·10 sequential
  ANN queries (first 10 regions of page i, top ≤10 matches among page j's
  regions, accept cosine distance ≤ 0.9, accumulate
  ``Σ (1−dist)·area_i·area_j`` — ``weighted_region_clustering.py:97-254``).
  Here the same quantity is computed for ALL page pairs: the JAX
  ``"iad,jbd->ijab"`` einsum is one f32 ``torch.matmul`` of the (N·Q, D)
  queries by the (D, N·R) corpus (TF32 left off, torch's default), masked
  corpus rows are set to −2, and the top-k over each page's regions keeps
  ``jax.lax.top_k``'s order: a stable descending sort, so of two equal
  similarities the lower region index comes first (``torch.topk`` promises
  no order, and a tie at the k-th place between regions of different areas
  changes the sum). The scores take N²·Q·R·4 bytes, so the query pages go
  in chunks of at most ``_CHUNK_ELEMENTS`` scores; each (i, j) entry is
  independent, so the result does not depend on the chunking.
* Pair direction matches the reference exactly: each unordered pair is
  computed once, queries drawn from page i only (i < j), and the value
  mirrored (``:163-235``) — NOT averaged over both directions. This host
  tail, in float64, is JAX's lines.
* Matrix normalization matches the reference: divide by the max
  off-diagonal entry, force the diagonal to 1 (``:246-252``).
* Clustering = average-linkage agglomerative over distance 1−similarity
  with automatic k by silhouette score over k ∈ [2, min(10, N−1)]
  (``:452-543``) — self-contained in NumPy, with per-cluster cohesion
  (``:551-561``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = get_logger("clustering")

# scores held at once by the device pass: 2^28 f32 (1 GiB), plus the sort's
# values and int64 indices (3 GiB) — 559 query pages a chunk at 1,000 pages
# of 48 regions and 10 queries
_CHUNK_ELEMENTS = 1 << 28


# ---------------------------------------------------------------------------
# Similarity matrix (one device pass)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PageRegions:
    """Per-page region embeddings + areas (fractions of page, i.e. the
    stored ``area_percentage`` divided by 100 as in
    ``weighted_region_clustering.py:139``)."""

    name: str
    embeddings: np.ndarray  # (R, D) unit-normalized
    areas: np.ndarray  # (R,) area fractions


def group_regions_by_page(
    collection, region_types: Optional[Sequence[str]] = "default"
) -> List[PageRegions]:
    """Pull all region entries from the store and group by parent image
    (``weighted_region_clustering.py:121-139``): keep entries with a
    parent, positive area, and a region type in ``REGION_TYPES_TO_PROCESS``
    (pass ``region_types=None`` to disable the type filter); areas are
    converted from percentages to fractions."""
    if region_types == "default":
        from multimodal_embeddings_tpu_torch.config import REGION_TYPES_TO_PROCESS

        region_types = REGION_TYPES_TO_PROCESS
    got = collection.get(
        where={"is_region": {"$eq": True}}, include=("embeddings", "metadatas")
    )
    by_page: Dict[str, List[Tuple[np.ndarray, float]]] = {}
    for emb, meta in zip(got.get("embeddings", []), got.get("metadatas", [])):
        parent = meta.get("parent_image_name")
        if parent is None or not emb:
            continue
        area = float(meta.get("area_percentage", 0.0)) / 100.0
        if area <= 0:
            continue
        if region_types is not None and meta.get("region_type") not in region_types:
            continue
        by_page.setdefault(parent, []).append((np.asarray(emb, np.float32), area))
    pages = []
    for name in sorted(by_page):
        embs = np.stack([e for e, _ in by_page[name]])
        norms = np.linalg.norm(embs, axis=1, keepdims=True)
        embs = embs / np.clip(norms, 1e-12, None)
        areas = np.asarray([a for _, a in by_page[name]], np.float32)
        pages.append(PageRegions(name, embs, areas))
    return pages


def _pad_pages(
    pages: Sequence[PageRegions], query_limit: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stack pages into padded tensors: queries (first ``query_limit``
    regions per page) and full corpora."""
    n = len(pages)
    d = pages[0].embeddings.shape[1]
    r_max = max(p.embeddings.shape[0] for p in pages)
    corpus = np.zeros((n, r_max, d), np.float32)
    corpus_area = np.zeros((n, r_max), np.float32)
    corpus_mask = np.zeros((n, r_max), bool)
    queries = np.zeros((n, query_limit, d), np.float32)
    query_area = np.zeros((n, query_limit), np.float32)
    for i, p in enumerate(pages):
        r = p.embeddings.shape[0]
        corpus[i, :r] = p.embeddings
        corpus_area[i, :r] = p.areas
        corpus_mask[i, :r] = True
        q = min(r, query_limit)
        queries[i, :q] = p.embeddings[:q]
        query_area[i, :q] = p.areas[:q]
    return queries, query_area, corpus, corpus_area, corpus_mask


def pair_scores(
    queries: torch.Tensor,  # (N, Q, D)
    query_area: torch.Tensor,  # (N, Q)
    corpus: torch.Tensor,  # (N, R, D)
    corpus_area: torch.Tensor,  # (N, R)
    corpus_mask: torch.Tensor,  # (N, R) bool
    k: int,
    accept_threshold: float,
    weight_by_area: bool,
) -> torch.Tensor:
    """The (N, N) f32 sums of JAX's jitted ``run``, on the tensors' device:
    for query page i and corpus page j, the top-k similarities of each of
    i's queries among j's regions, those ``>= accept_threshold`` summed,
    each weighted by the query's and the match's areas when
    ``weight_by_area``. As many query pages at a time as keep
    ``_CHUNK_ELEMENTS`` scores."""
    n, q, d = queries.shape
    r = corpus.shape[1]
    chunk = max(1, _CHUNK_ELEMENTS // max(1, n * q * r))
    flat_corpus = corpus.reshape(n * r, d).T  # (D, N·R)
    out = torch.empty((n, n), dtype=torch.float32, device=queries.device)
    for start in range(0, n, chunk):
        c = min(chunk, n - start)
        # sims[i, j, a, b] = <query a of page i, region b of page j>
        sims = torch.matmul(queries[start : start + c].reshape(c * q, d), flat_corpus)
        sims = sims.reshape(c, q, n, r).permute(0, 2, 1, 3)
        sims = torch.where(corpus_mask[None, :, None, :], sims, -2.0)
        # jax.lax.top_k's order: descending, the lower index first on a tie
        top_sims, top_idx = torch.sort(sims, dim=-1, descending=True, stable=True)
        top_sims, top_idx = top_sims[..., :k], top_idx[..., :k]  # (c, N, Q, k)
        top_areas = torch.gather(corpus_area[None, :, None, :].expand(c, n, q, r), -1, top_idx)
        accept = top_sims >= accept_threshold
        if weight_by_area:
            contrib = top_sims * query_area[start : start + c, None, :, None] * top_areas
        else:
            contrib = top_sims
        contrib = torch.where(accept, contrib, 0.0)
        out[start : start + c] = torch.sum(contrib, dim=(2, 3))
    return out


def compute_similarity_matrix(
    pages: Sequence[PageRegions],
    query_limit: int = 10,
    top_k: int = 10,
    accept_threshold: float = 0.1,
    weight_by_area: bool = True,
    prefix_skip: Optional[int] = None,
    normalize: bool = True,
    device="cuda",
) -> np.ndarray:
    """All-pairs weighted similarity in one device pass (``pair_scores`` on
    ``device``).

    ``prefix_skip``: pairs whose names share this many leading characters
    get similarity 0 (same-publication skip,
    ``weighted_region_clustering.py:179-186``).
    """
    n = len(pages)
    if n == 0:
        return np.zeros((0, 0))
    queries, query_area, corpus, corpus_area, corpus_mask = _pad_pages(
        pages, query_limit
    )
    k = min(top_k, corpus.shape[1])
    dev = resolve_device(device)
    with torch.inference_mode():
        sums = pair_scores(
            *(torch.from_numpy(a).to(dev) for a in (
                queries, query_area, corpus, corpus_area, corpus_mask)),
            k,
            accept_threshold,
            weight_by_area,
        )
    sim = np.asarray(sums.cpu().numpy(), np.float64)
    # The reference computes each unordered pair ONCE with queries drawn
    # from page i (i < j) and mirrors the value
    # (weighted_region_clustering.py:163-235) — keep only the i→j
    # direction of the upper triangle, then mirror.
    sim = np.triu(sim, 1)
    sim = sim + sim.T
    if prefix_skip:
        for i in range(n):
            for j in range(n):
                if i != j and pages[i].name[:prefix_skip] == pages[j].name[:prefix_skip]:
                    sim[i, j] = 0.0
    np.fill_diagonal(sim, 0.0)
    if normalize:
        off_max = sim.max() if n > 1 else 0.0
        if off_max > 0:
            sim = sim / off_max
    np.fill_diagonal(sim, 1.0)
    return sim


# ---------------------------------------------------------------------------
# Agglomerative clustering (average linkage) + silhouette — self-contained
# ---------------------------------------------------------------------------


def average_linkage(distance: np.ndarray) -> np.ndarray:
    """scipy-compatible linkage matrix (UPGMA) from a square distance
    matrix. Returns (n-1, 4): [idx_a, idx_b, dist, size]."""
    n = distance.shape[0]
    d = distance.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    sizes = {i: 1 for i in range(n)}
    active = list(range(n))
    index_of = {i: i for i in range(n)}  # cluster id -> row in d
    merges = []
    next_id = n
    # working copy over original rows; rows get replaced on merge
    cluster_rows = {i: i for i in range(n)}
    current = d
    cluster_ids = list(range(n))
    while len(cluster_ids) > 1:
        # find the closest pair among active clusters
        sub = current
        best = np.inf
        bi = bj = -1
        for ai in range(len(cluster_ids)):
            for aj in range(ai + 1, len(cluster_ids)):
                val = sub[ai, aj]
                if val < best:
                    best, bi, bj = val, ai, aj
        ca, cb = cluster_ids[bi], cluster_ids[bj]
        sa, sb = sizes[ca], sizes[cb]
        merges.append(
            [min(ca, cb), max(ca, cb), best, sa + sb]
        )
        # UPGMA update: weighted average of distances
        new_row = (sub[bi] * sa + sub[bj] * sb) / (sa + sb)
        keep = [x for x in range(len(cluster_ids)) if x not in (bi, bj)]
        new_mat = np.empty((len(keep) + 1, len(keep) + 1))
        new_mat[:-1, :-1] = sub[np.ix_(keep, keep)]
        new_mat[-1, :-1] = new_row[keep]
        new_mat[:-1, -1] = new_row[keep]
        new_mat[-1, -1] = np.inf
        current = new_mat
        cluster_ids = [cluster_ids[x] for x in keep] + [next_id]
        sizes[next_id] = sa + sb
        next_id += 1
    return np.asarray(merges)


def labels_from_linkage(linkage: np.ndarray, n: int, k: int) -> np.ndarray:
    """Cut the dendrogram into k clusters (merge order = ascending
    distance)."""
    parent = list(range(n + len(linkage)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    merges_to_apply = len(linkage) - (k - 1)
    for m in range(merges_to_apply):
        a, b = int(linkage[m, 0]), int(linkage[m, 1])
        new_id = n + m
        parent[find(a)] = new_id
        parent[find(b)] = new_id
    roots = {}
    labels = np.empty(n, np.int32)
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = len(roots)
        labels[i] = roots[r]
    return labels


def silhouette_score_precomputed(distance: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette coefficient over samples for a precomputed distance
    matrix (sklearn-equivalent; verified in tests)."""
    n = len(labels)
    unique = np.unique(labels)
    if len(unique) < 2 or len(unique) >= n:
        return -1.0
    scores = np.zeros(n)
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = distance[i][same].mean() if same.any() else 0.0
        b = np.inf
        for c in unique:
            if c == labels[i]:
                continue
            other = labels == c
            b = min(b, distance[i][other].mean())
        denom = max(a, b)
        scores[i] = 0.0 if denom == 0 else (b - a) / denom
        if not same.any():
            scores[i] = 0.0
    return float(scores.mean())


@dataclasses.dataclass
class ClusteringResult:
    labels: np.ndarray
    n_clusters: int
    silhouette: float
    linkage: np.ndarray
    cohesion: Dict[int, float]
    names: List[str]

    def clusters(self) -> Dict[int, List[str]]:
        out: Dict[int, List[str]] = {}
        for name, label in zip(self.names, self.labels):
            out.setdefault(int(label), []).append(name)
        return out


def cluster_pages(
    similarity: np.ndarray,
    names: Sequence[str],
    n_clusters: Optional[int] = None,
    min_k: int = 2,
    max_k: int = 10,
) -> ClusteringResult:
    """Average-linkage clustering with automatic k by silhouette
    (``weighted_region_clustering.py:452-574``)."""
    n = similarity.shape[0]
    distance = 1.0 - similarity
    np.fill_diagonal(distance, 0.0)
    linkage = average_linkage(distance)

    if n_clusters is None:
        best_k, best_score = min_k, -np.inf
        for k in range(min_k, min(max_k, n - 1) + 1):
            labels = labels_from_linkage(linkage, n, k)
            score = silhouette_score_precomputed(distance, labels)
            logger.debug("k=%d silhouette=%.4f", k, score)
            if score > best_score:
                best_k, best_score = k, score
        n_clusters = best_k
        silhouette = best_score
        labels = labels_from_linkage(linkage, n, n_clusters)
    else:
        n_clusters = min(n_clusters, n)
        labels = labels_from_linkage(linkage, n, n_clusters)
        silhouette = silhouette_score_precomputed(distance, labels)

    cohesion = {}
    for c in np.unique(labels):
        members = np.where(labels == c)[0]
        if len(members) < 2:
            cohesion[int(c)] = 1.0
            continue
        sub = similarity[np.ix_(members, members)]
        off = sub[~np.eye(len(members), dtype=bool)]
        cohesion[int(c)] = float(off.mean())

    return ClusteringResult(
        labels=labels,
        n_clusters=int(n_clusters),
        silhouette=float(silhouette),
        linkage=linkage,
        cohesion=cohesion,
        names=list(names),
    )
