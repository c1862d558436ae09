"""The port's embedding store and native host bindings against the JAX
package's, on the CPU.

* ``Collection``: the same upserts, gets, ``where`` filters, deletes and
  queries on both stores give equal ids, equal metadata and distances
  within 1e-6 (each framework's f32 matmul sums in its own order); duplicate
  rows (a vector upserted under two ids) come back in JAX's tie order; each
  package loads the other's ``collection.npz``; ``index="hnsw"`` collections
  give equal ids (same native source, seed 0).
* ``masked_topk``: ties by the lower row index, as ``jax.lax.top_k`` and the
  native ``cosine_topk`` order them.
* ``utils/native.py``: every binding against JAX's on the same inputs,
  float64 results bit-equal, ``HnswIndex`` with seed 0 giving equal ids and
  distances; the library built from ``native/``'s sources into the port's
  build directory, never the tracked ``native/libmmtpu.so``.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from multimodal_embeddings_tpu.store import embedding_store as jstore
from multimodal_embeddings_tpu.utils import native as jnative
from multimodal_embeddings_tpu_torch.store import embedding_store as tstore
from multimodal_embeddings_tpu_torch.utils import native as tnative

DIM = 32
PARENTS = ("a.png", "b.png", "c.png")


def _rows(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _metas(n):
    return [{"parent_image_name": PARENTS[i % 3], "is_region": i % 4 != 0, "region_index": i}
            for i in range(n)]


def _both(tmp_path, ids, embs, metas, index="exact"):
    _, j = jstore.initialize_db(str(tmp_path / "jax"), index=index)
    _, t = tstore.initialize_db(str(tmp_path / "torch"), index=index, device="cpu")
    for coll in (j, t):
        coll.upsert(ids=ids, embeddings=embs, metadatas=[dict(m) for m in metas])
    return j, t


def _assert_same_query(jres, tres, atol=1e-6):
    assert tres["ids"] == jres["ids"]
    np.testing.assert_allclose(np.asarray(tres["distances"], np.float64),
                               np.asarray(jres["distances"], np.float64), atol=atol, rtol=0)
    if "metadatas" in jres:
        assert tres["metadatas"] == jres["metadatas"]


@pytest.fixture
def pair(tmp_path):
    n = 60
    ids = [f"id{i}" for i in range(n)]
    return _both(tmp_path, ids, _rows(n).tolist(), _metas(n))


WHERES = [None, {"is_region": True}, {"parent_image_name": {"$eq": "b.png"}},
          {"$and": [{"is_region": True}, {"parent_image_name": {"$ne": "a.png"}}]},
          {"$or": [{"parent_image_name": "c.png"}, {"region_index": {"$in": [0, 1, 2]}}]},
          {"parent_image_name": "none.png"}]


@pytest.mark.parametrize("where", WHERES, ids=range(len(WHERES)))
@pytest.mark.parametrize("k", [1, 5, 10, 100])
def test_query_matches_jax(pair, where, k):
    j, t = pair
    q = _rows(7, seed=3)
    _assert_same_query(j.query(q.tolist(), n_results=k, where=where),
                       t.query(q.tolist(), n_results=k, where=where))


@pytest.mark.parametrize("where", WHERES, ids=range(len(WHERES)))
def test_get_matches_jax(pair, where):
    j, t = pair
    inc = ("metadatas", "embeddings")
    assert t.get(where=where, include=inc) == j.get(where=where, include=inc)
    assert t.get(where=where, limit=3) == j.get(where=where, limit=3)


def test_get_by_ids_and_count(pair):
    j, t = pair
    ids = ["id3", "missing", "id0", "id59"]
    assert t.get(ids=ids, include=("embeddings",)) == j.get(ids=ids, include=("embeddings",))
    assert t.count() == j.count() == 60
    assert tstore.get_embedding_from_db(t, "id7") == jstore.get_embedding_from_db(j, "id7")
    assert tstore.get_embedding_from_db(t, "nope") is jstore.get_embedding_from_db(j, "nope")


def test_upsert_overwrite_delete_and_query(pair):
    j, t = pair
    new = _rows(5, seed=9).tolist()
    for coll in (j, t):
        # overwrite two, add three (one id twice in the call: the last wins)
        coll.upsert(ids=["id1", "id2", "n0", "n1", "n1"], embeddings=new,
                    metadatas=[{"parent_image_name": "z.png"}] * 5)
        coll.delete(["id0", "id5", "not-there"])
    assert t.get(include=("metadatas", "embeddings")) == j.get(include=("metadatas", "embeddings"))
    q = _rows(4, seed=4).tolist()
    _assert_same_query(j.query(q, n_results=8), t.query(q, n_results=8))
    _assert_same_query(j.query(q, n_results=3, where={"parent_image_name": "z.png"}),
                       t.query(q, n_results=3, where={"parent_image_name": "z.png"}))


def test_duplicate_rows_keep_jax_tie_order(tmp_path):
    """A vector upserted under several ids (a page served twice) ties
    exactly: the lower row comes first, as in JAX."""
    base = _rows(10, seed=5)
    embs = np.concatenate([base, base[[3, 3, 7]], base[[3]]]).tolist()
    ids = [f"r{i}" for i in range(len(embs))]
    j, t = _both(tmp_path, ids, embs, _metas(len(embs)))
    q = np.stack([base[3], base[7], base[3] + 1e-3]).tolist()
    jres, tres = j.query(q, n_results=6), t.query(q, n_results=6)
    _assert_same_query(jres, tres)
    assert tres["ids"][0][:4] == ["r3", "r10", "r11", "r13"]
    assert tres["ids"][1][:2] == ["r7", "r12"]


def test_masked_topk_orders_ties_by_index():
    """Equal keys at every sign and at the mask value, in rows that a
    descending sort would not keep in order."""
    corpus = torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.0, -1.0], [1.0, 0.0], [0.0, 1.0],
                           [0.0, -1.0], [0.6, 0.8]])
    queries = torch.tensor([[0.0, 1.0], [1.0, 0.0], [0.0, -1.0]])
    mask = torch.tensor([True, True, True, True, True, True, False])
    sims, idx = tstore.masked_topk(corpus, queries, mask, 7)
    want = torch.sort(torch.where(mask, queries @ corpus.T, -2.0), dim=1, descending=True,
                      stable=True)
    assert torch.equal(idx, want.indices)
    assert torch.equal(sims, want.values)
    assert idx[0].tolist() == [0, 4, 1, 3, 2, 5, 6]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_collection_npz_loads_across_packages(tmp_path, writer):
    n = 25
    ids, embs, metas = [f"x{i}" for i in range(n)], _rows(n, seed=2).tolist(), _metas(n)
    mod = jstore if writer == "jax" else tstore
    kwargs = {} if writer == "jax" else {"device": "cpu"}
    _, coll = mod.initialize_db(str(tmp_path / "db"), **kwargs)
    coll.upsert(ids=ids, embeddings=embs, metadatas=metas)
    _, j = jstore.initialize_db(str(tmp_path / "db"))
    _, t = tstore.initialize_db(str(tmp_path / "db"), device="cpu")
    inc = ("metadatas", "embeddings")
    assert t.get(include=inc) == j.get(include=inc) == coll.get(include=inc)
    q = _rows(3, seed=8).tolist()
    _assert_same_query(j.query(q, n_results=5), t.query(q, n_results=5))


def test_same_bundle_bytes_as_jax(tmp_path):
    """Both stores persist the same arrays under the same keys."""
    n = 12
    j, t = _both(tmp_path, [f"i{i}" for i in range(n)], _rows(n).tolist(), _metas(n))
    bundles = [np.load(os.path.join(c.path, "collection.npz")) for c in (j, t)]
    assert sorted(bundles[0].files) == sorted(bundles[1].files)
    for key in bundles[0].files:
        np.testing.assert_array_equal(bundles[0][key], bundles[1][key])
    assert json.loads(str(bundles[1]["ids_json"])) == [f"i{i}" for i in range(n)]


def test_empty_collection_and_emptied_bundle(tmp_path):
    _, t = tstore.initialize_db(str(tmp_path), device="cpu")
    assert t.query([[1.0] * DIM], n_results=3) == {"ids": [[]], "distances": [[]],
                                                   "metadatas": [[]]}
    t.upsert(ids=["a"], embeddings=[[1.0] * DIM])
    t.delete(["a"])
    assert not os.path.exists(os.path.join(t.path, "collection.npz"))
    assert tstore.Collection(str(tmp_path), tstore.DEFAULT_COLLECTION, device="cpu").count() == 0


def test_client_listing_and_delete(tmp_path):
    jc, tc = jstore.Client(str(tmp_path / "j")), tstore.Client(str(tmp_path / "t"), device="cpu")
    for c in (jc, tc):
        c.get_or_create_collection("one").upsert(ids=["a"], embeddings=[[1.0, 0.0]])
        c.get_or_create_collection("two")
        c.delete_collection("one")
    assert tc.list_collections() == jc.list_collections() == ["two"]


def test_store_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.initialize_db(str(tmp_path))


@pytest.mark.parametrize("where", [None, {"is_region": True}])
def test_hnsw_collection_matches_jax(tmp_path, where):
    n = 300
    ids, embs = [f"h{i}" for i in range(n)], _rows(n, seed=6).tolist()
    j, t = _both(tmp_path, ids, embs, _metas(n), index="hnsw")
    q = _rows(6, seed=7).tolist()
    jres = j.query(q, n_results=10, where=where)
    tres = t.query(q, n_results=10, where=where)
    assert tres["ids"] == jres["ids"]
    assert tres["distances"] == jres["distances"]
    # a vector changed in place rebuilds the graph in both
    for coll in (j, t):
        coll.upsert(ids=["h0"], embeddings=[_rows(1, seed=11)[0].tolist()])
    assert t.query(q, n_results=5)["ids"] == j.query(q, n_results=5)["ids"]


# -- native bindings ---------------------------------------------------------


def _boxes(rng, n, w=1000, h=800):
    x1, y1 = rng.uniform(0, w * 0.9, n), rng.uniform(0, h * 0.9, n)
    return np.stack([x1, y1, x1 + rng.uniform(5, w * 0.4, n), y1 + rng.uniform(5, h * 0.4, n)],
                    axis=1)


@pytest.fixture(scope="module")
def jlib():
    lib = jnative.load()
    if lib is None:
        pytest.skip("the JAX package's native library is unavailable")
    return lib


def test_port_builds_its_own_library(tmp_path, monkeypatch):
    """g++ builds native/'s sources into the port's build directory; the
    tracked native/libmmtpu.so is left as it is."""
    tracked = tnative.NATIVE_DIR / "libmmtpu.so"
    before = hashlib.sha1(tracked.read_bytes()).hexdigest()
    monkeypatch.setenv("MMTPU_TORCH_BUILD_DIR", str(tmp_path))
    path = tnative.build()
    assert path.parent == tmp_path and path.name.startswith("libmmtpu-")
    assert tnative.build() == path  # built once, then reused
    assert hashlib.sha1(tracked.read_bytes()).hexdigest() == before


def test_failed_native_build_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("MMTPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "CXX_FLAGS", ("-shared", "-fPIC", "-DNOT_A_FLAG", "-no-such-flag"))
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.build()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_and_nms_bit_equal(jlib, seed):
    rng = np.random.default_rng(seed)
    boxes, scores = _boxes(rng, 120), rng.uniform(0, 1, 120)
    classes = rng.integers(0, 4, 120).astype(np.float64)
    np.testing.assert_array_equal(tnative.iou_matrix_native(boxes),
                                  jnative.iou_matrix_native(boxes))
    other = _boxes(rng, 17)
    np.testing.assert_array_equal(tnative.iou_matrix_native(boxes, other),
                                  jnative.iou_matrix_native(boxes, other))
    for cls in (classes, None):
        got = tnative.greedy_nms_native(boxes, scores, cls, 0.5)
        np.testing.assert_array_equal(got, jnative.greedy_nms_native(boxes, scores, cls, 0.5))
    # ties: equal scores keep the first index
    tied = np.full(120, 0.5)
    np.testing.assert_array_equal(tnative.greedy_nms_native(boxes, tied, None, 0.3),
                                  jnative.greedy_nms_native(boxes, tied, None, 0.3))


@pytest.mark.parametrize("cell", [(0, 0, 500, 400), (300, 200, 1000, 800), (200, 100, 700, 500)])
def test_edge_mask_equal(jlib, cell):
    boxes = _boxes(np.random.default_rng(4), 200)
    np.testing.assert_array_equal(
        tnative.internal_edge_mask_native(boxes, cell, 1000.0, 800.0, 10.0),
        jnative.internal_edge_mask_native(boxes, cell, 1000.0, 800.0, 10.0))


@pytest.mark.parametrize("masked", [False, True])
def test_cosine_topk_equal(jlib, masked):
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((500, 48)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[400:410] = corpus[17]  # exact ties
    query = corpus[17] + 0.01 * rng.standard_normal(48).astype(np.float32)
    mask = rng.uniform(size=500) < 0.7 if masked else None
    if masked:
        mask[[17, 400, 405]] = True
    got = tnative.cosine_topk_native(corpus, query, 20, mask)
    want = jnative.cosine_topk_native(corpus, query, 20, mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_hnsw_index_equal(jlib):
    rng = np.random.default_rng(6)
    data = rng.standard_normal((400, 24)).astype(np.float32)
    queries = rng.standard_normal((10, 24)).astype(np.float32)
    mask = (rng.uniform(size=400) < 0.5).astype(np.uint8)
    ports, jaxs = tnative.HnswIndex(24, m=8, ef_construction=40, seed=0), jnative.HnswIndex(
        24, m=8, ef_construction=40, seed=0)
    for ix in (ports, jaxs):
        ix.add(data[:250])
        ix.add(data[250:])
    assert len(ports) == len(jaxs) == 400
    for m in (None, mask):
        got = ports.search(queries, k=7, ef=30, mask=m)
        want = jaxs.search(queries, k=7, ef=30, mask=m)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        ports.add(np.zeros((2, 5), np.float32))


# -- the sharded query over gloo ranks (set_mesh, sharded_masked_topk) -------
#
# JAX's tests/test_store.py:209, :229, :244 on 2 and 3 ranks (53 rows: a
# padded row count on both), against JAX's sharded query on as many virtual
# devices and the port's single-device query: values and ids EQUAL.

SHARD_ROWS, SHARD_DIM = 53, 16
SHARD_WHERES = [None, {"is_region": {"$eq": True}}]


def _shard_corpus():
    """Entries that are multiples of 1/8 below 2 in magnitude: every product
    and partial sum of a similarity is exact in f32 whatever the order, so
    the two frameworks' matmuls give equal bits, and equal similarities
    (ties) are many."""
    rng = np.random.default_rng(3)
    corpus = (rng.integers(-12, 13, size=(37, 8)) / 8).astype(np.float32)
    queries = (rng.integers(-12, 13, size=(4, 8)) / 8).astype(np.float32)
    return corpus, queries, rng.random(37) > 0.3


def _shard_collection(root):
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(SHARD_ROWS, SHARD_DIM)).astype(np.float32)
    ids = [f"item{i}" for i in range(SHARD_ROWS)]
    metas = [{"is_region": i % 2 == 0, "parent_image_name": f"img{i % 5}"}
             for i in range(SHARD_ROWS)]
    queries = np.random.default_rng(1).normal(size=(3, SHARD_DIM)).astype(np.float32)
    _, col = tstore.initialize_db(os.path.join(root, "db"), device="cpu")
    col.upsert(ids=ids, embeddings=embs, metadatas=metas)
    # 16 identical rows: every score ties, the lower row first
    tie = np.eye(4, dtype=np.float32)[0]
    _, ties = tstore.initialize_db(os.path.join(root, "db_tie"), device="cpu")
    ties.upsert(ids=[f"t{i}" for i in range(16)], embeddings=[tie] * 16,
                metadatas=[{} for _ in range(16)])
    return queries, tie[None]


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """One spawn of 3 gloo ranks: every case on a data mesh of 2 and of 3."""
    from multimodal_embeddings_tpu_torch.core.mesh import launch
    from multimodal_embeddings_tpu_torch.parallel import dryrun

    root = str(tmp_path_factory.mktemp("sharded_store"))
    queries, tie = _shard_collection(root)
    corpus, cq, mask = _shard_corpus()
    cases = []
    for data in (2, 3):
        cases.append(("store_case", dict(data=data, corpus=corpus, queries=cq, mask=mask, k=6)))
        for n_results, where in ((7, None), (5, {"is_region": {"$eq": True}})):
            cases.append(("store_case", dict(
                data=data, path=os.path.join(root, "db"), name=tstore.DEFAULT_COLLECTION,
                queries=queries, n_results=n_results, where=where)))
        cases.append(("store_case", dict(
            data=data, path=os.path.join(root, "db_tie"), name=tstore.DEFAULT_COLLECTION,
            queries=tie, n_results=5)))
    results = launch(dryrun.run_cases, 3, cases, device="cpu", timeout=240)
    return dict(root=root, queries=queries, tie=tie, cases=cases, rank0=results[0],
                rank1=results[1])


def _jax_mesh(devices8, n):
    from multimodal_embeddings_tpu.config import MeshConfig as JMeshConfig
    from multimodal_embeddings_tpu.core.mesh import make_mesh as jmake_mesh

    return jmake_mesh(JMeshConfig(shape=(n, 1)), devices=devices8[:n])


def _by_data(sharded_ranks, data):
    return [r for (_, kw), r in zip(sharded_ranks["cases"], sharded_ranks["rank0"])
            if kw["data"] == data]


@pytest.mark.parametrize("data", [2, 3])
def test_sharded_topk_function_equals_jax_and_single(sharded_ranks, devices8, data):
    """``sharded_masked_topk`` of 37 rows on 2 or 3 ranks: values and ids
    EQUAL to JAX's on as many devices and to the port's ``masked_topk``;
    every rank of the mesh gets the same answer."""
    corpus, queries, mask = _shard_corpus()
    got = _by_data(sharded_ranks, data)[0]
    js, ji = jstore.sharded_masked_topk(corpus, queries, mask, 6, _jax_mesh(devices8, data),
                                        "data")
    np.testing.assert_array_equal(got["idx"], np.asarray(ji))
    np.testing.assert_array_equal(got["sims"], np.asarray(js))
    unit = torch.from_numpy(corpus)
    ws, wi = tstore.masked_topk(unit, torch.from_numpy(queries), torch.from_numpy(mask), 6)
    np.testing.assert_array_equal(got["idx"], wi.numpy())
    np.testing.assert_array_equal(got["sims"], ws.numpy())
    other = [r for (_, kw), r in zip(sharded_ranks["cases"], sharded_ranks["rank1"])
             if kw["data"] == data][0]
    np.testing.assert_array_equal(other["idx"], got["idx"])


@pytest.mark.parametrize("data", [2, 3])
@pytest.mark.parametrize("case", [0, 1], ids=["all", "where"])
def test_set_mesh_query_equals_jax_and_single(sharded_ranks, devices8, data, case):
    """``Collection.set_mesh`` on 53 rows (padded to 54 on 2 and 3 ranks):
    the ids and distances of the single-device query, and JAX's sharded
    query's ids."""
    got = _by_data(sharded_ranks, data)[1 + case]
    assert got["sharded"] == got["single"]
    n_results, where = ((7, None), (5, {"is_region": {"$eq": True}}))[case]
    _, jcol = jstore.initialize_db(os.path.join(sharded_ranks["root"], "db"))
    jcol.set_mesh(_jax_mesh(devices8, data))
    want = jcol.query(sharded_ranks["queries"], n_results=n_results, where=where)
    _assert_same_query(want, got["sharded"])


@pytest.mark.parametrize("data", [2, 3])
def test_set_mesh_ties_keep_row_order(sharded_ranks, devices8, data):
    """16 identical rows across the shards: items 0..4 in order, as JAX's
    sharded query gives them."""
    got = _by_data(sharded_ranks, data)[3]
    assert got["sharded"]["ids"][0] == [f"t{i}" for i in range(5)]
    _, jcol = jstore.initialize_db(os.path.join(sharded_ranks["root"], "db_tie"))
    jcol.set_mesh(_jax_mesh(devices8, data))
    assert jcol.query(sharded_ranks["tie"], n_results=5)["ids"] == got["sharded"]["ids"]


def test_pad_rows_equals_jax():
    for n, shards in ((53, 2), (54, 3), (7, 4)):
        a = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
        np.testing.assert_array_equal(tstore._pad_rows(a, shards), jstore._pad_rows(a, shards))
