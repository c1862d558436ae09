"""The port's analysis modules against the JAX package's, on the CPU.

* The host copies (``analysis/{html,clustering,reports,cross_compare,
  region_compare,demo_queries}.py``, ``ops/hough.py``,
  ``cli/workflow.py::reset_workflow``) have the JAX sources, the package
  name aside; the lines each rewrite keeps (the similarity pass's host
  tail, the plots after their imports) are JAX's lines.
* ``compute_similarity_matrix`` on the CPU in f32 equals JAX's within 1e-6
  after normalisation: unequal region counts, ``weight_by_area`` both ways,
  ``prefix_skip``, a page with fewer regions than ``top_k``, chunked query
  pages, and a tie at the k-th place between equal regions of different
  areas (the lower index wins, as in ``jax.lax.top_k``; ``torch.topk``'s
  own pick would change the sum).
* ``cluster_pages``: linkage, labels, silhouette and cohesion equal JAX's.
* A port store and a JAX store filled with the same seeded rows: the cross-
  and region-compare HTML trees (composites included) are byte-identical,
  the cluster report's JSON and ``.npy`` equal and its HTML equal but for
  the timestamp, ``run_demo_queries`` writes the same files.
* ``region_comparison_composite`` writes JAX's bytes with cv2 and returns
  False without it; the plots return False without their libraries.
* ``trace`` writes a Chrome trace; ``detect_skew_hough`` equals JAX's on
  rotated synthetic pages; ``letterbox`` and ``crop_and_resize`` equal
  JAX's f32 within 1e-4 on 0-255 values.
"""

import inspect
import json
import logging
import os
import re
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_embeddings_tpu.analysis import clustering as jclust
from multimodal_embeddings_tpu.analysis import cross_compare as jcross
from multimodal_embeddings_tpu.analysis import demo_queries as jdemo
from multimodal_embeddings_tpu.analysis import html as jhtml
from multimodal_embeddings_tpu.analysis import region_compare as jregion
from multimodal_embeddings_tpu.analysis import reports as jreports
from multimodal_embeddings_tpu.analysis import visualization as jviz
from multimodal_embeddings_tpu.cli import workflow as jworkflow
from multimodal_embeddings_tpu.ops import hough as jhough
from multimodal_embeddings_tpu_torch.analysis import clustering as tclust
from multimodal_embeddings_tpu_torch.analysis import cross_compare as tcross
from multimodal_embeddings_tpu_torch.analysis import demo_queries as tdemo
from multimodal_embeddings_tpu_torch.analysis import html as thtml
from multimodal_embeddings_tpu_torch.analysis import region_compare as tregion
from multimodal_embeddings_tpu_torch.analysis import reports as treports
from multimodal_embeddings_tpu_torch.analysis import visualization as tviz
from multimodal_embeddings_tpu_torch.cli import workflow as tworkflow
from multimodal_embeddings_tpu_torch.ops import hough as though

torch.set_num_threads(2)

SIM_ATOL = 1e-6  # the normalised similarity matrix, f32 sums in two orders


def _html_functions():
    return [n for n, v in vars(jhtml).items()
            if inspect.isfunction(v) and v.__module__ == jhtml.__name__]


def _hough_functions():
    return [n for n, v in vars(jhough).items()
            if inspect.isfunction(v) and v.__module__ == jhough.__name__]


COPIES = (
    [(jhtml, thtml, n) for n in _html_functions()]
    + [(jclust, tclust, n) for n in (
        "PageRegions", "group_regions_by_page", "_pad_pages", "average_linkage",
        "labels_from_linkage", "silhouette_score_precomputed", "ClusteringResult",
        "cluster_pages")]
    + [(jreports, treports, "_short"), (jreports, treports, "create_cluster_report"),
       (jcross, tcross, "prefix_length"), (jcross, tcross, "create_cross_comparison"),
       (jregion, tregion, "create_region_cross_comparison"),
       (jdemo, tdemo, "run_demo_queries"), (jworkflow, tworkflow, "reset_workflow")]
    + [(jhough, though, n) for n in _hough_functions()]
)


def _port_source(obj) -> str:
    return inspect.getsource(obj).replace("multimodal_embeddings_tpu_torch.",
                                          "multimodal_embeddings_tpu.")


@pytest.mark.parametrize("jmod,tmod,name", COPIES,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}" for _, t, n in COPIES])
def test_host_copy_has_the_jax_source(jmod, tmod, name):
    assert _port_source(getattr(tmod, name)) == inspect.getsource(getattr(jmod, name))


def test_copied_constants_equal_jax():
    for name, value in vars(jhtml).items():
        if name.isupper() or name == "_REGION_TYPE_CSS":
            assert getattr(thtml, name) == value, name
    np.testing.assert_array_equal(though._K5, jhough._K5)
    assert len(_html_functions()) >= 10 and len(_hough_functions()) >= 7


def test_similarity_host_tail_is_jax_lines():
    """After the device pass, ``compute_similarity_matrix`` runs JAX's lines
    from the pair-direction comment to the return."""
    def tail(fn):
        src = inspect.getsource(fn)
        return src[src.index("    # The reference computes each unordered pair ONCE"):]

    assert tail(tclust.compute_similarity_matrix) == tail(jclust.compute_similarity_matrix)


@pytest.mark.parametrize("name", ["plot_similarity_heatmap", "plot_dendrogram",
                                  "plot_similarity_network"])
def test_plot_body_after_imports_is_jax_lines(name):
    def body(src, marker):
        return src[src.index(marker) + len(marker):]

    jsrc = body(inspect.getsource(getattr(jreports, name)),
                "    except Exception:  # pragma: no cover\n        return False\n")
    lines = body(inspect.getsource(getattr(treports, name)),
                 "        return False\n").splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if line.strip() and not re.match(
        r"    (import |from |matplotlib\.use\()", line))
    assert lines[start - 1] == "\n" and "".join(lines[start:]) == jsrc


# -- compute_similarity_matrix ------------------------------------------------


def _pages(seed, counts, d=24, names=None):
    rng = np.random.default_rng(seed)
    pages = []
    for i, r in enumerate(counts):
        emb = rng.normal(size=(r, d)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        # a shared direction, so pairs clear the 0.1 accept threshold
        emb = emb + 0.6 * rng.normal(size=(1, d)).astype(np.float32) * (i % 2)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        areas = rng.uniform(0.001, 0.2, r).astype(np.float32)
        name = names[i] if names else f"page_{i:02d}.png"
        pages.append((name, emb.astype(np.float32), areas))
    return ([jclust.PageRegions(*p) for p in pages], [tclust.PageRegions(*p) for p in pages])


CASES = {
    "unequal": dict(counts=(14, 3, 25, 9, 12), kw={}),
    "no_area_weight": dict(counts=(14, 3, 25, 9, 12), kw=dict(weight_by_area=False)),
    "prefix_skip": dict(counts=(8, 11, 6, 13), kw=dict(prefix_skip=3),
                        names=("gaz_a", "gaz_b", "tri_a", "tri_b")),
    "fewer_than_top_k": dict(counts=(4, 2, 30, 7), kw=dict(top_k=10, query_limit=6)),
    "unnormalised": dict(counts=(5, 9, 12), kw=dict(normalize=False, accept_threshold=0.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_similarity_matrix_equals_jax(case):
    spec = CASES[case]
    jpages, tpages = _pages(7, spec["counts"], names=spec.get("names"))
    want = jclust.compute_similarity_matrix(jpages, **spec["kw"])
    got = tclust.compute_similarity_matrix(tpages, device="cpu", **spec["kw"])
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SIM_ATOL, rtol=0)
    assert np.count_nonzero(np.triu(want, 1)) > 0


def test_similarity_chunks_give_the_same_sums(monkeypatch):
    """Query pages taken 1, 2, 3 or all 7 at a time: the same sums."""
    _, tpages = _pages(3, (9, 4, 17, 6, 11, 2, 8))
    arrays = [torch.from_numpy(a) for a in tclust._pad_pages(tpages, 10)]
    whole = tclust.pair_scores(*arrays, 10, 0.1, True)
    per_page = 7 * 10 * 17  # scores of one query page
    for pages in (1, 2, 3, 7):
        monkeypatch.setattr(tclust, "_CHUNK_ELEMENTS", pages * per_page)
        assert torch.equal(tclust.pair_scores(*arrays, 10, 0.1, True), whole)


def test_similarity_refuses_the_card_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tpages = _pages(0, (3, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclust.compute_similarity_matrix(tpages)
    assert tclust.compute_similarity_matrix([], device="cpu").shape == (0, 0)


def _tie_pages():
    """Page 1 holds region b twice (indices 2 and 3) with areas 0.05 and
    0.4, and two better matches for page 0's query; with top_k = 3 the
    third place falls between the two equal copies. Values are small
    binary fractions, so every product and sum is exact in f32 and the tie
    is exact in both frameworks."""
    d = 8
    q = np.zeros(d, np.float32)
    q[:4] = 0.5
    best = np.zeros(d, np.float32)
    best[:4] = 0.5
    second = np.zeros(d, np.float32)
    second[:3] = 0.5
    second[4] = 0.5
    tied = np.zeros(d, np.float32)
    tied[:2] = 0.5
    tied[4:6] = 0.5
    low = np.zeros(d, np.float32)
    low[6] = 1.0
    page0 = ("a.png", np.stack([q, low]), np.asarray([0.25, 0.125], np.float32))
    page1 = ("b.png", np.stack([best, second, tied, tied, low, low]),
             np.asarray([0.25, 0.125, 0.05, 0.4, 0.5, 0.5], np.float32))
    return [page0, page1]


def test_similarity_tie_at_the_kth_place_equals_jax():
    raw = _tie_pages()
    jpages = [jclust.PageRegions(*p) for p in raw]
    tpages = [tclust.PageRegions(*p) for p in raw]
    kw = dict(top_k=3, normalize=False)
    want = jclust.compute_similarity_matrix(jpages, **kw)
    got = tclust.compute_similarity_matrix(tpages, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    # query q: best, second and the lower copy (area 0.05) in third place,
    # 1·.25·.25 + .75·.25·.125 + .5·.25·.05; query low: the two low regions
    # (sim 1, area .5), the third at sim 0 adds nothing
    assert want[0, 1] == pytest.approx(0.0625 + 0.0234375 + 0.00625 + 2 * 0.0625, abs=1e-7)
    # the higher copy (area 0.4) would give another sum
    swapped = [raw[0], (raw[1][0], raw[1][1], raw[1][2][[0, 1, 3, 2, 4, 5]])]
    other = jclust.compute_similarity_matrix([jclust.PageRegions(*p) for p in swapped], **kw)
    assert abs(other[0, 1] - want[0, 1]) > 0.04
    # torch.topk alone picks the higher copy on this row here: its order would miss
    sims = torch.from_numpy(raw[0][1][:1] @ raw[1][1].T)[0]
    picked = set(torch.topk(sims, 3).indices.tolist())
    stable = set(torch.sort(sims, descending=True, stable=True).indices[:3].tolist())
    assert stable == {0, 1, 2}
    assert picked == {0, 1, 3}, picked


def test_cluster_pages_equals_jax():
    jpages, tpages = _pages(11, (6, 9, 4, 12, 7, 5, 10, 8), names=[
        f"{p}_{i}.png" for i, p in enumerate("aabbccdd")])
    sim = tclust.compute_similarity_matrix(tpages, device="cpu")
    for n_clusters in (None, 3):
        want = jclust.cluster_pages(sim, [p.name for p in jpages], n_clusters=n_clusters)
        got = tclust.cluster_pages(sim, [p.name for p in tpages], n_clusters=n_clusters)
        np.testing.assert_array_equal(got.linkage, want.linkage)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert (got.n_clusters, got.silhouette, got.cohesion, got.names) == (
            want.n_clusters, want.silhouette, want.cohesion, want.names)
        assert got.clusters() == want.clusters()


# -- reports on the same store contents ---------------------------------------


REPORT_PAGES = ("gazette_0.png", "gazette_1.png", "tribune_2.png")
REGIONS_PER_PAGE = 4


def _rows(folder):
    """Seeded whole-page and region rows (the stores' schema), and the page
    images they point to."""
    rng = np.random.default_rng(5)
    os.makedirs(folder, exist_ok=True)
    ids, embs, metas = [], [], []
    for p, name in enumerate(REPORT_PAGES):
        path = os.path.join(folder, name)
        Image.fromarray(rng.integers(0, 255, (90, 70, 3), dtype=np.uint8)).save(path)
        ids.append(name)
        embs.append(rng.normal(size=32))
        metas.append({"image_name": name, "image_path": path,
                      "processed_time": "2026-01-01 00:00:00", "is_region": False})
        for r in range(REGIONS_PER_PAGE):
            x1, y1 = float(rng.integers(0, 30)), float(rng.integers(0, 40))
            x2, y2 = x1 + float(rng.integers(5, 35)), y1 + float(rng.integers(5, 45))
            ids.append(f"region_{name[:-4]}_{r}")
            embs.append(rng.normal(size=32) + 0.5)
            metas.append({
                "parent_image": path, "parent_image_name": name, "region_index": r,
                "region_type": ("plain_text", "title", "figure")[r % 3],
                "region_class_id": 1.0, "region_score": 0.5, "box": f"{x1},{y1},{x2},{y2}",
                "box_normalized": "0,0,1,1",
                "area_percentage": (x2 - x1) * (y2 - y1) / (70 * 90) * 100.0,
                "width": x2 - x1, "height": y2 - y1, "is_region": True})
    # a region whose box does not parse: no composite for it in either
    metas[-1]["box"] = "1,2,x,4"
    return ids, [e.tolist() for e in embs], metas


class _FixedEmbedder:
    def __init__(self, dim=32):
        rng = np.random.default_rng(9)
        self.image, self.text = rng.normal(size=dim).tolist(), rng.normal(size=dim).tolist()

    def get_image_embeddings(self, paths, is_query=False, batch_size=None):
        return [self.image if os.path.exists(p) else None for p in paths]

    def get_text_embeddings(self, text):
        return self.text


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    from multimodal_embeddings_tpu.store.embedding_store import initialize_db as jdb
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db as tdb

    root = tmp_path_factory.mktemp("reports")
    ids, embs, metas = _rows(str(root / "pages"))
    out = {}
    for name, init, mods in (
        ("jax", lambda p: jdb(p)[1], (jcross, jregion, jdemo, jclust, jreports)),
        ("torch", lambda p: tdb(p, device="cpu")[1], (tcross, tregion, tdemo, tclust,
                                                      treports)),
    ):
        cross, region, demo, clust, rep = mods
        work = root / name
        col = init(str(work / "db"))
        col.upsert(ids=ids, embeddings=embs, metadatas=[dict(m) for m in metas])
        n_cross = cross.create_cross_comparison(col, output_folder=str(work / "cross_compare"))
        n_region = region.create_region_cross_comparison(
            col, output_folder=str(work / "region_compare"), similarity_threshold=0.1)
        demo.run_demo_queries(_FixedEmbedder(), col, test_image=str(root / "pages" /
                                                                    REPORT_PAGES[0]),
                              output_folder=str(work / "testout"), top_n=6)
        pages = clust.group_regions_by_page(col, region_types=None)
        kw = {} if name == "jax" else {"device": "cpu"}
        sim = clust.compute_similarity_matrix(pages, prefix_skip=2, **kw)
        result = jclust.cluster_pages(sim, [p.name for p in pages])
        rep.create_cluster_report(sim, result, str(work / "weighted_clustering"))
        out[name] = dict(n=(n_cross, n_region), sim=sim, trees={
            sub: _tree(str(work / sub))
            for sub in ("cross_compare", "region_compare", "testout", "weighted_clustering")})
    return out


@pytest.mark.parametrize("sub", ["cross_compare", "region_compare", "testout"])
def test_report_tree_byte_identical_to_jax(reports, sub):
    j, t = reports["jax"]["trees"][sub], reports["torch"]["trees"][sub]
    assert sorted(t) == sorted(j)
    assert len(j) > 2
    for name in j:
        assert t[name] == j[name], name


def test_report_counts_and_composites(reports):
    assert reports["torch"]["n"] == reports["jax"]["n"] == (3, 3 * REGIONS_PER_PAGE)
    composites = [n for n in reports["jax"]["trees"]["region_compare"]
                  if n.startswith("comparisons" + os.sep)]
    assert len(composites) > 10
    results = reports["torch"]["trees"]["testout"]["query_results.txt"].decode()
    assert [line for line in results.splitlines() if line.startswith("===")] == [
        "=== img_query_pages ===", "=== img_query_regions ===", "=== txt_query_pages ===",
        "=== txt_query_regions ==="]


def test_cluster_report_equal_jax(reports):
    j = reports["jax"]["trees"]["weighted_clustering"]
    t = reports["torch"]["trees"]["weighted_clustering"]
    assert sorted(t) == sorted(j)
    assert json.loads(t["clustering_results.json"]) == json.loads(j["clustering_results.json"])
    np.testing.assert_allclose(reports["torch"]["sim"], reports["jax"]["sim"], atol=SIM_ATOL,
                               rtol=0)
    stamp = re.compile(rb"Generated on: [0-9: -]+")
    assert stamp.sub(b"", t["clustering_report.html"]) == stamp.sub(
        b"", j["clustering_report.html"])


def test_cluster_report_npy_equal_on_one_matrix(tmp_path):
    """The same similarity matrix and result write the same JSON and .npy."""
    _, tpages = _pages(2, (5, 7, 3, 6))
    sim = tclust.compute_similarity_matrix(tpages, device="cpu")
    result = tclust.cluster_pages(sim, [p.name for p in tpages])
    treports.create_cluster_report(sim, result, str(tmp_path / "t"))
    jreports.create_cluster_report(sim, result, str(tmp_path / "j"))
    for name in ("similarity_matrix.npy", "clustering_results.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("missing", ["matplotlib", "networkx"])
def test_plots_return_false_without_their_library(tmp_path, monkeypatch, missing):
    monkeypatch.setitem(sys.modules, missing, None)
    _, tpages = _pages(2, (5, 7, 3))
    sim = tclust.compute_similarity_matrix(tpages, device="cpu")
    result = tclust.cluster_pages(sim, [p.name for p in tpages])
    assert not treports.plot_similarity_network(sim, result, str(tmp_path / "n.png"))
    if missing == "matplotlib":
        assert not treports.plot_similarity_heatmap(sim, result.names, str(tmp_path / "h.png"))
        assert not treports.plot_dendrogram(result, str(tmp_path / "d.png"))
    assert not os.listdir(tmp_path)


def test_demo_copy_failure_is_logged(tmp_path, monkeypatch):
    """A failed copy is logged with JAX's message and the run goes on."""
    src = tmp_path / "p.png"
    src.write_bytes(b"x")
    results = {"ids": [["a", "b"]], "distances": [[0.1, 0.2]],
               "metadatas": [[{"image_path": str(src)}, {"image_path": str(src)}]]}
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("mmtpu.demo_queries").addHandler(handler)

    def fail(*args):
        raise PermissionError("denied")

    monkeypatch.setattr(tdemo.shutil, "copy2", fail)
    lines = []
    tdemo._copy_ranked(results, str(tmp_path / "out"), "tag", lines)
    logging.getLogger("mmtpu.demo_queries").removeHandler(handler)
    assert lines == ["\n=== tag ===", " 1. a  similarity=0.9000", " 2. b  similarity=0.8000"]
    assert [r.getMessage() for r in records] == [f"copy failed for {src}: denied"] * 2
    monkeypatch.setattr(tdemo.shutil, "copy2", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tdemo._copy_ranked(results, str(tmp_path / "out"), "tag", [])


BOXES = ["1,2,3,4", " 1.5 , -2e3,+.5,7.", "1_000,2,3,4", "inf,-Infinity,NaN,nan", "1,2,x,4",
         "1,,3,4", "1__0,2,3,4", "_1,2,3,4", "1e,2,3,4", ".,2,3,4", "1 2,3,4,5", "0x10,1,2,3",
         "1.5e-3,2E+2,3,4", "٣,2,3,4", "1,2,3", "1,2,3,4,5", "e5,1,2,3", "--1,2,3,4",
         "1_,2,3,4", "1._5,2,3,4", "\t7\n,8,9,10", "infinit,1,2,3", ""]


@pytest.mark.parametrize("box", BOXES)
def test_box_from_meta_equals_jax(box):
    for meta in ({"box": box}, {"box_str": box}, {"box": "", "box_str": box}):
        got, want = tregion._box_from_meta(meta), jregion._box_from_meta(meta)
        if want is None:
            assert got is None
        else:
            assert type(got) is list and len(got) == len(want)
            np.testing.assert_array_equal(got, want)  # NaN equal to NaN


def test_box_from_meta_non_string_raises_as_jax():
    assert tregion._box_from_meta({}) is None is jregion._box_from_meta({})
    for mod in (tregion, jregion):
        with pytest.raises(AttributeError):
            mod._box_from_meta({"box": [1.0, 2.0, 3.0, 4.0]})


def test_region_comparison_composite(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    paths = []
    for i, shape in enumerate(((300, 200, 3), (240, 260, 3))):
        paths.append(str(tmp_path / f"p{i}.png"))
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(paths[-1])
    args = (paths[0], paths[1], [10.5, 20.0, 90.0, 150.0], [0.0, 5.0, 200.0, 100.0], 0.4321)
    for banner in (None, "score 0.4321 | weighted 0.000123"):
        assert jviz.region_comparison_composite(*args, str(tmp_path / "j.jpg"), banner=banner)
        assert tviz.region_comparison_composite(*args, str(tmp_path / "t.jpg"), banner=banner)
        assert (tmp_path / "t.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()
    assert not tviz.region_comparison_composite(paths[0], str(tmp_path / "none.png"),
                                                *args[2:], str(tmp_path / "x.jpg"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert not tviz.region_comparison_composite(*args, str(tmp_path / "y.jpg"))
    assert not (tmp_path / "x.jpg").exists() and not (tmp_path / "y.jpg").exists()


# -- trace, hough, letterbox, crop_and_resize --------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    from multimodal_embeddings_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "trace")) as span:
        with annotate("the_span"):
            torch.ones(8).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json") and span.path.endswith(files[0])
    events = json.loads((tmp_path / "trace" / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "the_span" for e in events)
    with trace(None) as off:
        pass
    assert off.path is None


@pytest.mark.parametrize("angle", [0.0, -2.5, 3.0])
def test_detect_skew_hough_equals_jax(angle):
    from multimodal_embeddings_tpu_torch.ops.image import rotate_bound
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    page = make_page(360, 300, seed=21)
    if angle:
        page = np.clip(rotate_bound(torch.from_numpy(page), angle).numpy(), 0, 255).astype(
            np.uint8)
    want = jhough.detect_skew_hough(page)
    assert though.detect_skew_hough(page) == want
    if angle:
        assert want is not None and abs(want + angle) < 1.0, want


@pytest.mark.parametrize("shape,size", [((37, 53, 3), 64), ((80, 30), 48), ((50, 50, 1), 32)])
def test_letterbox_equals_jax(shape, size):
    import jax.numpy as jnp

    from multimodal_embeddings_tpu.ops import image as jimage
    from multimodal_embeddings_tpu_torch.ops import image as timage

    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    jc, js, jp = jimage.letterbox(jnp.asarray(img), size)
    tc, ts, tp = timage.letterbox(torch.from_numpy(img), size)
    assert (ts, tp) == (js, jp) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4, rtol=0)


def test_crop_and_resize_equals_jax():
    import jax
    import jax.numpy as jnp

    from multimodal_embeddings_tpu.ops import image as jimage
    from multimodal_embeddings_tpu_torch.ops import image as timage

    rng = np.random.default_rng(6)
    img = rng.uniform(0, 255, (70, 90, 3)).astype(np.float32)
    boxes = np.asarray([[3.5, 4.0, 40.0, 60.5], [0, 0, 90, 70], [80, 60, 80.5, 60.2],
                        [-5, -3, 20, 10]], np.float32)
    got = timage.crop_and_resize(torch.from_numpy(img), torch.from_numpy(boxes), out_size=24)
    assert got.shape == (4, 24, 24, 3) and got.dtype == torch.float32
    # JAX's ops as written (its jit off) within 1e-4: each op rounded once
    # in both
    with jax.disable_jit():
        eager = np.asarray(jimage.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes),
                                                  out_size=24))
    np.testing.assert_allclose(got.numpy(), eager, atol=1e-4, rtol=0)
    # the jitted JAX function fuses the coordinate math (one rounding fewer),
    # which moves the samples of the box that crosses the border by up to
    # 1e-3: the three boxes inside the image are held to it at 1e-4
    jitted = np.asarray(jimage.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes),
                                               out_size=24))
    np.testing.assert_allclose(got.numpy()[:3], jitted[:3], atol=1e-4, rtol=0)
