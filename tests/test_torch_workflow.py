"""The port's integrated workflow CLI (``cli/workflow.py``) and demo CLI
(``cli/demo.py``) against the JAX package's, on the CPU.

* Both workflow CLIs run ``--stage all --run_cross_compare
  --run_region_compare --run_demo`` over the same 4 synthetic pages (one
  rotated, so orientation writes a corrected copy) on the same ``.npz``
  weights, each in its own working directory (the CLIs write
  ``cross_compare/``, ``region_compare/``, ``testout/`` and
  ``newspaper_process.log`` there): equal store ids, metadata schema and
  progress files, the same files in every output folder, page embeddings
  within a stated tolerance, and the same clustering. Which near-tied boxes
  the random detector keeps is not compared (``test_torch_fused.py``): the
  region ids agree, their boxes may differ in the last bits.
* A second ``--stage all`` run detects and embeds nothing and adds no row;
  ``--reset`` removes what JAX's removes; ``--device cuda`` raises without
  a card; the flags are JAX's plus ``--device``; ``--trace_dir`` writes a
  Chrome trace; one mme5 run at the tiny Mllama config; the demo CLI.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from flax.linen import unbox

from multimodal_embeddings_tpu.cli import demo as jdemo_cli
from multimodal_embeddings_tpu.cli import workflow as jworkflow
from multimodal_embeddings_tpu.models import embedder as jembedder
from multimodal_embeddings_tpu_torch.cli import demo as tdemo_cli
from multimodal_embeddings_tpu_torch.cli import workflow as tworkflow

torch.set_num_threads(2)

PAGE_NAMES = ("gazette_0.png", "gazette_1.png", "tribune_2.png", "tribune_3.png")
PAGE_HW = (200, 160)
ROTATED = {1: 4.0}  # page index: degrees
TINY = ["--imgsz", "64", "--variant", "n", "--embedder_size", "tiny"]
REPORTS = ["--run_cross_compare", "--run_region_compare", "--run_demo"]
# Both CLIs compute in bf16 (the detector and the tiny siglip tower), each
# framework rounding its own ops: the whole-page embeddings are unit vectors
# held at cosine >= 0.999 (BASELINE.json's parity target) and 2e-2 absolute,
# as tests/test_torch_serve.py holds the serving CLIs.
PAGE_COS_MIN, PAGE_ATOL = 0.999, 2e-2
OUTPUT_FOLDERS = ("output", "cross_compare", "region_compare", "testout")


def _make_pages(folder):
    from multimodal_embeddings_tpu_torch.ops.image import rotate_bound
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    os.makedirs(folder, exist_ok=True)
    for i, name in enumerate(PAGE_NAMES):
        page = make_page(*PAGE_HW, seed=50 + i)
        if i in ROTATED:
            rot = rotate_bound(torch.from_numpy(page), ROTATED[i]).numpy()
            top = (rot.shape[0] - PAGE_HW[0]) // 2
            left = (rot.shape[1] - PAGE_HW[1]) // 2
            page = np.clip(rot[top : top + PAGE_HW[0], left : left + PAGE_HW[1]], 0, 255)
        Image.fromarray(page.astype(np.uint8)).save(os.path.join(folder, name))


def _files(root, folders=OUTPUT_FOLDERS):
    out = {}
    for folder in folders:
        for dirpath, _, files in os.walk(os.path.join(root, folder)):
            for name in files:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, root)] = f.read()
    return out


def _open(name, db):
    if name == "jax":
        from multimodal_embeddings_tpu.store.embedding_store import initialize_db

        return initialize_db(db)[1]
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

    return initialize_db(db, device="cpu")[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
    from multimodal_embeddings_tpu.config import EmbedderConfig as JEmbedderConfig
    from multimodal_embeddings_tpu.models.detector import LayoutDetector as JDetector
    from multimodal_embeddings_tpu.models.embedder import MultimodalEmbedder as JEmbedder
    from multimodal_embeddings_tpu.models.vision_encoder import DualEncoderConfig as JDual
    from multimodal_embeddings_tpu.models.weights import save_checkpoint

    root = tmp_path_factory.mktemp("workflow_weights")
    _make_pages(str(root / "pages"))
    det = JDetector(JDetectorConfig(image_size=64, variant="n"), seed=3)
    emb = JEmbedder(JEmbedderConfig(family="siglip"), model_config=JDual.tiny(), seed=4)
    save_checkpoint(det.variables, str(root / "det.npz"))
    save_checkpoint(emb.variables, str(root / "emb.npz"))
    return dict(root=root, pages=str(root / "pages"),
                args=["--detector_weights", str(root / "det.npz"),
                      "--embedder_weights", str(root / "emb.npz")])


def _workflow_args(weights, *extra):
    return ["--input_folder", weights["pages"], *TINY, *weights["args"], *extra]


@pytest.fixture(scope="module")
def both_workflows(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("workflows")
    demo = ["--demo_image", os.path.join(weights["pages"], PAGE_NAMES[0])]
    out = {}
    init = jembedder.deterministic_init_multi
    with pytest.MonkeyPatch.context() as mp:
        # the JAX engine's load target keeps the text tower's boxed leaves,
        # which an .npz never matches: it is handed its init unboxed (as
        # test_torch_serve.py does)
        mp.setattr(jembedder, "deterministic_init_multi",
                   lambda model, args, seed=0: unbox(init(model, args, seed=seed)))
        os.makedirs(root / "jax")
        mp.chdir(root / "jax")
        assert jworkflow.main(_workflow_args(weights, *REPORTS, *demo)) == 0
    with pytest.MonkeyPatch.context() as mp:
        os.makedirs(root / "torch")
        mp.chdir(root / "torch")
        assert tworkflow.main(_workflow_args(weights, *REPORTS, *demo, "--device", "cpu",
                                             "--trace_dir", str(root / "trace"))) == 0
    for name in ("jax", "torch"):
        work = str(root / name)
        store = _open(name, os.path.join(work, "db")).get(include=("embeddings", "metadatas"))
        out[name] = dict(work=work, store=store, files=_files(work))
    out["trace"] = str(root / "trace")
    return out


def test_workflow_ids_and_progress_equal_jax(both_workflows):
    j, t = both_workflows["jax"], both_workflows["torch"]
    assert sorted(t["store"]["ids"]) == sorted(j["store"]["ids"])
    assert sum(i.startswith("region_") for i in j["store"]["ids"]) >= len(PAGE_NAMES)
    progress = sorted(k for k in j["files"] if k.endswith("_progress.json"))
    assert len(progress) == 6
    for name in progress:
        assert t["files"][name] == j["files"][name], name


def test_workflow_metadata_schema_equal_jax(both_workflows):
    def schema(store):
        out = {}
        for rid, meta in zip(store["ids"], store["metadatas"]):
            fixed = {k: v for k, v in meta.items()
                     if k in ("is_region", "image_name", "parent_image_name", "region_index",
                              "region_type")}
            out[rid] = (sorted(meta), {k: type(v).__name__ for k, v in meta.items()}, fixed)
        return out

    assert schema(both_workflows["torch"]["store"]) == schema(both_workflows["jax"]["store"])


def test_workflow_writes_the_jax_files(both_workflows):
    """The same file names in output/, cross_compare/, region_compare/ and
    testout/ (the demo's copies are named by rank: compared as sets), and
    the oriented copy of the rotated page."""
    def names(files):
        return {k for k in files if not k.startswith("testout" + os.sep)}, {
            re.sub(r"_\d\d_", "_", k) for k in files if k.startswith("testout" + os.sep)}

    assert names(both_workflows["torch"]["files"]) == names(both_workflows["jax"]["files"])
    files = both_workflows["torch"]["files"]
    for name in PAGE_NAMES:
        assert os.path.join("output", "oriented_images", name) in files
        stem = name[:-4]
        assert os.path.join("cross_compare", f"{stem}_comparison.html") in files
    for name in ("clustering_results.json", "similarity_matrix.npy", "clustering_report.html",
                 "similarity_heatmap.png", "dendrogram.png", "similarity_network.png"):
        assert os.path.join("output", "weighted_clustering", name) in files
    for name in ("cross_compare/index.html", "region_compare/index.html",
                 "testout/query_results.txt"):
        assert name in files
    assert os.path.isfile(os.path.join(both_workflows["torch"]["work"], "newspaper_process.log"))


def test_workflow_page_embeddings_close_to_jax(both_workflows):
    def pages(store):
        return {i: np.asarray(e) for i, e in zip(store["ids"], store["embeddings"])
                if not i.startswith("region_")}

    got, want = pages(both_workflows["torch"]["store"]), pages(both_workflows["jax"]["store"])
    assert sorted(got) == sorted(want) == sorted(PAGE_NAMES)
    for name in got:
        cos = float(got[name] @ want[name] / (np.linalg.norm(got[name]) *
                                              np.linalg.norm(want[name])))
        assert cos >= PAGE_COS_MIN, (name, cos)
        np.testing.assert_allclose(got[name], want[name], atol=PAGE_ATOL, rtol=0)


def test_workflow_clustering_equal_jax(both_workflows):
    path = os.path.join("output", "weighted_clustering", "clustering_results.json")
    got = json.loads(both_workflows["torch"]["files"][path])
    want = json.loads(both_workflows["jax"]["files"][path])
    assert got["names"] == want["names"] == list(PAGE_NAMES)
    # the same clusters; the scores move with the bf16 embeddings
    assert (got["labels"], got["n_clusters"]) == (want["labels"], want["n_clusters"])
    assert got["silhouette"] == pytest.approx(want["silhouette"], abs=1e-3)
    assert got["cohesion"].keys() == want["cohesion"].keys()
    for key in want["cohesion"]:
        assert got["cohesion"][key] == pytest.approx(want["cohesion"][key], abs=1e-3)


def test_workflow_demo_sections_equal_jax(both_workflows):
    def sections(files):
        text = files[os.path.join("testout", "query_results.txt")].decode()
        # the ranked lines carry bf16 similarities, whose order may differ
        return [line for line in text.splitlines() if not re.match(r"\s*\d+\. ", line)]

    got = sections(both_workflows["torch"]["files"])
    assert got == sections(both_workflows["jax"]["files"])
    assert sum(line.startswith("===") for line in got) == 4


def test_workflow_trace_written(both_workflows):
    files = os.listdir(both_workflows["trace"])
    assert len(files) == 1 and files[0].endswith(".json")


def test_second_run_is_a_noop(both_workflows, weights, monkeypatch):
    """Nothing is detected or embedded again, and no row is added."""
    from multimodal_embeddings_tpu_torch.models import detector as tdetector
    from multimodal_embeddings_tpu_torch.models import embedder as tembedder

    calls = []
    for cls, name in ((tdetector.LayoutDetector, "detect_batch"),
                      (tembedder.MultimodalEmbedder, "get_image_embeddings")):
        fn = getattr(cls, name)
        monkeypatch.setattr(cls, name, lambda self, *a, fn=fn, name=name, **k: (
            calls.append(name), fn(self, *a, **k))[1])
    work = both_workflows["torch"]["work"]
    monkeypatch.chdir(work)
    before = _files(work, ("output",))
    assert tworkflow.main(_workflow_args(weights, "--device", "cpu")) == 0
    assert calls == []
    assert sorted(_open("torch", os.path.join(work, "db")).get()["ids"]) == sorted(
        both_workflows["torch"]["store"]["ids"])
    after = _files(work, ("output",))
    changed = {k for k in after if after.get(k) != before.get(k)}
    # the cluster stage runs again and writes its report (a new timestamp)
    assert changed <= {os.path.join("output", "weighted_clustering", n) for n in (
        "clustering_report.html", "similarity_heatmap.png", "dendrogram.png",
        "similarity_network.png", "similarity_matrix.npy", "clustering_results.json")}
    for name in ("similarity_matrix.npy", "clustering_results.json"):
        key = os.path.join("output", "weighted_clustering", name)
        assert after[key] == before[key]


def test_reset_removes_what_jax_removes(tmp_path, monkeypatch):
    left = {}
    for name, main, extra in (("jax", jworkflow.main, []),
                              ("torch", tworkflow.main, ["--device", "cpu"])):
        work = tmp_path / name
        for folder in ("db/c", "output/x", "cross_compare", "region_compare", "testout",
                       "keep", "empty"):
            os.makedirs(work / folder)
        for path in ("db/c/a.npz", "output/x/b.json", "testout/q.txt", "keep/k.txt",
                     "newspaper_process.log"):
            (work / path).write_text(path)
        monkeypatch.chdir(work)
        # no images: the run stops after the reset
        assert main(["--reset", "--input_folder", "empty", *extra]) == 1
        left[name] = sorted(os.path.relpath(os.path.join(d, f), work)
                            for d, dirs, files in os.walk(work) for f in files + dirs)
    assert left["torch"] == left["jax"]
    assert "keep" in left["torch"] and "db" not in left["torch"]


def test_cli_refuses_the_card_without_one(weights, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworkflow.main(_workflow_args(weights))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdemo_cli.main(["--db_path", str(tmp_path / "db")])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("port,jax", [(tworkflow, jworkflow), (tdemo_cli, jdemo_cli)],
                         ids=["workflow", "demo"])
def test_flags_are_jax_flags_and_device(port, jax):
    ours = {a.dest: a.default for a in port.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and ours.pop("device") == "cuda"
    assert ours == theirs


def test_mme5_workflow_run(weights, tmp_path, monkeypatch):
    """``--embedder_family mme5`` builds the default mmE5 config, as JAX's
    CLI does; here that default is the tiny Mllama config."""
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig

    monkeypatch.setattr(MllamaConfig, "mme5_11b", classmethod(lambda cls: cls.tiny()))
    monkeypatch.chdir(tmp_path)
    args = ["--input_folder", weights["pages"], *TINY, "--detector_weights",
            weights["args"][1], "--embedder_family", "mme5", "--device", "cpu",
            "--skip_orientation", "--run_demo", "--demo_image",
            os.path.join(weights["pages"], PAGE_NAMES[0])]
    assert tworkflow.main(args) == 0
    store = _open("torch", str(tmp_path / "db")).get(include=("embeddings",))
    pages = [i for i in store["ids"] if not i.startswith("region_")]
    assert sorted(pages) == sorted(PAGE_NAMES)
    assert len({len(e) for e in store["embeddings"]}) == 1
    assert all(np.isfinite(e).all() for e in store["embeddings"])
    results = (tmp_path / "testout" / "query_results.txt").read_text()
    assert results.count("===") == 8
    assert (tmp_path / "output" / "weighted_clustering" / "clustering_results.json").exists()


def test_demo_cli_on_the_workflow_store(both_workflows, weights, tmp_path, monkeypatch):
    """The demo CLI builds the default dual encoder (here the tiny one) on
    the workflow's weights and store; an empty store exits 1."""
    from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig

    monkeypatch.setattr(DualEncoderConfig, "base", classmethod(lambda cls: cls.tiny()))
    shutil.copytree(os.path.join(both_workflows["torch"]["work"], "db"), tmp_path / "db")
    monkeypatch.chdir(tmp_path)
    args = ["--db_path", "db", "--test_image", os.path.join(weights["pages"], PAGE_NAMES[2]),
            "--top_n", "3", "--embedder_weights", weights["args"][3], "--device", "cpu"]
    assert tdemo_cli.main(args) == 0
    text = (tmp_path / "testout" / "query_results.txt").read_text()
    assert [line for line in text.splitlines() if line.startswith("===")] == [
        "=== img_query_pages ===", "=== img_query_regions ===", "=== txt_query_pages ===",
        "=== txt_query_regions ==="]
    assert f" 1. {PAGE_NAMES[2]}  similarity=" in text
    assert tdemo_cli.main(["--db_path", "empty_db", "--device", "cpu"]) == 1
