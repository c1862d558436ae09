"""The port's serving CLI and its host modules against the JAX package's,
on the CPU.

* The host copies (``io/logging_setup.py``, ``io/json_io.py``,
  ``io/progress.py``, ``io/images.py``, ``pipeline/regions.py``'s region
  helpers, ``ops/grid.py::translate_boxes``,
  ``models/yolo_decode.py::scale_boxes_to_original``, ``bucket_for``) have
  the JAX sources, and the progress tracker writes the same file.
* ``Prefetcher``: the cases of JAX's ``TestPrefetcher``, and the
  error-as-value ``next_entry`` the CLI reads.
* The tiny server (``--imgsz 64 --variant n --grid_configs "" --num_regions
  4 --embedder_size tiny``, siglip and mme5) ingests every page, skips a
  corrupt one, does nothing on a second run, and the pipelined run gives the
  store of the sequential one, bit for bit.
* The port's CLI against JAX's CLI, both given the same ``.npz`` weights:
  the ids, the metadata schema, the progress file and the page embeddings
  (bf16 in both, so within a stated tolerance). Which near-tied boxes the
  random detector keeps is not compared (``test_torch_fused.py``).
"""

import inspect
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from flax.linen import unbox

from multimodal_embeddings_tpu.cli import serve as jserve
from multimodal_embeddings_tpu.io import images as jimages
from multimodal_embeddings_tpu.io import json_io as jjson
from multimodal_embeddings_tpu.io import logging_setup as jlog
from multimodal_embeddings_tpu.io import progress as jprogress
from multimodal_embeddings_tpu.models import embedder as jembedder
from multimodal_embeddings_tpu.models import yolo_decode as jdecode
from multimodal_embeddings_tpu.ops import grid as jgrid
from multimodal_embeddings_tpu.pipeline import regions as jregions
from multimodal_embeddings_tpu_torch.cli import serve as tserve
from multimodal_embeddings_tpu_torch.io import images as timages
from multimodal_embeddings_tpu_torch.io import json_io as tjson
from multimodal_embeddings_tpu_torch.io import logging_setup as tlog
from multimodal_embeddings_tpu_torch.io import progress as tprogress
from multimodal_embeddings_tpu_torch.io.prefetch import PrefetchError, Prefetcher
from multimodal_embeddings_tpu_torch.models import yolo_decode as tdecode
from multimodal_embeddings_tpu_torch.ops import grid as tgrid
from multimodal_embeddings_tpu_torch.pipeline import regions as tregions

torch.set_num_threads(2)

COPIES = [
    (jlog, tlog, "configure"), (jlog, tlog, "get_logger"),
    (jjson, tjson, "NumpyJSONEncoder"), (jjson, tjson, "load_json"),
    (jjson, tjson, "save_json"), (jjson, tjson, "regions_dict"),
    (jjson, tjson, "filtered_regions_dict"), (jjson, tjson, "combined_regions_dict"),
    (jjson, tjson, "median_width_dict"), (jjson, tjson, "columns_dict"),
    (jprogress, tprogress, "tracker_for"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "is_completed"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "mark_completed"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "mark_many"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "reset"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "completed"),
    (jprogress.ProgressTracker, tprogress.ProgressTracker, "_flush"),
    (jimages, timages, "get_image_paths"),
    (jregions, tregions, "crop_box_with_padding"), (jregions, tregions, "region_metadata"),
    (jregions.ImageProcessor, tregions.ImageProcessor, "process_image"),
    (jregions.ImageProcessor, tregions.ImageProcessor, "process_images"),
    (jregions.RegionProcessor, tregions.RegionProcessor, "process_image_regions"),
    (jgrid, tgrid, "translate_boxes"), (jdecode, tdecode, "scale_boxes_to_original"),
    (jserve, tserve, "bucket_for"),
]


@pytest.mark.parametrize("jmod,tmod,name", COPIES,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}" for _, t, n in COPIES])
def test_host_copy_has_the_jax_source(jmod, tmod, name):
    assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(getattr(jmod, name))


def test_host_constants_equal_jax():
    from multimodal_embeddings_tpu import config as jconfig

    assert timages.IMAGE_EXTENSIONS == jconfig.IMAGE_EXTENSIONS
    assert tserve.DEFAULT_BUCKETS == jserve.DEFAULT_BUCKETS
    assert tprogress.PHASES == jprogress.PHASES
    assert tlog._ROOT_NAME == jlog._ROOT_NAME


@pytest.mark.parametrize("body", [None, b"not json", b'{"a": 1}', b"5"])
def test_progress_tracker_writes_the_jax_file(tmp_path, body):
    """Same marks, same bytes; a file that is not a JSON list loads as no
    progress in both (5 is not iterable; a dict gives its keys in both)."""
    files = {}
    for name, mod in (("jax", jprogress), ("torch", tprogress)):
        path = tmp_path / name / "serve_progress.json"
        if body is not None:
            path.parent.mkdir()
            path.write_bytes(body)
        tracker = mod.ProgressTracker(str(path))
        tracker.mark_completed("p/1.png")
        tracker.mark_many(["p/2.png", "p/1.png", "p/3.png"])
        tracker.mark_completed("p/2.png")
        files[name] = (path.read_bytes(), tracker.completed(), mod.ProgressTracker(
            str(path)).completed())
    assert files["torch"] == files["jax"]


def test_image_helpers_equal_jax(tmp_path):
    arr = np.random.default_rng(0).integers(0, 255, (37, 53, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"nope")
    np.testing.assert_array_equal(timages.load_image_rgb(path), jimages.load_image_rgb(path))
    assert timages.image_size(path) == jimages.image_size(path) == (53, 37)
    for p in (path, str(bad), str(tmp_path / "missing.png")):
        assert timages.validate_image(p) == jimages.validate_image(p)
    assert timages.get_image_paths(str(tmp_path)) == [str(bad), path]


# -- Prefetcher: the cases of JAX's TestPrefetcher ---------------------------


class TestPrefetcher:
    def test_order_preserved(self):
        items = list(range(20))
        got = list(Prefetcher(items, lambda x: x * x, depth=3))
        assert got == [(i, i * i) for i in items]

    def test_error_raised_at_failing_item_position(self):
        def fn(x):
            if x == 2:
                raise ValueError("boom")
            return -x

        it = iter(Prefetcher([0, 1, 2, 3], fn))
        assert next(it) == (0, 0)
        assert next(it) == (1, -1)
        with pytest.raises(PrefetchError) as err:
            next(it)
        assert err.value.item == 2
        assert isinstance(err.value.cause, ValueError)
        # the failing item is skipped, not fatal to the stream
        assert next(it) == (3, -3)

    def test_runs_ahead_of_consumer(self):
        started = []

        def fn(x):
            started.append(x)
            return x

        p = Prefetcher(list(range(4)), fn, depth=2)
        it = iter(p)
        first = next(it)
        deadline = time.time() + 2.0
        while len(started) < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert first == (0, 0)
        assert len(started) >= 3, started  # items 1,2 prepared ahead
        p.close()

    def test_close_mid_iteration_joins_worker(self):
        p = Prefetcher(list(range(100)), lambda x: x, depth=2)
        it = iter(p)
        next(it)
        p.close()
        assert not any(t.is_alive() for t in p._pool._threads)

    def test_empty(self):
        assert list(Prefetcher([], lambda x: x)) == []

    def test_iterate_after_close_terminates(self):
        p = Prefetcher(list(range(50)), lambda x: x, depth=2)
        it = iter(p)
        next(it)
        p.close()
        assert list(it) == []

    def test_next_entry_hands_the_error_as_a_value(self):
        def fn(x):
            if x % 2:
                raise OSError(f"bad {x}")
            return x

        with Prefetcher(range(5), fn) as p:
            entries = list(iter(p.next_entry, None))
        assert [(i, r) for i, r, e in entries if e is None] == [(0, 0), (2, 2), (4, 4)]
        errors = [e for _, _, e in entries if e is not None]
        assert [e.item for e in errors] == [1, 3]
        assert all(isinstance(e, PrefetchError) and isinstance(e.cause, OSError)
                   for e in errors)

    def test_bounded_window_and_one_worker(self):
        """At most depth items are prepared ahead, one at a time."""
        lock, active, seen = threading.Lock(), [0], []

        def fn(x):
            with lock:
                active[0] += 1
                seen.append(active[0])
            time.sleep(0.002)
            with lock:
                active[0] -= 1
            return x

        with Prefetcher(range(30), fn, depth=3) as p:
            assert len(p._window) == 3
            assert [i for i, _ in p] == list(range(30))
        assert max(seen) == 1

    def test_depth_must_be_positive(self):
        with pytest.raises(ValueError):
            Prefetcher([1], lambda x: x, depth=0)


# -- the tiny server ---------------------------------------------------------


def _make_pages(folder, n=3, size=(120, 150)):
    """JAX's ``tests/test_serve.py`` pages."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        arr = np.full((size[1], size[0], 3), 240, np.uint8)
        arr[20:40, 10:110] = rng.integers(0, 90, (20, 100, 3), dtype=np.uint8)
        arr[60 + 10 * i : 90 + 10 * i, 30:100] = rng.integers(
            0, 90, (30, 70, 3), dtype=np.uint8
        )
        path = os.path.join(folder, f"serve_page_{i}.png")
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


TINY = ["--imgsz", "64", "--variant", "n", "--grid_configs", "", "--num_regions", "4",
        "--embedder_size", "tiny"]


def _tiny_args(input_folder, db_path, family, *extra, device=True):
    return ["--input_folder", input_folder, "--db_path", db_path, *TINY,
            "--embedder_family", family, *(["--device", "cpu"] if device else []), *extra]


def _tiny_server(input_folder, db_path, family="siglip", *extra):
    return tserve.FusedServer(
        tserve.build_parser().parse_args(_tiny_args(input_folder, db_path, family, *extra)))


def _store(server):
    return server.collection.get(include=("embeddings", "metadatas"))


@pytest.fixture(scope="module", params=["siglip", "mme5"])
def served(request, tmp_path_factory):
    """One pipelined run over 3 tiny pages and a corrupt one, a second run,
    and the sequential runs (``--no_prefetch`` and ``process_page``) into
    their own stores."""
    family = request.param
    root = tmp_path_factory.mktemp(f"serve_{family}")
    pages = _make_pages(str(root / "pages"))
    server = _tiny_server(str(root / "pages"), str(root / "db"), family)
    n_first, n_second = server.run_once(), server.run_once()
    stored = server.collection.count()
    # a page that does not decode: attempted, logged, skipped, left pending
    corrupt = str(root / "pages" / "corrupt_aa.png")
    with open(corrupt, "wb") as f:
        f.write(b"not a png")
    n_corrupt = server.run_once()
    seq = _tiny_server(str(root / "pages"), str(root / "db_seq"), family, "--no_prefetch")
    n_seq = seq.run_once()
    per_page = _tiny_server(str(root / "pages"), str(root / "db_pp"), family)
    for p in pages:
        per_page.process_page(p)
    return dict(server=server, pages=pages, corrupt=corrupt, stored=stored,
                n=(n_first, n_second, n_corrupt, n_seq), seq=seq, per_page=per_page)


def test_ingests_all_pages_and_skips_the_corrupt_one(served):
    server, pages = served["server"], served["pages"]
    # 3 pages, a no-op, the corrupt page alone, then all four in sequence
    assert served["n"] == (len(pages), 0, 1, len(pages) + 1)
    assert server.collection.count() == served["stored"]
    for p in pages:
        assert server.progress.is_completed(p)
    assert not server.progress.is_completed(served["corrupt"])
    got = server.collection.get(include=("metadatas",))
    page_ids = [i for i in got["ids"] if not i.startswith("region_")]
    assert sorted(page_ids) == sorted(os.path.basename(p) for p in pages)
    regions = [(i, m) for i, m in zip(got["ids"], got["metadatas"]) if i.startswith("region_")]
    assert regions, "random weights at 64 px keep boxes on these pages"
    for rid, meta in regions:
        assert meta["is_region"] is True and "box" in meta and "region_type" in meta


def test_second_run_is_noop(served):
    """Only the corrupt page stays pending."""
    assert served["server"].run_once() == 1
    assert served["seq"].run_once() == 1


@pytest.mark.parametrize("sequential", ["seq", "per_page"])
def test_pipelined_matches_sequential(served, sequential):
    """The 3-stage pipeline fills exactly the store the sequential paths
    fill (ids, embeddings bit for bit, region metadata)."""
    a, b = _store(served["server"]), _store(served[sequential])
    assert sorted(a["ids"]) == sorted(b["ids"])
    ea = dict(zip(a["ids"], a["embeddings"]))
    eb = dict(zip(b["ids"], b["embeddings"]))
    for rid in ea:
        assert ea[rid] == eb[rid], rid
    ma = {i: m for i, m in zip(a["ids"], a["metadatas"]) if i.startswith("region_")}
    mb = {i: m for i, m in zip(b["ids"], b["metadatas"]) if i.startswith("region_")}
    assert ma == mb


# JAX's refusals of a serving mesh (cli/serve.py:88-110), with its words,
# before any rank is spawned: a mesh larger than the devices (the CPU's
# cores for gloo ranks), --model_parallel with siglip, and with --quantize
REFUSALS = {
    "--data_parallel": (
        ["--data_parallel", "4096"],
        f"--data_parallel 4096 x --model_parallel 1 needs 4096 devices; only "
        f"{os.cpu_count()} visible"),
    "--model_parallel": (
        ["--model_parallel", "2"],
        "--model_parallel tensor-shards the parity (mme5) embedder; the siglip tower fits "
        "one chip — scale it with --data_parallel"),
    "--model_parallel --quantize": (
        ["--embedder_family", "mme5", "--model_parallel", "2", "--quantize"],
        "--model_parallel serves the bf16 tree; the int8 path is single-chip (drop "
        "--quantize, or use --data_parallel alone)"),
}


def _refused(tmp_path, case):
    flags, words = REFUSALS[case]
    with pytest.raises(SystemExit) as err:
        tserve.main(_tiny_args(str(tmp_path), str(tmp_path / "db"), "siglip", *flags))
    assert str(err.value) == words
    assert not os.path.exists(tmp_path / "db")  # refused before anything was built


@pytest.mark.parametrize("flag", ["--data_parallel", "--model_parallel"])
def test_parallel_serving_is_not_ported(tmp_path, flag):
    """The flags are ported; what JAX refuses is refused, in its words."""
    _refused(tmp_path, flag)


def test_model_parallel_refuses_quantize_as_jax(tmp_path):
    _refused(tmp_path, "--model_parallel --quantize")


def test_mesh_server_needs_its_world(tmp_path):
    """Built outside a world of dp·tp ranks, the server says how to start
    one (``main`` spawns them)."""
    with pytest.raises(RuntimeError, match="needs a world of 2 ranks"):
        _tiny_server(str(tmp_path), str(tmp_path / "db"), "siglip", "--data_parallel", "2")


# -- the scale-out CLI over gloo ranks ----------------------------------------
#
# JAX's tests/test_serve.py:176, :201, :227: --data_parallel 2 (siglip, mme5)
# and --data_parallel 2 --model_parallel 2 (mme5), each one ``main`` call
# that spawns its ranks, on 3 pages (the last group padded), against the
# port's single-device run at the same flags: ids, region metadata and the
# progress file EQUAL, embeddings within JAX's tolerances (3e-5; under
# tensor parallelism the bf16 partial sums are rounded apart: cosine ≥ 0.999
# and 5e-3). The siglip run takes ``both_clis``' .npz weights, so its
# single-device run is ``both_clis``' port run, and it is also held to the
# JAX CLI's store on them (JAX's test holds its dp store to its
# single-device one).

SCALEOUT = {
    "siglip dp2": ("siglip", ["--data_parallel", "2"], 3e-5),
    "mme5 dp2": ("mme5", ["--data_parallel", "2"], 3e-5),
    "mme5 dp2 tp2": ("mme5", ["--data_parallel", "2", "--model_parallel", "2"], 5e-3),
}


def _served(db):
    with open(os.path.join(db, "serve_progress.json")) as f:
        progress = f.read()
    return dict(store=_open("torch", db).get(include=("embeddings", "metadatas")),
                progress=progress)


@pytest.fixture(scope="module")
def scaleout(tmp_path_factory, both_clis):
    root = tmp_path_factory.mktemp("serve_scaleout")
    pages = str(both_clis["root"] / "pages")
    out = {"siglip dp2": {"single": both_clis["torch"]}}
    db = str(root / "db_siglip_dp2")
    assert tserve.main(_tiny_args(pages, db, "siglip", *both_clis["weights"],
                                  *SCALEOUT["siglip dp2"][1])) == 0
    out["siglip dp2"]["mesh"] = _served(db)
    db = str(root / "db_mme5_single")
    assert tserve.main(_tiny_args(pages, db, "mme5")) == 0
    single = _served(db)
    for name in ("mme5 dp2", "mme5 dp2 tp2"):
        db = str(root / f"db_{name.replace(' ', '_')}")
        assert tserve.main(_tiny_args(pages, db, "mme5", *SCALEOUT[name][1])) == 0
        out[name] = {"mesh": _served(db), "single": single}
    return out


@pytest.mark.parametrize("name", sorted(SCALEOUT))
def test_scaleout_cli_equals_single_device(scaleout, name):
    a, b = scaleout[name]["mesh"], scaleout[name]["single"]
    atol = SCALEOUT[name][2]
    assert a["progress"] == b["progress"]
    assert sorted(a["store"]["ids"]) == sorted(b["store"]["ids"]) and a["store"]["ids"]
    ea = dict(zip(a["store"]["ids"], a["store"]["embeddings"]))
    eb = dict(zip(b["store"]["ids"], b["store"]["embeddings"]))
    for rid in ea:
        va, vb = np.asarray(ea[rid]), np.asarray(eb[rid])
        assert float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))) >= PAGE_COS_MIN, rid
        np.testing.assert_allclose(va, vb, atol=atol, rtol=0)
    ma = {i: m for i, m in zip(a["store"]["ids"], a["store"]["metadatas"])
          if i.startswith("region_")}
    mb = {i: m for i, m in zip(b["store"]["ids"], b["store"]["metadatas"])
          if i.startswith("region_")}
    assert ma == mb and ma


def test_cli_refuses_the_card_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = _tiny_args(str(tmp_path), str(tmp_path / "db"), "siglip", device=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(args)


def test_flags_are_jax_flags_and_device():
    ours = {a.dest: a.default for a in tserve.build_parser()._actions}
    theirs = {a.dest: a.default for a in jserve.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device"} and ours.pop("device") == "cuda"
    assert ours == theirs


# -- the port's CLI against JAX's on the same .npz weights -------------------

# Both CLIs compute in bf16 (the detector and the tiny siglip tower), each
# framework rounding its own ops: the whole-page embeddings are unit vectors
# held at cosine >= 0.999 (BASELINE.json's parity target) and 2e-2 absolute.
PAGE_COS_MIN, PAGE_ATOL = 0.999, 2e-2


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory):
    from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
    from multimodal_embeddings_tpu.config import EmbedderConfig as JEmbedderConfig
    from multimodal_embeddings_tpu.models.detector import LayoutDetector as JDetector
    from multimodal_embeddings_tpu.models.embedder import MultimodalEmbedder as JEmbedder
    from multimodal_embeddings_tpu.models.vision_encoder import DualEncoderConfig as JDual
    from multimodal_embeddings_tpu.models.weights import save_checkpoint

    root = tmp_path_factory.mktemp("serve_clis")
    _make_pages(str(root / "pages"))
    det = JDetector(JDetectorConfig(image_size=64, variant="n", grid_configs=()), seed=3)
    emb = JEmbedder(JEmbedderConfig(family="siglip"), model_config=JDual.tiny(), seed=4)
    save_checkpoint(det.variables, str(root / "det.npz"))
    save_checkpoint(emb.variables, str(root / "emb.npz"))
    weights = ["--detector_weights", str(root / "det.npz"),
               "--embedder_weights", str(root / "emb.npz")]
    out = {}
    init = jembedder.deterministic_init_multi
    with pytest.MonkeyPatch.context() as mp:
        # the JAX engine's load target keeps the text tower's boxed
        # (LogicallyPartitioned) leaves, which an .npz never matches: it is
        # handed its init unboxed (as test_torch_embedder.py does)
        mp.setattr(jembedder, "deterministic_init_multi",
                   lambda model, args, seed=0: unbox(init(model, args, seed=seed)))
        assert jserve.main(_tiny_args(str(root / "pages"), str(root / "db_jax"), "siglip",
                                      *weights, device=False)) == 0
    assert tserve.main(_tiny_args(str(root / "pages"), str(root / "db_torch"), "siglip",
                                  *weights)) == 0
    for name in ("jax", "torch"):
        db = str(root / f"db_{name}")
        with open(os.path.join(db, "serve_progress.json")) as f:
            progress = f.read()
        store = _open(name, db).get(include=("embeddings", "metadatas"))
        out[name] = dict(store=store, progress=progress)
    out.update(root=root, weights=weights)
    return out


def _open(name, db):
    if name == "jax":
        from multimodal_embeddings_tpu.store.embedding_store import initialize_db

        return initialize_db(db)[1]
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

    return initialize_db(db, device="cpu")[1]


def test_cli_ids_and_progress_equal_jax(both_clis):
    j, t = both_clis["jax"], both_clis["torch"]
    assert t["progress"] == j["progress"]
    assert sorted(t["store"]["ids"]) == sorted(j["store"]["ids"])
    assert any(i.startswith("region_") for i in j["store"]["ids"])


def test_cli_metadata_schema_equal_jax(both_clis):
    def schema(store):
        out = {}
        for rid, meta in zip(store["ids"], store["metadatas"]):
            fixed = {k: v for k, v in meta.items()
                     if k in ("is_region", "image_name", "image_path", "parent_image",
                              "parent_image_name", "region_index")}
            out[rid] = (sorted(meta), {k: type(v).__name__ for k, v in meta.items()}, fixed)
        return out

    assert schema(both_clis["torch"]["store"]) == schema(both_clis["jax"]["store"])


def test_dp_cli_on_jax_weights_equals_jax_cli(both_clis, scaleout):
    """``--data_parallel 2`` on the .npz weights the JAX CLI served: the
    ids and progress file of the JAX CLI's store, page embeddings within
    the bf16 bounds above."""
    got = scaleout["siglip dp2"]["mesh"]
    want = both_clis["jax"]
    assert got["progress"] == want["progress"]
    assert sorted(got["store"]["ids"]) == sorted(want["store"]["ids"])
    eg = dict(zip(got["store"]["ids"], got["store"]["embeddings"]))
    ew = dict(zip(want["store"]["ids"], want["store"]["embeddings"]))
    for name in (i for i in ew if not i.startswith("region_")):
        va, vb = np.asarray(eg[name]), np.asarray(ew[name])
        assert float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb))) >= PAGE_COS_MIN, name
        np.testing.assert_allclose(va, vb, atol=PAGE_ATOL, rtol=0)


def test_cli_page_embeddings_close_to_jax(both_clis):
    def pages(store):
        return {i: np.asarray(e) for i, e in zip(store["ids"], store["embeddings"])
                if not i.startswith("region_")}

    got, want = pages(both_clis["torch"]["store"]), pages(both_clis["jax"]["store"])
    assert got.keys() == want.keys() and len(got) == 3
    for name in got:
        cos = float(got[name] @ want[name] / (np.linalg.norm(got[name]) *
                                              np.linalg.norm(want[name])))
        assert cos >= PAGE_COS_MIN, (name, cos)
        np.testing.assert_allclose(got[name], want[name], atol=PAGE_ATOL, rtol=0)
