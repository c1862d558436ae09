"""The numbered chain in the port — the cached runner, stage 1 and the seven
stage CLIs — against the JAX package, on the CPU.

* ``pipeline/runner.py``: the cases of ``tests/test_runner.py`` on the
  port's runner; its copies have the JAX sources; its cache file is its
  own, so a folder where the JAX chain ran is not "up to date" for it.
* The whole chain at the JAX e2e fixture's size (variant n, 128 px, grids
  ``2x2``, f32, ``device="cpu"``) through ``numbered_pipeline_stages`` and
  ``PipelineRunner``: the reference tree; a cached rerun skips all six
  stages and leaves every byte as it was; a changed threshold reruns only
  the stages it feeds.
* Stage 1 compared stage by stage (random weights tie their scores near
  0.5, so the regions of a random network are not compared): the bridged
  network's head maps on the page's views against JAX's within 1e-4; then
  both stage drivers fed the same seeded head maps, whose scores never tie,
  write the same tree (images byte-identical, the JSON equal up to f32
  rounding of boxes and scores); the prefetch and sequential drivers write
  byte-identical trees; a page that cannot be decoded is logged and counted
  as JAX counts it.
* Each CLI's ``main`` on the tiny tree; stages 2-5 byte-identical to JAX's
  CLIs; without ``--device cpu`` the CLIs of stages 0-1 and the chain raise
  "no CUDA device" here, and those of the host stages 2-5 take JAX's flags.
* ``s2d_stem``: JAX's detector with it and without it equals the port's,
  which has one stem, on the same bridged weights, within 1e-4 at f32.
"""

import dataclasses
import glob
import inspect
import json
import logging
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models import yolo_decode as jdec
from multimodal_embeddings_tpu.models.detector import LayoutDetector as JLayoutDetector
from multimodal_embeddings_tpu.models.weights import unflatten_params
from multimodal_embeddings_tpu.ops.image import letterbox_views_matmul as jletterbox_views
from multimodal_embeddings_tpu.pipeline import detect as jdetect
from multimodal_embeddings_tpu.pipeline import runner as jrunner
from multimodal_embeddings_tpu.utils import profiling as jprofiling
from multimodal_embeddings_tpu_torch.cli import columns as cli_columns
from multimodal_embeddings_tpu_torch.cli import combine as cli_combine
from multimodal_embeddings_tpu_torch.cli import detect as cli_detect
from multimodal_embeddings_tpu_torch.cli import edge_filter as cli_edge_filter
from multimodal_embeddings_tpu_torch.cli import medians as cli_medians
from multimodal_embeddings_tpu_torch.cli import orientation as cli_orientation
from multimodal_embeddings_tpu_torch.cli import pipeline as cli_pipeline
from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.models import yolo_decode as tdec
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params
from multimodal_embeddings_tpu_torch.pipeline import detect as tdetect
from multimodal_embeddings_tpu_torch.pipeline import runner as trunner
from multimodal_embeddings_tpu_torch.pipeline.runner import (
    PipelineRunner,
    Stage,
    fingerprint,
    folder_fingerprint,
    numbered_pipeline_stages,
)
from multimodal_embeddings_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(2)

DET = dict(image_size=128, variant="n", grid_configs=((2, 2),), max_detections=16)

COPIES = [
    (jrunner, trunner, "fingerprint"), (jrunner, trunner, "Stage"),
    (jrunner.PipelineRunner, trunner.PipelineRunner, "_save"),
    (jrunner.PipelineRunner, trunner.PipelineRunner, "run"),
    (jprofiling.StageTimer, tprofiling.StageTimer, "summary"),
    (jprofiling.StageTimer, tprofiling.StageTimer, "log_summary"),
]


@pytest.mark.parametrize("jmod,tmod,name", COPIES,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}" for _, t, n in COPIES])
def test_host_copy_has_the_jax_source(jmod, tmod, name):
    assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(getattr(jmod, name))


def test_stage_timer_equals_jax():
    """Same totals, counts and order; a block that raises is timed too."""
    timers = (jprofiling.StageTimer(), tprofiling.StageTimer())
    for timer in timers:
        with timer.stage("a", items=3):
            pass
        with timer.stage("b"):
            pass
        with pytest.raises(ValueError):
            with timer.stage("a", items=2):
                raise ValueError("x")
    (jt, tt) = timers
    assert tt.counts == jt.counts == {"a": 5, "b": 1}
    assert tt._order == jt._order == ["a", "b"]
    assert tt.summary().splitlines()[0] == jt.summary().splitlines()[0]


# -- the runner: the cases of tests/test_runner.py ---------------------------


def make_stage(name, workdir, calls, inputs, config=None):
    out_dir = os.path.join(workdir, f"out_{name}")

    def run():
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "result.txt"), "w") as f:
            f.write(f"{name} ran {len(calls)}")
        calls.append(name)

    return Stage(name, run, inputs=inputs, outputs=[out_dir], config=config or {})


def _inputs(tmp_path, text="data"):
    in_dir = os.path.join(str(tmp_path), "inputs")
    os.makedirs(in_dir, exist_ok=True)
    with open(os.path.join(in_dir, "page.txt"), "w") as f:
        f.write(text)
    return in_dir


def test_fingerprints_equal_jax(tmp_path):
    d = tmp_path / "data"
    d.mkdir()
    (d / "a.txt").write_text("one")
    (d / "sub").mkdir()
    (d / "sub" / "b.txt").write_text("two")
    assert folder_fingerprint(str(d)) == jrunner.folder_fingerprint(str(d))
    assert len(folder_fingerprint(str(d))) == 2
    assert folder_fingerprint(str(tmp_path / "missing")) == []
    assert fingerprint([str(d)], {"x": 1}) == jrunner.fingerprint([str(d)], {"x": 1})
    fp1 = folder_fingerprint(str(d))
    time.sleep(0.01)
    (d / "a.txt").write_text("two!")
    assert folder_fingerprint(str(d)) != fp1
    assert fingerprint([str(d)], {"x": 1}) != fingerprint([str(d)], {"x": 2})


def test_runner_skips_on_second_run(tmp_path):
    in_dir, calls = _inputs(tmp_path), []
    cache = str(tmp_path / "cache.json")
    stages = [make_stage("s1", str(tmp_path), calls, [in_dir])]
    assert PipelineRunner(cache_path=cache).run(stages) == {"s1": "ran"}
    assert PipelineRunner(cache_path=cache).run(stages) == {"s1": "skipped"}
    assert PipelineRunner(cache_path=cache).run(stages, force=True) == {"s1": "ran"}
    assert calls == ["s1", "s1"]


def test_runner_reruns_on_input_config_or_output_change(tmp_path):
    in_dir, calls = _inputs(tmp_path), []
    cache = str(tmp_path / "cache.json")
    stage = make_stage("s1", str(tmp_path), calls, [in_dir], {"thr": 10})
    PipelineRunner(cache_path=cache).run([stage])
    time.sleep(0.01)
    _inputs(tmp_path, "changed")
    assert PipelineRunner(cache_path=cache).run([stage]) == {"s1": "ran"}
    stage11 = make_stage("s1", str(tmp_path), calls, [in_dir], {"thr": 11})
    assert PipelineRunner(cache_path=cache).run([stage11]) == {"s1": "ran"}
    shutil.rmtree(stage11.outputs[0])
    assert PipelineRunner(cache_path=cache).run([stage11]) == {"s1": "ran"}
    assert len(calls) == 4


def test_runner_cascades(tmp_path):
    in_dir, calls = _inputs(tmp_path, "v1"), []
    cache = str(tmp_path / "cache.json")

    def stages():
        s1 = make_stage("s1", str(tmp_path), calls, [in_dir])
        return [s1, make_stage("s2", str(tmp_path), calls, [s1.outputs[0]])]

    PipelineRunner(cache_path=cache).run(stages())
    PipelineRunner(cache_path=cache).run(stages())
    assert calls == ["s1", "s2"]
    time.sleep(0.01)
    _inputs(tmp_path, "v2")
    PipelineRunner(cache_path=cache).run(stages())
    assert calls == ["s1", "s2", "s1", "s2"]


def test_runner_cache_is_its_own(tmp_path, monkeypatch):
    """The JAX chain's cache in the same folder does not make a port stage
    "up to date"; an unreadable cache reads as empty, as in JAX."""
    monkeypatch.chdir(tmp_path)
    in_dir, calls = _inputs(tmp_path), []
    stages = [make_stage("s1", str(tmp_path), calls, [in_dir])]
    assert jrunner.PipelineRunner().run(stages) == {"s1": "ran"}
    assert os.path.exists(".mmtpu_pipeline_cache.json")
    assert trunner.CACHE_FILE != ".mmtpu_pipeline_cache.json"
    assert PipelineRunner().run(stages) == {"s1": "ran"}
    assert PipelineRunner().run(stages) == {"s1": "skipped"}
    with open(trunner.CACHE_FILE, "w") as f:
        f.write("{broken")
    assert PipelineRunner()._cache == {} == jrunner.PipelineRunner(trunner.CACHE_FILE)._cache


# -- the whole chain at the e2e fixture's size --------------------------------


def make_page(path, seed, size=(160, 192)):
    """Text-like synthetic page (the JAX e2e test's generator)."""
    rng = np.random.default_rng(seed)
    w, h = size
    arr = np.full((h, w, 3), 245, np.uint8)
    for r in range(6):
        y = 10 + r * 28
        arr[y : y + 12, 12 : w - 12] = rng.integers(0, 80, (12, w - 24, 3), dtype=np.uint8)
    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def tiny_detector():
    return LayoutDetector(DetectorConfig(**DET), dtype=torch.float32, device="cpu")


def _json_tree(root="."):
    out = {}
    for folder in ("1_doclayout_parsed", "2_edge_box_filtered", "3_combined_bboxes",
                   "4_medians_extracted", "5_column_detection"):
        for path in glob.glob(os.path.join(root, folder, "**", "*.json"), recursive=True):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _build_stages(detector, **overrides):
    kwargs = dict(detector_factory=lambda: detector, imgsz=128, variant="n",
                  grid_configs="2x2", device="cpu")
    kwargs.update(overrides)
    return numbered_pipeline_stages("newspaper_images", **kwargs)


def test_numbered_chain_cached_and_invalidated(tiny_detector, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("newspaper_images")
    for i in range(2):
        make_page(f"newspaper_images/page_{i}.png", seed=i)
    results = PipelineRunner().run(_build_stages(tiny_detector))
    assert all(v == "ran" for v in results.values()) and len(results) == 6
    assert sorted(os.listdir("0_oriented_images")) == ["page_0.png", "page_1.png"]
    for i in range(2):
        base = json.load(open(f"1_doclayout_parsed/json/page_{i}.json"))
        assert list(base) == ["image_path", "image_size", "parameters", "boxes", "classes",
                              "scores", "class_names"]
        grid = json.load(open(f"1_doclayout_parsed/json/page_{i}_grid_2x2.json"))
        assert list(grid) == ["original_image_path", "grid_config", "cells"]
        assert len(grid["cells"]) == 4
        assert len(glob.glob(f"1_doclayout_parsed/grid_2x2/images/page_{i}_row*_col*.png")) == 4
        filt = json.load(open(f"2_edge_box_filtered/json/page_{i}_grid_2x2.json"))
        assert list(filt)[:3] == ["original_image_path", "cells", "grid_config"]
    assert len(glob.glob("3_combined_bboxes/json/*_combined.json")) == 2
    assert len(glob.glob("4_medians_extracted/json/*_median_width.json")) == 2
    assert os.path.isdir("5_column_detection/json")

    before = _json_tree()
    results = PipelineRunner().run(_build_stages(tiny_detector))
    assert all(v == "skipped" for v in results.values()), results
    assert _json_tree() == before

    results = PipelineRunner().run(_build_stages(tiny_detector, min_confidence=0.4))
    assert results["columns"] == "ran"
    for name in ("orientation", "detect", "edge_filter", "combine", "medians"):
        assert results[name] == "skipped", (name, results)
    results = PipelineRunner().run(_build_stages(tiny_detector, iou_threshold=0.4))
    assert [k for k, v in results.items() if v == "ran"] == ["combine", "medians", "columns"]


def test_numbered_chain_reruns_on_a_new_device(tiny_detector, tmp_path, monkeypatch):
    """Stages 0 and 1 keep the device in their config: a chain that ran on
    one device reruns stages 0-5 on another. The "cuda" chain here runs the
    CPU chain's stage 0 and 1 bodies under the "cuda" configs."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("newspaper_images")
    make_page("newspaper_images/page_0.png", seed=0)
    cpu = _build_stages(tiny_detector)
    card = [dataclasses.replace(s, run=c.run) if s.name in ("orientation", "detect") else s
            for s, c in zip(_build_stages(tiny_detector, device="cuda"), cpu)]
    assert [s.config["device"] for s in card[:2]] == ["cuda", "cuda"]
    assert all("device" not in s.config for s in card[2:])
    assert set(PipelineRunner().run(cpu).values()) == {"ran"}
    assert set(PipelineRunner().run(cpu).values()) == {"skipped"}
    results = PipelineRunner().run(card)
    assert list(results.values()) == ["ran"] * 6, results
    assert set(PipelineRunner().run(card).values()) == {"skipped"}
    assert list(PipelineRunner().run(cpu).values()) == ["ran"] * 6


# -- stage 1, stage by stage -----------------------------------------------------

PAGE_HW = (400, 300)
MAX_DET = 64
HOST_KW = dict(image_size=128, variant="n", grid_configs=((2, 2),), max_detections=MAX_DET)


def _head_maps(num_views, seed=0, num_classes=10, size=128):
    """Per level (reg, cls) NHWC f32 maps whose best class logits are
    distinct multiples of 0.02 per view (no two scores within f32 reach of a
    tie), as in ``tests/test_torch_detect.py``."""
    rng = np.random.default_rng(seed)
    shapes = [(size // s, size // s) for s in jyolo.STRIDES]
    anchors = sum(h * w for h, w in shapes)
    best = np.stack([rng.permutation(anchors) * 0.02 + v * 0.004 - 3.0
                     for v in range(num_views)]).astype(np.float32)
    cls_all = best[..., None] - 5.0 - rng.uniform(0, 3, (num_views, anchors, num_classes))
    pick = rng.integers(0, num_classes, (num_views, anchors))
    np.put_along_axis(cls_all, pick[..., None], best[..., None], axis=-1)
    maps, start = [], 0
    for h, w in shapes:
        reg = rng.normal(scale=1.5, size=(num_views, h, w, 64)).astype(np.float32)
        cls = cls_all[:, start : start + h * w].reshape(num_views, h, w, num_classes)
        maps.append((reg, cls.astype(np.float32)))
        start += h * w
    return maps


def _seeded_detectors(seed=5):
    """The JAX engine (its ~15 s init skipped, its forward replaced) and the
    port's (its network replaced), both fed the same seeded head maps."""
    jdet = object.__new__(JLayoutDetector)
    jdet.config = JDetectorConfig(**HOST_KW)
    jdet.cache_dir, jdet.variables, jdet._views_programs = None, None, {}
    jdet._forward = lambda variables, images: jdec.decode_predictions(
        [(jnp.asarray(r), jnp.asarray(c)) for r, c in _head_maps(images.shape[0], seed)],
        max_det=MAX_DET)
    tdet = LayoutDetector(DetectorConfig(**HOST_KW), dtype=torch.float32, device="cpu")
    tdet.model = lambda x: [(torch.from_numpy(r), torch.from_numpy(c))
                            for r, c in _head_maps(x.shape[0], seed)]
    return jdet, tdet


def _files(root):
    out = {}
    for path in glob.glob(os.path.join(root, "**", "*"), recursive=True):
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            _assert_json_close(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, list) and want and isinstance(want[0], (list, float)) and (
            path.endswith(("boxes", "boxes_original", "scores"))):
        atol = 3e-7 if path.endswith("scores") else 1e-3
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=path)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_json_close(g, w, f"{path}/{i}")
    else:
        assert got == want, path


def _pages(folder, n=2):
    os.makedirs(folder)
    rng = np.random.default_rng(14)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (*PAGE_HW, 3), dtype=np.uint8)).save(
            os.path.join(folder, f"page_{i}.png"))


def test_detect_stage_writes_the_jax_tree_on_identical_maps(tmp_path, monkeypatch):
    jdet, tdet = _seeded_detectors()
    monkeypatch.chdir(tmp_path)
    _pages("pages")
    (tmp_path / "pages" / "page_9.png").write_bytes(b"not a png")
    logger, lines = logging.getLogger("mmtpu"), {}
    for name, mod, det in (("jax", jdetect, jdet), ("torch", tdetect, tdet)):
        records = []
        handler = logging.Handler()
        handler.emit = lambda r, records=records: records.append(
            (r.levelname, r.getMessage().split(":")[0])) if r.name == "mmtpu.detect" else None
        logger.addHandler(handler)
        stats = mod.run_detect_stage("pages", f"out_{name}", detector=det)
        logger.removeHandler(handler)
        assert (stats.processed, stats.errors, stats.skipped) == (2, 1, 0)
        lines[name] = records
    assert lines["torch"] == lines["jax"]
    jtree = {k: v for k, v in _files("out_jax").items()}
    ttree = {k: v for k, v in _files("out_torch").items()}
    assert sorted(ttree) == sorted(jtree)
    assert len([n for n in jtree if n.startswith("grid_2x2/images/")]) == 8
    for name in jtree:
        if name.endswith(".json"):
            got = json.loads(ttree[name].decode().replace("out_torch", "OUT"))
            want = json.loads(jtree[name].decode().replace("out_jax", "OUT"))
            _assert_json_close(got, want, name)
            assert len(want.get("boxes", [None])) > 0
        else:
            assert ttree[name] == jtree[name], name


def test_detect_stage_raises_without_skip_errors(tmp_path, monkeypatch):
    _, tdet = _seeded_detectors()
    monkeypatch.chdir(tmp_path)
    os.makedirs("pages")
    (tmp_path / "pages" / "page_0.png").write_bytes(b"not a png")
    for prefetch in (True, False):
        with pytest.raises(Exception, match="cannot identify image file"):
            tdetect.run_detect_stage("pages", "out", detector=tdet, skip_errors=False,
                                     prefetch=prefetch)


def test_bridged_network_head_maps_equal_jax():
    """The first stage of the comparison: the bridged tiny network on the
    page's letterboxed views, against JAX's on JAX's views."""
    tdet = LayoutDetector(DetectorConfig(**HOST_KW), dtype=torch.float32, device="cpu", seed=3)
    flat = export_jax_params(tdet.model)
    page = np.random.default_rng(15).integers(0, 256, (*PAGE_HW, 3), dtype=np.uint8)
    _, bounds, _ = tdet._views_layout(*PAGE_HW)
    jviews, _ = jletterbox_views(jnp.asarray(page, jnp.float32), bounds, 128)
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        want = jax.jit(jmodel.apply)(unflatten_params(flat), jviews / 255.0)
    from multimodal_embeddings_tpu_torch.ops.image import letterbox_views_matmul

    tviews, _ = letterbox_views_matmul(torch.from_numpy(page).float(), bounds, 128)
    np.testing.assert_allclose(tviews.numpy(), np.asarray(jviews), atol=1e-3)
    with torch.no_grad():
        got = tdet.model(tviews / 255.0)
    for (greg, gcls), (wreg, wcls) in zip(got, want):
        np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)
    # and the post-processing of those maps matches decode_predictions'
    tdecoded = tdec.decode_predictions(got, max_det=MAX_DET)
    assert tuple(tdecoded.boxes.shape) == (5, MAX_DET, 4)


def test_detect_stage_prefetch_matches_sequential(tiny_detector, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("pages")
    for i in range(2):
        make_page(f"pages/page_{i}.png", seed=i)
    a = tdetect.run_detect_stage("pages", "out_pref", detector=tiny_detector)
    b = tdetect.run_detect_stage("pages", "out_seq", detector=tiny_detector, prefetch=False)
    assert a.processed == b.processed == 2 and a.errors == b.errors == 0
    ta = {k: v.replace(b"out_pref", b"OUT") for k, v in _files("out_pref").items()}
    tb = {k: v.replace(b"out_seq", b"OUT") for k, v in _files("out_seq").items()}
    assert ta.keys() == tb.keys() and len(ta) > 20
    for name in ta:
        assert ta[name] == tb[name], name


# -- the CLIs --------------------------------------------------------------------


def test_each_cli_main_on_the_tiny_tree(tmp_path, monkeypatch):
    from multimodal_embeddings_tpu.cli import columns as jcli_columns
    from multimodal_embeddings_tpu.cli import combine as jcli_combine
    from multimodal_embeddings_tpu.cli import edge_filter as jcli_edge_filter
    from multimodal_embeddings_tpu.cli import medians as jcli_medians

    monkeypatch.chdir(tmp_path)
    os.makedirs("pages")
    for i in range(2):
        make_page(f"pages/page_{i}.png", seed=i)
    cpu = ["--device", "cpu"]
    assert cli_orientation.main(["pages", "oriented", *cpu]) == 0
    assert cli_orientation.main(["empty_folder", "x", *cpu]) == 1
    assert cli_detect.main(["--input_folder", "oriented", "--output_folder", "s1",
                            "--imgsz", "128", "--variant", "n", "--grid_configs", "2x2",
                            "--no_viz", *cpu]) == 0
    assert len(glob.glob("s1/grid_2x2/images/*.png")) == 8
    assert not glob.glob("s1/**/*.jpg", recursive=True)
    trees = {}
    for name, mods in (("torch", (cli_edge_filter, cli_combine, cli_medians, cli_columns)),
                       ("jax", (jcli_edge_filter, jcli_combine, jcli_medians, jcli_columns))):
        edge, comb, med, col = mods
        os.makedirs(name)
        shutil.copytree("s1", f"{name}/s1")
        os.chdir(name)
        assert edge.main(["--input_folder", "s1", "--output_folder", "s2"]) == 0
        assert comb.main(["--input_folder", "s2", "--output_folder", "s3"]) == 0
        assert med.main(["--input_folder", "s3", "--output_folder", "s4"]) == 0
        assert col.main(["--input_folder", "s3", "--median_folder", "s4",
                         "--output_folder", "s5"]) == 0
        os.chdir(tmp_path)
        trees[name] = _files(name)
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    for name in trees["jax"]:
        assert trees["torch"][name] == trees["jax"][name], name
    os.makedirs("chain")
    shutil.copytree("pages", "chain/newspaper_images")
    os.chdir("chain")
    args = ["newspaper_images", "--imgsz", "128", "--variant", "n", "--grid_configs", "2x2"]
    assert cli_pipeline.main([*args, *cpu]) == 0
    assert cli_pipeline.main([*args, *cpu]) == 0  # cached
    assert os.path.exists(trunner.CACHE_FILE)
    assert len(glob.glob("3_combined_bboxes/json/*_combined.json")) == 2


@pytest.mark.parametrize("grid_str", [
    "2x2,3x3,4x4", " 2x3 , ,x, 2x, x3, 2x3x4, 2 x 3", "+2x-3, 1_0x2, 1__0x2, 2x_2",
    "ax2, 2.0x3, 2X2, 2x2x, 0x0", "\u0663x2, \t4x1\n", "",
])
def test_parse_grid_configs_equal_jax(grid_str):
    """The regular expression where JAX catches int's ValueError: the same
    grids kept and the same entries skipped."""
    from multimodal_embeddings_tpu.cli.detect import parse_grid_configs as jparse

    assert cli_detect.parse_grid_configs(grid_str) == jparse(grid_str)


@pytest.mark.parametrize("cli,argv", [
    (cli_orientation, ["in", "out"]),
    (cli_detect, ["--input_folder", "in", "--output_folder", "out"]),
    (cli_pipeline, ["in"]),
], ids=lambda v: getattr(v, "__name__", "").split(".")[-1] or None)
def test_cli_defaults_to_cuda(cli, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def _flags(parser):
    return parser.description, [
        (a.option_strings, a.dest, a.default, a.type, a.required, a.nargs, a.const, a.help)
        for a in parser._actions
    ]


@pytest.mark.parametrize("name", ["edge_filter", "combine", "medians", "columns"])
def test_host_cli_flags_equal_jax(name, tmp_path, monkeypatch):
    """Stages 2-5 run on the host: their CLIs take JAX's flags exactly, no
    ``--device``, and run where there is no CUDA device."""
    import importlib

    port = importlib.import_module(f"multimodal_embeddings_tpu_torch.cli.{name}")
    jax_cli = importlib.import_module(f"multimodal_embeddings_tpu.cli.{name}")
    assert _flags(port.build_parser()) == _flags(jax_cli.build_parser())
    with pytest.raises(SystemExit):
        port.build_parser().parse_args(["--input_folder", "in", "--output_folder", "out",
                                         "--median_folder", "m", "--device", "cpu"])
    monkeypatch.chdir(tmp_path)
    os.makedirs("in")
    argv = ["--input_folder", "in", "--output_folder", "out"]
    if name == "columns":
        argv += ["--median_folder", "m"]
    assert port.main(argv) == 0


# -- s2d_stem ------------------------------------------------------------------


def test_s2d_stem_detector_equals_plain_and_jax():
    """JAX's detector with ``s2d_stem=True`` and with ``False`` against the
    port's, which has one stem, on the same bridged weights."""
    images = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    cfg = DetectorConfig(image_size=64, variant="n")
    flat = export_jax_params(LayoutDetector(cfg, dtype=torch.float32, device="cpu", seed=4).model)
    port = LayoutDetector(cfg, dtype=torch.float32, device="cpu", params=flat)
    with torch.no_grad():
        got = port.model(torch.from_numpy(images))
    for s2d in (True, False):
        jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True, s2d_stem=s2d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
            want = jax.jit(jmodel.apply)(unflatten_params(flat), jnp.asarray(images))
        for (greg, gcls), (wreg, wcls) in zip(got, want):
            np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
            np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)
