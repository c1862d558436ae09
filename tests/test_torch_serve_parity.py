"""The serve-vs-exact parity tools and the last public names of the port,
against the JAX package on the CPU.

1. ``scripts/torch_serve_parity.py`` and ``scripts/torch_knife_edge_probe.py``:
   the matching helpers are JAX's (``iou_matrix``, ``match_sets``,
   ``unmatched_best_ious``: same source, same results on seeded boxes), and
   each twin's reduced run (``--device cpu``) prints the keys of JAX's
   ``SERVE_PARITY.json`` record.
2. The fused detect function's taps, at JAX's reduced parity config
   (variant n, 256 px, grids 2×2 and 3×3, 64 detections a view, an 800×600
   page, 24 regions) in f32. On identical seeded head maps with no score
   ties (``_head_maps``): ``decode_predictions(with_nms=False)`` and the
   ``return_candidates=True`` set EQUAL to JAX's in order and class, scores
   within 3e-7 (two sigmoids differ by up to 2 ulps below 1.0), boxes within
   1e-3 px on page coordinates up to 800; the ``resize_dtype=float32``
   views within 1e-5 of JAX's on [0, 1] (the same f32 products in another
   order) and its crops within 2/255 (their row blend is bf16, as in JAX).
   On bridged weights (the port's seeded detector exported to JAX), stage
   by stage on identical inputs as ``tests/test_torch_fused.py`` does: head
   maps on JAX's f32-resized views within 1e-4, and on JAX's head maps the
   pre-NMS detections and the candidate set by their sorted scores within
   2e-7 (random weights tie every score near 0.5, so which near-tied box
   wins may differ, but not the scores).
3. The host copies (``nms_indices_from_padded``, ``translate_boxes_np``,
   ``hf_token``, ``PipelineConfig``'s JSON, ``NUM_CLASSES``,
   ``IMAGE_EXTENSIONS``): JAX's source and results.
4. K1's ``sm_scale`` on every plain version against JAX's interpret-mode
   kernel at 1e-5 (``tests/test_torch_encoder_attention.py``'s tolerance),
   ``encoder_attention_padded``, and the scale through ``KernelAttention``'s
   backward.
"""

import dataclasses
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu import config as jconfig
from multimodal_embeddings_tpu.kernels import encoder_attention as jk1
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models import yolo_decode as jdec
from multimodal_embeddings_tpu.models.weights import unflatten_params
from multimodal_embeddings_tpu.ops import grid as jgrid
from multimodal_embeddings_tpu.ops import nms as jnms
from multimodal_embeddings_tpu.pipeline import fused as jfused
from multimodal_embeddings_tpu_torch import config as tconfig
from multimodal_embeddings_tpu_torch.io import images as timages
from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
from multimodal_embeddings_tpu_torch.models import yolo_decode as tdec
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params
from multimodal_embeddings_tpu_torch.ops import grid as tgrid
from multimodal_embeddings_tpu_torch.ops import nms as tnms
from multimodal_embeddings_tpu_torch.pipeline import fused as tfused
from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"
# JAX's reduced parity config (scripts/serve_parity.py)
DET = dict(image_size=256, variant="n", grid_configs=((2, 2), (3, 3)), max_detections=64)
PAGE_HW, K, CROP = (800, 600), 24, 64
NUM_VIEWS = 14  # full page + 2x2 + 3x3
ATOL_K1 = 1e-5


def _script(name):
    """A script of ``scripts/`` as a module (its directory on the path, as
    the knife-edge probes import their parity script by name)."""
    if str(SCRIPTS) not in sys.path:
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return SimpleNamespace(
        jsp=_script("serve_parity"), tsp=_script("torch_serve_parity"),
        jke=_script("knife_edge_probe"), tke=_script("torch_knife_edge_probe"))


# --- 1. the twins -------------------------------------------------------------


def _box_sets(seed):
    """Seeded (serve, exact) sets: the serve boxes jittered copies of some
    exact ones plus strays, three classes, so that matches, misses and
    class clashes all occur."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 500, (40, 2))
    eboxes = np.concatenate([xy, xy + rng.uniform(20, 120, (40, 2))], 1)
    escores = rng.uniform(0.1, 1.0, 40)
    eclasses = rng.integers(0, 3, 40)
    pick = rng.choice(40, 20, replace=False)
    sboxes = np.concatenate([eboxes[pick] + rng.normal(0, 8, (20, 4)),
                             rng.uniform(0, 600, (4, 4)).cumsum(1)])
    sscores = rng.uniform(0.1, 1.0, 24)
    sclasses = np.concatenate([eclasses[pick], rng.integers(0, 3, 4)])
    sclasses[:3] = (sclasses[:3] + 1) % 3
    return (sboxes, sscores, sclasses), (eboxes, escores, eclasses)


@pytest.mark.parametrize("name,jax_script,twin", [
    ("iou_matrix", "jsp", "tsp"), ("match_sets", "jsp", "tsp"),
    ("unmatched_best_ious", "jke", "tke")])
def test_matching_helpers_equal_jax(scripts, name, jax_script, twin):
    want_fn, got_fn = getattr(getattr(scripts, jax_script), name), getattr(getattr(scripts, twin), name)
    assert inspect.getsource(got_fn) == inspect.getsource(want_fn)
    for seed in range(4):
        serve, exact = _box_sets(seed)
        if name == "iou_matrix":
            np.testing.assert_array_equal(got_fn(serve[0], exact[0]), want_fn(serve[0], exact[0]))
            continue
        for floor in (0.3, 0.5):
            assert got_fn(serve, exact, iou_floor=floor) == want_fn(serve, exact, iou_floor=floor)


def _keys(record):
    """Every key path of a JSON record, lists read through their first item."""
    if isinstance(record, dict):
        return {k: _keys(v) for k, v in record.items()}
    if isinstance(record, list) and record and isinstance(record[0], dict):
        return [_keys(record[0])]
    return None


@pytest.mark.parametrize("twin,section", [("torch_serve_parity", None),
                                          ("torch_knife_edge_probe", "knife_edge")])
def test_twin_reduced_run_prints_the_jax_keys(tmp_path, twin, section):
    """One page of the reduced config on the CPU: the printed record (also
    written to ``--out``) has JAX's keys, its numbers lie in [0, 1], and
    ``SERVE_PARITY.json`` is left as it was."""
    record = REPO / "SERVE_PARITY.json"
    before = record.read_bytes()
    out = tmp_path / "out.json"
    proc = subprocess.run(
        [sys.executable, str(SCRIPTS / f"{twin}.py"), "--device", "cpu", "--pages", "1",
         "--out", str(out)], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == got
    assert record.read_bytes() == before
    jax_record = json.loads(before)
    if section:
        assert list(got) == [section]
        got, want = got[section], jax_record[section]
    else:
        want = {k: v for k, v in jax_record.items() if k not in ("knife_edge", "exact_steady")}
    assert _keys(got) == _keys(want)
    assert got["config"]["full"] is False and got["config"]["variant"] == "n"
    for key, value in got.items():
        if isinstance(value, dict) and "recall_topk" in value:
            for metric in ("precision", "recall_topk", "mean_matched_iou"):
                assert 0.0 <= value[metric] <= 1.0, (key, metric, value[metric])


# --- 2. the fused detect function's taps -----------------------------------------


def _head_maps(seed=0, num_classes=10, num_views=NUM_VIEWS):
    """Per level (reg, cls) NHWC f32 maps at 256 px. Each anchor's best class
    logit is a distinct multiple of 0.02 (offset per view), every other
    class ≥ 5 below it: no two scores within float32 reach of a tie."""
    rng = np.random.default_rng(seed)
    size = DET["image_size"]
    shapes = [(size // s, size // s) for s in jyolo.STRIDES]
    anchors = sum(h * w for h, w in shapes)
    best = np.stack([rng.permutation(anchors) * 0.02 + v * 0.0007 - 3.0
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


def _jax_maps(maps):
    return [(jnp.asarray(r), jnp.asarray(c)) for r, c in maps]


def _torch_maps(maps):
    return [(torch.from_numpy(np.asarray(r)), torch.from_numpy(np.asarray(c))) for r, c in maps]


class _Recorder:
    """A detector network that records its input and returns fixed maps
    (JAX's ``apply`` form and the port's call form)."""

    def __init__(self, maps):
        self.maps, self.seen = maps, []

    def apply(self, variables, images, train=False):
        self.seen.append(np.asarray(images.astype(jnp.float32)))
        return _jax_maps(self.maps)

    def __call__(self, images):
        self.seen.append(images.float().numpy())
        return _torch_maps(self.maps)


def _fixed_detectors(maps):
    jdet = SimpleNamespace(config=jconfig.DetectorConfig(**DET), model=_Recorder(maps))
    tdet = SimpleNamespace(config=tconfig.DetectorConfig(**DET), device=torch.device("cpu"),
                           model=_Recorder(maps))
    return jdet, tdet


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_without_nms_equals_jax(seed):
    maps = _head_maps(seed)
    want = jdec.decode_predictions(_jax_maps(maps), max_det=64, with_nms=False)
    got = tdec.decode_predictions(_torch_maps(maps), max_det=64, with_nms=False)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=3e-7)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4)
    # top-k order, and more valid rows than the NMS'd form keeps
    assert (np.diff(got.scores.numpy(), axis=1) <= 0).all()
    nms = tdec.decode_predictions(_torch_maps(maps), max_det=64)
    assert int(got.valid.sum()) > int(nms.valid.sum()) > 0


@pytest.mark.parametrize("letterbox", [True, False])
@pytest.mark.parametrize("cap", [4, 0])
def test_return_candidates_equal_jax(letterbox, cap):
    """The candidate set on tie-free maps: the same boxes in the same order,
    and exactly the set the port's own cross-view NMS selects from."""
    maps = _head_maps(2)
    jdet, tdet = _fixed_detectors(maps)
    page = make_page(*PAGE_HW, seed=0)
    opts = dict(letterbox=letterbox, candidate_cap=cap)
    want = jfused._make_detect_crop(jdet, PAGE_HW, K, CROP, return_candidates=True, **opts)(
        None, jnp.asarray(page))
    fn = tfused.build_fused_detect_fn(tdet, PAGE_HW, K, CROP, return_candidates=True, **opts)
    got = fn(torch.from_numpy(page))
    boxes, scores, classes = (np.asarray(w) for w in want)
    assert len(got) == 3 and scores.shape == (NUM_VIEWS * 64 if cap == 0 else cap * K,)
    np.testing.assert_array_equal(got[2].numpy(), classes)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=3e-7)
    np.testing.assert_allclose(got[0].numpy(), boxes, atol=1e-3)
    # the device NMS on the tap gives the plain call's regions
    keep, order = tnms.nms_padded(got[0], got[1], got[2], got[1] > 0, iou_threshold=0.5,
                                  class_aware=True)
    top, sel = tdec.top_k(torch.where(keep, got[1][order], -1.0), K)
    plain = tfused.build_fused_detect_fn(tdet, PAGE_HW, K, CROP, **opts)(torch.from_numpy(page))
    np.testing.assert_array_equal(got[0][order[sel]].numpy(), plain[0].numpy())
    np.testing.assert_array_equal(top.numpy(), plain[1].numpy())
    assert fn.batch(torch.from_numpy(page)[None])[0].shape == (1, *got[0].shape)


def test_f32_resize_equals_jax():
    """``resize_dtype=float32``: the views the detector sees (bf16 for the
    detector, as in JAX) and the crops, on tie-free maps."""
    maps = _head_maps(3)
    jdet, tdet = _fixed_detectors(maps)
    page = make_page(*PAGE_HW, seed=1)
    for letterbox in (True, False):
        jdet.model.seen.clear(), tdet.model.seen.clear()
        want = jfused._make_detect_crop(jdet, PAGE_HW, K, CROP, letterbox=letterbox,
                                        resize_dtype=jnp.float32)(None, jnp.asarray(page))
        got = tfused.build_fused_detect_fn(tdet, PAGE_HW, K, CROP, letterbox=letterbox,
                                           resize_dtype=torch.float32)(torch.from_numpy(page))
        np.testing.assert_allclose(tdet.model.seen[0], jdet.model.seen[0], atol=1e-5)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3)
        np.testing.assert_allclose(got[4].float().numpy(), np.asarray(want[4]), atol=2 / 255)


@pytest.fixture(scope="module")
def bridged():
    """The port's seeded reduced-config detector and its JAX twin on the
    same parameters; JAX's f32-resized letterbox views of one page and its
    head maps on them."""
    tdet = LayoutDetector(tconfig.DetectorConfig(**DET), dtype=torch.float32, device="cpu")
    flat = export_jax_params(tdet.model)
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True)
    jvars = unflatten_params(flat)
    seen = []

    class Net:
        @staticmethod
        def apply(variables, images, train=False):
            seen.append(np.asarray(images.astype(jnp.float32)))
            return jmodel.apply(variables, images, train=train)

    jdet = SimpleNamespace(config=jconfig.DetectorConfig(**DET), model=Net)
    page = make_page(*PAGE_HW, seed=2)
    jcands = jfused._make_detect_crop(jdet, PAGE_HW, K, CROP, letterbox=True,
                                      resize_dtype=jnp.float32, return_candidates=True)(
        jvars, jnp.asarray(page))
    views = seen[0].copy()
    jmaps = [(np.asarray(r), np.asarray(c)) for r, c in jmodel.apply(jvars, jnp.asarray(views))]
    return SimpleNamespace(tdet=tdet, page=page, views=views, jmaps=jmaps,
                           jcands=[np.asarray(x) for x in jcands])


def test_bridged_head_maps_on_jax_f32_views(bridged):
    """Tolerance 1e-4 on head logits (the detector test's bound)."""
    with torch.no_grad():
        got = bridged.tdet.model(torch.from_numpy(bridged.views))
    assert bridged.views.shape == (NUM_VIEWS, 256, 256, 3)
    for (greg, gcls), (wreg, wcls) in zip(got, bridged.jmaps):
        np.testing.assert_allclose(greg.numpy(), wreg, atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), wcls, atol=1e-4)


def test_bridged_decode_without_nms_on_jax_maps(bridged):
    want = jdec.decode_predictions(_jax_maps(bridged.jmaps), max_det=64, with_nms=False)
    got = tdec.decode_predictions(_torch_maps(bridged.jmaps), max_det=64, with_nms=False)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(np.sort(got.scores.numpy(), axis=1),
                               np.sort(np.asarray(want.scores), axis=1), rtol=0, atol=2e-7)


def test_bridged_candidates_on_jax_maps(bridged):
    """The port's candidate tap at ``resize_dtype=float32`` fed JAX's head
    maps of the same page: the scores of JAX's candidate set."""
    tdet = SimpleNamespace(config=bridged.tdet.config, device=torch.device("cpu"),
                           model=_Recorder(bridged.jmaps))
    got = tfused.build_fused_detect_fn(tdet, PAGE_HW, K, CROP, letterbox=True,
                                       resize_dtype=torch.float32, return_candidates=True)(
        torch.from_numpy(bridged.page))
    np.testing.assert_allclose(tdet.model.seen[0], bridged.views, atol=1e-5)
    want_scores = bridged.jcands[1]
    assert got[1].shape == want_scores.shape == (4 * K,)
    np.testing.assert_allclose(np.sort(got[1].numpy()), np.sort(want_scores), rtol=0, atol=2e-7)


# --- 3. the host copies ---------------------------------------------------------


@pytest.mark.parametrize("tmod,jmod,name", [
    (tnms, jnms, "nms_indices_from_padded"), (tgrid, jgrid, "translate_boxes_np"),
    (tconfig, jconfig, "hf_token"), (tconfig, jconfig, "_dataclass_from_dict"),
    (tconfig, jconfig, "PipelineConfig")])
def test_host_copies_are_jax_source(tmod, jmod, name):
    assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(getattr(jmod, name))


def test_nms_indices_and_translation_equal_jax():
    rng = np.random.default_rng(0)
    for n in (1, 7, 40):
        keep, order = rng.uniform(size=n) < 0.5, rng.permutation(n)
        np.testing.assert_array_equal(tnms.nms_indices_from_padded(keep, order),
                                      jnms.nms_indices_from_padded(keep, order))
    kept = tnms.nms_indices_from_padded(torch.tensor([True, False, True]),
                                        torch.tensor([2, 0, 1]))
    np.testing.assert_array_equal(kept, [2, 1])
    boxes, origins = rng.uniform(0, 900, (3, 5, 6, 4)), rng.uniform(0, 900, (3, 5, 2))
    np.testing.assert_array_equal(tgrid.translate_boxes_np(boxes, origins),
                                  jgrid.translate_boxes_np(boxes, origins))


def test_constants_equal_jax():
    assert tconfig.NUM_CLASSES == jconfig.NUM_CLASSES == 10
    assert tconfig.IMAGE_EXTENSIONS == jconfig.IMAGE_EXTENSIONS
    assert timages.IMAGE_EXTENSIONS is tconfig.IMAGE_EXTENSIONS


def test_hf_token_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HF_TOKEN", raising=False)
    assert tconfig.hf_token() is None and jconfig.hf_token() is None
    (tmp_path / "HF_TOKEN.txt").write_text("  from-file\n")
    assert tconfig.hf_token() == jconfig.hf_token() == "from-file"
    monkeypatch.setenv("HF_TOKEN", "from-env")
    assert tconfig.hf_token() == jconfig.hf_token() == "from-env"


def _changed(cls):
    """A non-default ``PipelineConfig`` built alike in either package."""
    return cls(detector=cls.__dataclass_fields__["detector"].default_factory(
        image_size=640, grid_configs=((2, 3),)), bit_exact_json=False)


def test_pipeline_config_json_equals_jax(tmp_path):
    """``to_json``: JAX's document with ``detector.s2d_stem``, which the port
    leaves out (``tests/test_torch_config.py::LEFT_OUT``), taken away.
    ``from_json`` of JAX's file: JAX's values field by field (tuples come
    back as lists in both, so neither load is ``==`` to its source; that is
    JAX's round trip, copied)."""
    for make in (lambda cls: cls(), _changed):
        tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
        make(tconfig.PipelineConfig).to_json(str(tpath))
        make(jconfig.PipelineConfig).to_json(str(jpath))
        want = json.loads(jpath.read_text())
        assert want["detector"].pop("s2d_stem") is False
        assert json.loads(tpath.read_text()) == want
        got = tconfig.PipelineConfig.from_json(str(jpath))
        ref = jconfig.PipelineConfig.from_json(str(jpath))
        for field in dataclasses.fields(got):
            sub, jsub = getattr(got, field.name), getattr(ref, field.name)
            if not dataclasses.is_dataclass(sub):
                assert sub == jsub, field.name
                continue
            for f in dataclasses.fields(sub):
                assert getattr(sub, f.name) == getattr(jsub, f.name), (field.name, f.name)
        assert isinstance(got.detector.grid_configs, list)
        assert got != make(tconfig.PipelineConfig) and ref != make(jconfig.PipelineConfig)


# --- 4. K1's sm_scale -----------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread beside XLA's interpret mode, as in
    ``tests/test_torch_encoder_attention.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("scale", [0.3, 0.05])
def test_blf_sm_scale_equals_jax(one_thread, scale):
    q, k, v = (_randn(s, (2, 64, 96)) for s in (1, 2, 3))
    want = np.asarray(jk1.encoder_attention_blf(*map(jnp.asarray, (q, k, v)), heads=3,
                                                sm_scale=scale, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (k1.encoder_attention_blf_reference(tq, tk, tv, 3, sm_scale=scale),
                k1.encoder_attention_blf(tq, tk, tv, 3, sm_scale=scale)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_K1)
    default = k1.encoder_attention_blf(tq, tk, tv, 3)
    assert not np.allclose(default.numpy(), want, atol=ATOL_K1)


@pytest.mark.parametrize("scale", [0.3, 0.05])
def test_blf_packed_sm_scale_equals_jax(one_thread, scale):
    qkv = _randn(4, (2, 64, 4 * 144))
    want = np.asarray(jk1.encoder_attention_blf_packed(
        jnp.asarray(qkv), heads=4, key_dim=36, head_dim=72, sm_scale=scale, interpret=True))
    t = torch.from_numpy(qkv)
    for got in (k1.encoder_attention_blf_packed_reference(t, 4, 36, 72, sm_scale=scale),
                k1.encoder_attention_blf_packed(t, 4, 36, 72, sm_scale=scale)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_K1)


@pytest.mark.parametrize("valid_len", [None, 50])
@pytest.mark.parametrize("bhld", [False, True])
def test_encoder_attention_sm_scale_equals_jax(one_thread, valid_len, bhld):
    q, k, v = (_randn(s, (2, 64, 3, 16)) for s in (5, 6, 7))
    if bhld:
        q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    want = np.asarray(jk1.encoder_attention(*map(jnp.asarray, (q, k, v)), sm_scale=0.2,
                                            valid_len=valid_len, bhld_inputs=bhld,
                                            interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (k1.encoder_attention_reference(tq, tk, tv, valid_len, bhld, sm_scale=0.2),
                k1.encoder_attention(tq, tk, tv, valid_len=valid_len, bhld_inputs=bhld,
                                     sm_scale=0.2)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL_K1)


@pytest.mark.parametrize("l,valid_len", [(44, 40), (64, 64)])
def test_encoder_attention_padded_equals_jax(one_thread, l, valid_len):
    """JAX pads L to 16 and slices the rows back; the port's kernel takes any
    L and pads nothing."""
    q, k, v = (_randn(s, (2, l, 3, 16)) for s in (8, 9, 10))
    want = np.asarray(jk1.encoder_attention_padded(*map(jnp.asarray, (q, k, v)), valid_len,
                                                   interpret=True))
    before = k1.encoder_attention.launches
    got = k1.encoder_attention_padded(*map(torch.from_numpy, (q, k, v)), valid_len)
    assert got.shape == (2, l, 3, 16) and k1.encoder_attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_K1)


@pytest.mark.parametrize("form", ["blf", "bhld"])
def test_kernel_attention_backward_takes_the_scale(form):
    """``KernelAttention`` at sm_scale 0.3 (its CPU forward is the plain
    version) against autograd of the plain version at that scale."""
    gen = torch.Generator().manual_seed(0)
    shape = (2, 32, 48) if form == "blf" else (2, 3, 32, 16)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64).float()
               .requires_grad_() for _ in range(3))
    if form == "blf":
        out = k1.KernelAttention.apply(q, k, v, "blf", 3, 0.3)
        ref = k1.encoder_attention_blf_reference(q, k, v, 3, sm_scale=0.3)
    else:
        out = k1.KernelAttention.apply(q, k, v, "bhld", 3, 0.3)
        ref = k1.encoder_attention_reference(q, k, v, bhld_inputs=True, sm_scale=0.3)
    do = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    torch.testing.assert_close(out, ref, atol=ATOL_K1, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL_K1, rtol=0)
