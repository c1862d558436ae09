"""Detector and detection post-processing: PyTorch port against JAX.

1. ``DocLayoutYOLO`` (variant n, GL-CRM, 64 px, f32): the raw head maps
   from the same weights and inputs.
2. ``decode_predictions`` → per-view NMS → page mapping (squeezed or
   letterboxed views) → ``internal_edge_mask`` → cross-view NMS → top-K
   selection → crops, fed identical seeded head maps whose class logits are
   well separated (no score ties within float32 reach): keep masks, orders
   and classes must be exactly equal; boxes and scores agree to float32
   rounding (scores within 3e-7: the two sigmoids differ by up to 2 ulps
   below 1.0).
3. The host API (``_letterbox_host``, ``detect_batch``, ``detect_regions``
   with its cache, ``detect_page_multigrid`` with the views letterboxed on
   the device or on the host) on the same head maps: the canvases the
   detector sees, and the regions dicts.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models import yolo_decode as jdec
from multimodal_embeddings_tpu.models.weights import unflatten_params
from multimodal_embeddings_tpu.pipeline import fused as jfused
from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.models import yolo as tyolo
from multimodal_embeddings_tpu_torch.models import yolo_decode as tdec
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params
from multimodal_embeddings_tpu_torch.pipeline import fused as tfused

torch.set_num_threads(2)


def randomize_norms(flat, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        if key.endswith(("/var", "/scale")):
            val = rng.uniform(0.5, 1.5, val.shape)
        elif key.endswith(("/mean", "/bias")):
            val = rng.normal(scale=0.2, size=val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


def test_doclayout_yolo_head_maps(monkeypatch):
    """64 px keeps the test short; the PSA still attends over its 2×2 map.
    Tolerance 1e-4 absolute on head logits of magnitude up to ~30 after
    ~70 f32 conv layers (measured differences up to 2e-5): BatchNorm folded
    into the weights, and a different summation order, per layer."""
    monkeypatch.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
    images = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    cfg = DetectorConfig(image_size=64, variant="n")
    # parameters in the JAX layout from the port's seeded init (JAX's own
    # init of this model costs ~15 s of eager tracing here)
    flat = randomize_norms(
        export_jax_params(LayoutDetector(cfg, dtype=torch.float32, device="cpu").model)
    )
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True)
    want = jax.jit(jmodel.apply)(unflatten_params(flat), jnp.asarray(images))
    det = LayoutDetector(cfg, dtype=torch.float32, device="cpu", params=flat)
    with torch.no_grad():
        got = det.model(torch.from_numpy(images))
    assert len(got) == len(want) == 3
    for (greg, gcls), (wreg, wcls) in zip(got, want):
        assert tuple(greg.shape) == wreg.shape and tuple(gcls.shape) == wcls.shape
        np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)


def test_scale_table_and_channels_match():
    assert tyolo.SCALES == {k: tyolo.YoloScale(**vars(v)) for k, v in jyolo.SCALES.items()}
    for variant, scale in tyolo.SCALES.items():
        for base in (64, 128, 256, 512, 1024):
            assert tyolo._ch(base, scale) == jyolo._ch(base, jyolo.SCALES[variant])
        for n in (3, 6):
            assert tyolo._depth(n, scale) == jyolo._depth(n, jyolo.SCALES[variant])


# --- post-processing on identical head maps --------------------------------

PAGE_HW = (400, 300)
DET_SIZE = 128
NUM_VIEWS = 5  # full page + 2x2
MAX_DET = 64


def _head_maps(seed=0, num_classes=10, num_views=NUM_VIEWS):
    """Per level (reg, cls) NHWC f32 maps. Each anchor's best class logit is
    a distinct multiple of 0.02 (offset per view), every other class sits
    ≥ 5 below it, so no two scores are within float32 reach of a tie."""
    rng = np.random.default_rng(seed)
    shapes = [(DET_SIZE // s, DET_SIZE // s) for s in jyolo.STRIDES]
    anchors = sum(h * w for h, w in shapes)
    maps = []
    best = np.stack([
        rng.permutation(anchors) * 0.02 + v * 0.004 - 3.0 for v in range(num_views)
    ]).astype(np.float32)
    cls_all = best[..., None] - 5.0 - rng.uniform(0, 3, (num_views, anchors, num_classes))
    pick = rng.integers(0, num_classes, (num_views, anchors))
    np.put_along_axis(cls_all, pick[..., None], best[..., None], axis=-1)
    start = 0
    for h, w in shapes:
        reg = rng.normal(scale=1.5, size=(num_views, h, w, 64)).astype(np.float32)
        cls = cls_all[:, start : start + h * w].reshape(num_views, h, w, num_classes)
        maps.append((reg, cls.astype(np.float32)))
        start += h * w
    return maps


def test_decode_predictions_identical_keep_and_order():
    maps = _head_maps()
    want = jdec.decode_predictions(
        [(jnp.asarray(r), jnp.asarray(c)) for r, c in maps], max_det=MAX_DET
    )
    got = tdec.decode_predictions(
        [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps], max_det=MAX_DET
    )
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=3e-7)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4)
    assert 0 < int(got.valid.sum()) < got.valid.numel()  # NMS removed some


def test_top_k_tie_order_matches_lax():
    x = np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0, -1.0, -1.0]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), 5)
    gv, gi = tdec.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_dfl_and_anchors():
    reg = np.random.default_rng(2).normal(size=(3, 7, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tdec.dfl_expectation(torch.from_numpy(reg)).numpy(),
        np.asarray(jdec.dfl_expectation(jnp.asarray(reg))), rtol=5e-7,
    )
    shapes = [(16, 16), (8, 8), (4, 4)]
    for a, b in zip(tdec._anchors_for(shapes), jdec._anchors_for(shapes)):
        np.testing.assert_array_equal(a, b)


class _FixedJaxModel:
    def __init__(self, maps):
        self.maps = [(jnp.asarray(r), jnp.asarray(c)) for r, c in maps]

    def apply(self, variables, images, train=False):
        assert images.shape == (NUM_VIEWS, DET_SIZE, DET_SIZE, 3)
        self.images = images
        return self.maps


@pytest.mark.parametrize("letterbox", [False, True])
@pytest.mark.parametrize("edge_filter", [True, False])
@pytest.mark.parametrize("candidate_cap", [4, 0])
def test_detect_crop_selection_identical(edge_filter, candidate_cap, letterbox):
    """The whole post-detector chain of the page program on identical head
    maps: page mapping (the squeeze's or the letterbox's per-view affine),
    edge filter, class-aware cross-view NMS, top-K, crops. Crops: tolerance
    two uint8 steps (2/255) — pixels ride in bf16 (8 significant bits: one
    step at values ≥ 128) and the two row-blend products may each round the
    other way."""
    maps = _head_maps(seed=1)
    kw = dict(image_size=DET_SIZE, variant="n", grid_configs=((2, 2),), max_detections=MAX_DET)
    jdet = SimpleNamespace(config=JDetectorConfig(**kw), model=_FixedJaxModel(maps))
    seen = []

    def tmodel(imgs):
        seen.append(imgs)
        return [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps]

    tdet = SimpleNamespace(config=DetectorConfig(**kw), device=torch.device("cpu"), model=tmodel)
    page = np.random.default_rng(3).integers(0, 256, (*PAGE_HW, 3), dtype=np.uint8)
    args = (PAGE_HW, 8, 32)
    opts = dict(edge_filter=edge_filter, candidate_cap=candidate_cap, letterbox=letterbox)
    want = jfused._make_detect_crop(jdet, *args, **opts)(None, jnp.asarray(page))
    got = tfused.build_fused_detect_fn(tdet, *args, **opts)(torch.from_numpy(page))

    boxes, scores, classes, valid, crops = (np.asarray(w) for w in want)
    # the views the detector saw: bf16 in [0, 1], two bf16 steps at 1
    assert seen[0].dtype == torch.bfloat16
    np.testing.assert_allclose(seen[0].float().numpy(),
                               np.asarray(jdet.model.images.astype(jnp.float32)), atol=2 / 255)
    assert valid.any()
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), classes)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=3e-7)
    np.testing.assert_allclose(got[0].numpy(), boxes, atol=1e-3)
    np.testing.assert_allclose(got[4].numpy(), crops, atol=2 / 255)




# --- the host API -------------------------------------------------------------

HOST_KW = dict(image_size=DET_SIZE, variant="n", grid_configs=((2, 2),), max_detections=MAX_DET)
# cv2's INTER_LINEAR on float32 and the port's float64 interpolation
# matrices: the same half-pixel bilinear, cv2 summing in float32 (measured
# up to 3.1e-5 on 0-255 values, 2200x1700 to 128)
CV2_ATOL = 1e-3


def _maps(n, seed, lib):
    maps = _head_maps(seed=seed, num_views=n)
    if lib == "jax":
        return [(jnp.asarray(r), jnp.asarray(c)) for r, c in maps]
    return [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps]


def _detectors(tmp_path, device_letterbox=True, seed=5, cache=False):
    """The JAX engine (made without its ~15 s init: its forward replaced) and
    the port's (its network replaced), both fed the same head maps and
    recording the images they were given."""
    from multimodal_embeddings_tpu.models.detector import LayoutDetector as JLayoutDetector

    jdet = object.__new__(JLayoutDetector)
    jdet.config = JDetectorConfig(**HOST_KW, device_letterbox=device_letterbox)
    jdet.cache_dir = str(tmp_path / "jcache") if cache else None
    jdet.variables, jdet._views_programs, jdet.seen = None, {}, []
    if cache:
        os.makedirs(jdet.cache_dir)

    def jforward(variables, images):
        jdet.seen.append(np.asarray(images, np.float32))
        return jdec.decode_predictions(_maps(images.shape[0], seed, "jax"), max_det=MAX_DET)

    jdet._forward = jforward
    tdet = LayoutDetector(DetectorConfig(**HOST_KW, device_letterbox=device_letterbox),
                          dtype=torch.float32, device="cpu",
                          cache_dir=str(tmp_path / "tcache") if cache else None)
    tdet.seen = []

    def tmodel(x):
        tdet.seen.append(x.numpy() * 255.0)
        return _maps(x.shape[0], seed, "torch")

    tdet.model = tmodel
    return jdet, tdet


def _assert_regions_equal(got, want):
    assert list(got) == list(want)
    for key in want:
        if key in ("boxes", "boxes_original"):
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), atol=1e-3)
        elif key == "scores":
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=3e-7)
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("cv2_branch", [True, False])
@pytest.mark.parametrize("hw", [(400, 300), (90, 250), (128, 128)])
def test_letterbox_host_against_both_jax_branches(monkeypatch, cv2_branch, hw):
    """The port's one resize against JAX's cv2 ``INTER_LINEAR`` branch
    (tolerance ``CV2_ATOL``) and its ``resize_bilinear`` fallback (f32
    source coordinates: 1e-2, as in ``test_torch_ops.py``). Scale and
    offsets exactly JAX's."""
    from multimodal_embeddings_tpu.models import detector as jdetector
    from multimodal_embeddings_tpu_torch.models import detector as tdetector

    if not cv2_branch:
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    img = np.random.default_rng(11).integers(0, 256, (*hw, 3)).astype(np.float32)
    want = jdetector._letterbox_host(img, DET_SIZE)
    got = tdetector._letterbox_host(img, DET_SIZE)
    assert got[1:] == want[1:]
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    np.testing.assert_allclose(got[0], want[0], atol=CV2_ATOL if cv2_branch else 1e-2)


def test_detect_batch_equal_jax(tmp_path):
    jdet, tdet = _detectors(tmp_path)
    rng = np.random.default_rng(12)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((400, 300), (90, 250), (128, 128))]
    want, got = jdet.detect_batch(images), tdet.detect_batch(images)
    np.testing.assert_allclose(tdet.seen[0], jdet.seen[0], atol=CV2_ATOL)
    assert len(got) == len(want) == 3
    for (gb, gc, gs), (wb, wc, ws) in zip(got, want):
        assert gb.dtype == wb.dtype == np.float64 and gc.dtype == wc.dtype
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=3e-7)
        np.testing.assert_allclose(gb, wb, atol=1e-3)
        assert len(gb) > 0


def test_detect_regions_and_its_cache(tmp_path):
    from PIL import Image

    jdet, tdet = _detectors(tmp_path, cache=True)
    path = str(tmp_path / "page_7.png")
    Image.fromarray(np.random.default_rng(13).integers(0, 256, (400, 300, 3),
                                                       dtype=np.uint8)).save(path)
    want, got = jdet.detect_regions(path), tdet.detect_regions(path)
    _assert_regions_equal(got, want)
    assert os.path.basename(tdet._cache_path(path)) == os.path.basename(jdet._cache_path(path))
    assert len(tdet.seen) == 1
    assert tdet.detect_regions(path) == json.loads(json.dumps(got))
    assert len(tdet.seen) == 1  # the second call read the cache


@pytest.mark.parametrize("device_letterbox", [True, False])
def test_detect_page_multigrid_equal_jax(tmp_path, device_letterbox):
    jdet, tdet = _detectors(tmp_path, device_letterbox=device_letterbox)
    page = np.random.default_rng(14).integers(0, 256, (*PAGE_HW, 3), dtype=np.uint8)
    jfull, jgrids = jdet.detect_page_multigrid("p.png", image=page)
    tfull, tgrids = tdet.detect_page_multigrid("p.png", image=page)
    # views letterboxed on the device: f32 matmuls both sides
    np.testing.assert_allclose(tdet.seen[0], jdet.seen[0],
                               atol=1e-3 if device_letterbox else CV2_ATOL)
    _assert_regions_equal(tfull, jfull)
    assert len(tgrids) == len(jgrids) == 1
    (tkey, tcells, tregions), (jkey, jcells, jregions) = tgrids[0], jgrids[0]
    assert tkey == jkey
    assert [c.coordinates for c in tcells] == [c.coordinates for c in jcells]
    for got, want in zip(tregions, jregions):
        _assert_regions_equal(got, want)
    if device_letterbox:
        assert list(tdet._views_layouts) == [PAGE_HW]
