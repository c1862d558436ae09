"""Detector and detection post-processing: PyTorch port against JAX.

1. ``DocLayoutYOLO`` (variant n, GL-CRM, 64 px, f32): the raw head maps
   from the same weights and inputs.
2. ``decode_predictions`` → per-view NMS → page mapping →
   ``internal_edge_mask`` → cross-view NMS → top-K selection → crops, fed
   identical seeded head maps whose class logits are well separated (no
   score ties within float32 reach): keep masks, orders and classes must be
   exactly equal; boxes and scores agree to float32 rounding (scores within
   3e-7: the two sigmoids differ by up to 2 ulps below 1.0).
"""

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


def _head_maps(seed=0, num_classes=10):
    """Per level (reg, cls) NHWC f32 maps. Each anchor's best class logit is
    a distinct multiple of 0.02 (offset per view), every other class sits
    ≥ 5 below it, so no two scores are within float32 reach of a tie."""
    rng = np.random.default_rng(seed)
    shapes = [(DET_SIZE // s, DET_SIZE // s) for s in jyolo.STRIDES]
    anchors = sum(h * w for h, w in shapes)
    maps = []
    best = np.stack([
        rng.permutation(anchors) * 0.02 + v * 0.004 - 3.0 for v in range(NUM_VIEWS)
    ]).astype(np.float32)
    cls_all = best[..., None] - 5.0 - rng.uniform(0, 3, (NUM_VIEWS, anchors, num_classes))
    pick = rng.integers(0, num_classes, (NUM_VIEWS, anchors))
    np.put_along_axis(cls_all, pick[..., None], best[..., None], axis=-1)
    start = 0
    for h, w in shapes:
        reg = rng.normal(scale=1.5, size=(NUM_VIEWS, h, w, 64)).astype(np.float32)
        cls = cls_all[:, start : start + h * w].reshape(NUM_VIEWS, h, w, num_classes)
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
        return self.maps


@pytest.mark.parametrize("edge_filter", [True, False])
@pytest.mark.parametrize("candidate_cap", [4, 0])
def test_detect_crop_selection_identical(edge_filter, candidate_cap):
    """The whole post-detector chain of the page program on identical head
    maps: page mapping, edge filter, class-aware cross-view NMS, top-K,
    crops. Crops: tolerance two uint8 steps (2/255) — pixels ride in bf16
    (8 significant bits: one step at values ≥ 128) and the two row-blend
    products may each round the other way."""
    maps = _head_maps(seed=1)
    kw = dict(image_size=DET_SIZE, variant="n", grid_configs=((2, 2),), max_detections=MAX_DET)
    jdet = SimpleNamespace(config=JDetectorConfig(**kw), model=_FixedJaxModel(maps))
    tdet = SimpleNamespace(
        config=DetectorConfig(**kw), device=torch.device("cpu"),
        model=lambda imgs: [(torch.from_numpy(r), torch.from_numpy(c)) for r, c in maps],
    )
    page = np.random.default_rng(3).integers(0, 256, (*PAGE_HW, 3), dtype=np.uint8)
    args = (PAGE_HW, 8, 32)
    opts = dict(edge_filter=edge_filter, candidate_cap=candidate_cap)
    want = jfused._make_detect_crop(jdet, *args, **opts)(None, jnp.asarray(page))
    got = tfused.build_fused_detect_fn(tdet, *args, **opts)(torch.from_numpy(page))

    boxes, scores, classes, valid, crops = (np.asarray(w) for w in want)
    assert valid.any()
    np.testing.assert_array_equal(got[3].numpy(), valid)
    np.testing.assert_array_equal(got[2].numpy(), classes)
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=0, atol=3e-7)
    np.testing.assert_allclose(got[0].numpy(), boxes, atol=1e-3)
    np.testing.assert_allclose(got[4].numpy(), crops, atol=2 / 255)


def test_letterbox_is_refused():
    tdet = SimpleNamespace(config=DetectorConfig(), device=torch.device("cpu"))
    with pytest.raises(NotImplementedError):
        tfused.build_fused_detect_fn(tdet, PAGE_HW, 8, 32, letterbox=True)
