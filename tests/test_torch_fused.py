"""The page program as a whole: the port's ``build_split_page_fn`` against
the JAX package's, at the tiny detector of ``tests/test_fused.py`` (variant
n, 128 px, full page + 2×2 views) with an L=256 ViT (siglip) and with the
tiny int8-mixed mmE5 model on 28 px crops (mme5), in f32 on the CPU.

With random weights every detection score lies within ~1e-5 of 0.5, closer
than the float32 differences between two frameworks, so which of several
near-equal boxes wins a tie may differ. So the stages are compared on
identical inputs — head maps on JAX's views, crops from JAX's boxes,
embeddings of JAX's crops — and end to end only through what a tie flip
cannot move: the shapes, the valid count, unit-norm embeddings, and the
sorted top-K scores. (The post-detector chain on tie-free head maps is
compared exactly in ``test_torch_detect.py``.)
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
from multimodal_embeddings_tpu.config import EmbedderConfig as JEmbedderConfig
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models.embedder import MultimodalEmbedder as JEmbedder
from multimodal_embeddings_tpu.models.vision_encoder import DualEncoderConfig as JDual
from multimodal_embeddings_tpu.models.vision_encoder import VisionConfig as JVision
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu.models.yolo import DocLayoutYOLO as JYolo
from multimodal_embeddings_tpu.ops.image import extract_views_matmul as jextract
from multimodal_embeddings_tpu.pipeline import fused as jfused
from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
from multimodal_embeddings_tpu_torch.models.vision_encoder import (
    DualEncoderConfig,
    VisionConfig,
)
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params
from multimodal_embeddings_tpu_torch.ops.image import crop_and_resize_mxu
from multimodal_embeddings_tpu_torch.pipeline import fused as tfused
from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

torch.set_num_threads(2)

PAGE_HW = (400, 300)
K = 8
DET = dict(image_size=128, variant="n", grid_configs=((2, 2),), max_detections=64)
VIT = dict(image_size=256, patch_size=16, width=64, layers=2, heads=2)


@pytest.fixture(scope="module")
def both():
    """Both page programs on one page, JAX tracing its Pallas kernels in
    interpret mode. The detector's parameters come from the port's seeded
    init (JAX's own init of it costs ~15 s of tracing); the embedder's from
    the JAX engine."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_ENC_ATTN_BLF_INTERPRET", "1")
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        det_flat = export_jax_params(
            LayoutDetector(DetectorConfig(**DET), dtype=torch.float32, device="cpu", seed=0).model
        )
        jdet = SimpleNamespace(
            config=JDetectorConfig(**DET),
            model=JYolo(num_classes=10, variant="n", glcrm=True, dtype=jnp.float32),
            variables=unflatten_params(det_flat),
        )
        jemb = JEmbedder(
            JEmbedderConfig(family="siglip", dtype="float32"),
            model_config=JDual(vision=JVision(**VIT), embed_dim=64),
        )
        page = make_page(*PAGE_HW, seed=1)
        jfn = jfused.build_split_page_fn(jdet, jemb, PAGE_HW, num_regions=K, embed_chunk=4)
        jres = [np.array(x) for x in jfn(jnp.asarray(page))]
        jdetect = jfused.build_fused_detect_fn(jdet, PAGE_HW, num_regions=K, emb_size=256)
        jcrops = np.array(jdetect(jnp.asarray(page))[4])
        jviews = np.array(
            jextract(jnp.asarray(page, jnp.bfloat16), [(0, 0, 300, 400)], 128,
                     dtype=jnp.bfloat16).astype(jnp.float32) / 255.0
        )
        jmaps = jdet.model.apply(jdet.variables, jnp.asarray(jviews))

    tdet = LayoutDetector(
        DetectorConfig(**DET), dtype=torch.float32, device="cpu", params=det_flat
    )
    temb = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32"),
        model_config=DualEncoderConfig(vision=VisionConfig(**VIT), embed_dim=64),
        device="cpu",
        params=flatten_params(jemb.variables),
    )
    tfn = tfused.build_split_page_fn(tdet, temb, PAGE_HW, num_regions=K, embed_chunk=4)
    tres = tfn(torch.from_numpy(page))
    return SimpleNamespace(
        page=page, jres=jres, jcrops=jcrops, jviews=jviews, jmaps=jmaps,
        tdet=tdet, temb=temb, tfn=tfn, tres=tres,
    )


def test_output_contract(both):
    r = both.tres
    assert [tuple(x.shape) for x in r] == [tuple(x.shape) for x in both.jres]
    assert r.valid.dtype == torch.bool and r.classes.dtype == torch.int32
    assert int(r.valid.sum()) == int(both.jres[3].sum())
    np.testing.assert_allclose(r.embeddings.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_head_maps_on_jax_views(both):
    """Tolerance 1e-4 on head logits: the detector test's bound."""
    with torch.no_grad():
        got = both.tdet.model(torch.from_numpy(both.jviews))
    for (greg, gcls), (wreg, wcls) in zip(got, both.jmaps):
        np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)


def test_crops_from_jax_boxes(both):
    """Two uint8 steps over 255: pixels ride in bf16 through the row blend."""
    got = crop_and_resize_mxu(
        torch.from_numpy(both.page).bfloat16(), torch.from_numpy(both.jres[0]),
        out_size=256, compute_dtype=torch.bfloat16,
    ) / 255.0
    np.testing.assert_allclose(got.numpy(), both.jcrops, atol=2 / 255)


def test_embeddings_of_jax_crops(both):
    """Unit-norm f32 embeddings of identical crops: 1e-5 absolute."""
    got = both.temb.encode_image(torch.from_numpy(both.jcrops))
    np.testing.assert_allclose(got.numpy(), both.jres[4], atol=1e-5)


def test_sorted_top_k_scores(both):
    """The K best scores the page yields, whichever near-tied boxes carry
    them. Tolerance 2e-7: the scores' float32 spacing near 0.5 is 6e-8 and
    the two head-map computations differ by float32 rounding."""
    got = np.sort(both.tres.scores.numpy())
    want = np.sort(both.jres[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_fused_page_fn_equals_split(both):
    """One embed call over all crops gives the split program's result."""
    fn = tfused.build_fused_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K)
    res = fn(torch.from_numpy(both.page))
    for a, b in zip(res, both.tres):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_split_halves_compose(both):
    boxes, scores, classes, valid, crops = both.tfn.detect(torch.from_numpy(both.page))
    assert crops.shape == (K, 256, 256, 3)
    torch.testing.assert_close(boxes, both.tres.boxes, rtol=0, atol=0)
    torch.testing.assert_close(both.tfn.embed(crops), both.tres.embeddings, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tfused.build_split_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K, embed_chunk=3)


@pytest.fixture(scope="module")
def mme5(both):
    """The mme5 branch of both page programs on the same page and detector:
    the JAX engine's synthetic int8-mixed tree bridged into the port."""
    jemb = JEmbedder(
        JEmbedderConfig(family="mme5", dtype="float32", quantize="int8-mixed"),
        model_config=jm.MllamaConfig.tiny(),
    )
    jdet = SimpleNamespace(
        config=JDetectorConfig(**DET),
        model=JYolo(num_classes=10, variant="n", glcrm=True, dtype=jnp.float32),
        variables=unflatten_params(export_jax_params(both.tdet.model)),
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        jfn = jfused.build_split_page_fn(jdet, jemb, PAGE_HW, num_regions=K, embed_chunk=4)
        jres = [np.array(x) for x in jfn(jnp.asarray(both.page))]
        jdetect = jfused.build_fused_detect_fn(jdet, PAGE_HW, num_regions=K, emb_size=28)
        jcrops = np.array(jdetect(jnp.asarray(both.page))[4])
    temb = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="float32", quantize="int8-mixed"),
        model_config=MllamaConfig.tiny(), device="cpu", params=flatten_params(jemb.variables),
    )
    tfn = tfused.build_split_page_fn(both.tdet, temb, PAGE_HW, num_regions=K, embed_chunk=4)
    return SimpleNamespace(jres=jres, jcrops=jcrops, tfn=tfn, jdet=jdet, jemb=jemb, temb=temb,
                           tres=tfn(torch.from_numpy(both.page)))


def test_mme5_output_contract(mme5):
    r = mme5.tres
    assert [tuple(x.shape) for x in r] == [tuple(x.shape) for x in mme5.jres]
    assert r.embeddings.shape == (K, 64)
    assert int(r.valid.sum()) == int(mme5.jres[3].sum())
    np.testing.assert_allclose(r.embeddings.norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_mme5_embeddings_of_jax_crops(mme5):
    """CLIP-normalised, then the prompt and the crop through the tiny
    int8-mixed model, chunk by chunk: 1e-5 absolute on unit vectors."""
    assert mme5.jcrops.shape == (K, 28, 28, 3)
    got = mme5.tfn.embed(torch.from_numpy(mme5.jcrops))
    np.testing.assert_allclose(got.numpy(), mme5.jres[4], atol=1e-5)


def test_mme5_sorted_top_k_scores(mme5):
    """The detect half is the siglip page's: same scores (see above)."""
    np.testing.assert_allclose(np.sort(mme5.tres.scores.numpy()), np.sort(mme5.jres[1]),
                               rtol=0, atol=2e-7)


def _jax_page(mme5, page, build, **kwargs):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        fn = build(mme5.jdet, mme5.jemb, PAGE_HW, num_regions=K, **kwargs)
        return [np.array(x) for x in fn(jnp.asarray(page))]


def _jax_detect(mme5, page, emb_size):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        jdetect = jfused.build_fused_detect_fn(mme5.jdet, PAGE_HW, num_regions=K,
                                               emb_size=emb_size)
        return [np.array(x) for x in jdetect(jnp.asarray(page))]


@pytest.mark.parametrize("embed_chunk", [0, 4])
def test_mme5_fused_page_fn_matches_jax(both, mme5, embed_chunk, monkeypatch):
    """The fused page program's mme5 branch against JAX's on the same page
    and detector: the port's detect half is replaced by JAX's (whose boxes
    equal the JAX fused program's), so both embed the same crops; 1e-5
    absolute on unit vectors, as ``test_mme5_embeddings_of_jax_crops``.
    The crops are CLIP-normalised before the tower on both sides."""
    jres = _jax_page(mme5, both.page, jfused.build_fused_page_fn, embed_chunk=embed_chunk)
    jdet = _jax_detect(mme5, both.page, 28)
    np.testing.assert_array_equal(jdet[0], jres[0])
    monkeypatch.setattr(tfused, "build_fused_detect_fn",
                        lambda *a, **k: lambda page: tuple(torch.from_numpy(x) for x in jdet))
    chunk = {"embed_chunk": embed_chunk} if embed_chunk else {}
    fn = tfused.build_fused_page_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K, **chunk)
    res = fn(torch.from_numpy(both.page))
    np.testing.assert_allclose(res.embeddings.numpy(), jres[4], atol=1e-5)


@pytest.fixture(scope="module")
def tiles4(both, mme5):
    """JAX's 56-px crops (two 28-px tiles a side) and both JAX page
    programs' embeddings of them at ``embed_tiles=4``."""
    jdet = _jax_detect(mme5, both.page, 56)
    split = _jax_page(mme5, both.page, jfused.build_split_page_fn, embed_chunk=4,
                      embed_tiles=4)
    fused = _jax_page(mme5, both.page, jfused.build_fused_page_fn, embed_chunk=0,
                      embed_tiles=4)
    for res in (split, fused):
        np.testing.assert_array_equal(jdet[0], res[0])
    return SimpleNamespace(crops=jdet[4], split=split[4], fused=fused[4])


@pytest.mark.parametrize("build", ["split", "fused"])
def test_mme5_embed_tiles_4_matches_jax(both, mme5, tiles4, build):
    """Each crop split row-major into the (2, 2) canvas with its aspect-ratio
    id and a mask of four real tiles (the tower's masked plain path on both
    sides): 1e-5 absolute on unit vectors."""
    assert tiles4.crops.shape == (K, 56, 56, 3)
    kwargs = {"embed_chunk": 4} if build == "split" else {}
    fn = getattr(tfused, f"build_{build}_page_fn")(both.tdet, mme5.temb, PAGE_HW,
                                                    num_regions=K, embed_tiles=4, **kwargs)
    assert fn.detect(torch.from_numpy(both.page))[4].shape == (K, 56, 56, 3)
    got = fn.embed(torch.from_numpy(tiles4.crops)).numpy()
    np.testing.assert_allclose(got, getattr(tiles4, build), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_tile_crops_2x2_equals_jax():
    crops = np.random.default_rng(3).normal(size=(3, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jfused.tile_crops_2x2(jnp.asarray(crops), 4))
    np.testing.assert_array_equal(tfused.tile_crops_2x2(torch.from_numpy(crops), 4).numpy(),
                                  want)


@pytest.mark.parametrize("embed_tiles", [1, 4])
def test_mme5_text_chunk_matches_jax_and_coupled(both, mme5, tiles4, embed_tiles):
    """The vision tower at 2 crops a call, the text stack at 4 over the
    concatenated states: against JAX's decoupled page (1e-5 absolute on unit
    vectors) and against the port's coupled path on the same crops (1e-6:
    the same operations, only the batch of the text stack differs)."""
    crops = mme5.jcrops if embed_tiles == 1 else tiles4.crops
    jres = _jax_page(mme5, both.page, jfused.build_split_page_fn, embed_chunk=2,
                     embed_tiles=embed_tiles, text_chunk=4)
    fn = tfused.build_split_page_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K,
                                    embed_chunk=2, embed_tiles=embed_tiles, text_chunk=4)
    got = fn.embed(torch.from_numpy(crops))
    np.testing.assert_allclose(got.numpy(), jres[4], atol=1e-5)
    coupled = tfused.build_split_page_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K,
                                         embed_chunk=2, embed_tiles=embed_tiles)
    np.testing.assert_allclose(got.numpy(), coupled.embed(torch.from_numpy(crops)).numpy(),
                               atol=1e-6)


def test_page_fn_arguments_are_checked(both, mme5):
    """As in JAX: the tiled and decoupled forms are mme5 only, and each
    chunk must divide the region count."""
    for kwargs in ({"embed_tiles": 4}, {"text_chunk": 4}):
        with pytest.raises(ValueError):
            tfused.build_split_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K, **kwargs)
    with pytest.raises(ValueError):
        tfused.build_fused_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K, embed_tiles=4)
    for kwargs in ({"text_chunk": 3}, {"embed_chunk": 3}, {"embed_tiles": 2}):
        with pytest.raises(ValueError):
            tfused.build_split_page_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K, **kwargs)


@pytest.fixture(scope="module")
def letterboxed(both):
    """The detect half of both page programs with letterboxed views (the
    serving CLI's default) on the same page and detector parameters."""
    from multimodal_embeddings_tpu.ops.image import letterbox_views_matmul as jletterbox

    jdet = SimpleNamespace(
        config=JDetectorConfig(**DET),
        model=JYolo(num_classes=10, variant="n", glcrm=True, dtype=jnp.float32),
        variables=unflatten_params(export_jax_params(both.tdet.model)),
    )
    bounds = tfused.view_slice_bounds_for_page(PAGE_HW[1], PAGE_HW[0], ((2, 2),), 20.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        jdetect = jfused.build_fused_detect_fn(jdet, PAGE_HW, num_regions=K, emb_size=256,
                                               letterbox=True)
        jres = [np.array(x) for x in jdetect(jnp.asarray(both.page))]
        jviews = np.array(
            jletterbox(jnp.asarray(both.page, jnp.bfloat16), bounds, 128)[0]
            .astype(jnp.bfloat16).astype(jnp.float32) / 255.0
        )
        jmaps = jdet.model.apply(jdet.variables, jnp.asarray(jviews))
    seen = []
    model = both.tdet.model
    tdet = SimpleNamespace(config=both.tdet.config, device=both.tdet.device,
                           model=lambda x: seen.append(x) or model(x))
    tdetect = tfused.build_fused_detect_fn(tdet, PAGE_HW, num_regions=K, emb_size=256,
                                           letterbox=True)
    tres = tdetect(torch.from_numpy(both.page))
    page_fn = tfused.build_split_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K,
                                         embed_chunk=4, letterbox=True)
    return SimpleNamespace(jres=jres, jviews=jviews, jmaps=jmaps, tres=tres, seen=seen,
                           page=page_fn(torch.from_numpy(both.page)))


def test_letterboxed_views_equal_jax(letterboxed):
    """The views the detector sees: bf16 in [0, 1] from the f32 canvas, one
    bf16 step at 1 (the canvas sums differ by f32 rounding)."""
    got = letterboxed.seen[0]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == letterboxed.jviews.shape
    np.testing.assert_allclose(got.float().numpy(), letterboxed.jviews, atol=1 / 255)


def test_letterboxed_head_maps_on_jax_views(both, letterboxed):
    """Tolerance 1e-4 on head logits, as ``test_head_maps_on_jax_views``."""
    with torch.no_grad():
        got = both.tdet.model(torch.from_numpy(letterboxed.jviews))
    for (greg, gcls), (wreg, wcls) in zip(got, letterboxed.jmaps):
        np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)


def test_letterboxed_selection_and_crops(both, letterboxed):
    """What a tie flip cannot move (the sorted top-K scores within 2e-7,
    the valid count), and crops of JAX's boxes within two uint8 steps."""
    got, want = letterboxed.tres, letterboxed.jres
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want]
    assert int(got[3].sum()) == int(want[3].sum())
    np.testing.assert_allclose(np.sort(got[1].numpy()), np.sort(want[1]), rtol=0, atol=2e-7)
    crops = crop_and_resize_mxu(
        torch.from_numpy(both.page).bfloat16(), torch.from_numpy(want[0]),
        out_size=256, compute_dtype=torch.bfloat16,
    ) / 255.0
    np.testing.assert_allclose(crops.numpy(), want[4], atol=2 / 255)
    # other boxes than the squeezed program's (a box on a letterbox bar maps
    # off the page, as in JAX; the serving CLI clips it)
    assert not torch.equal(got[0], both.tres.boxes)


def test_letterboxed_page_fn_output_contract(letterboxed):
    r = letterboxed.page
    assert tuple(r.embeddings.shape) == (K, 64)
    np.testing.assert_allclose(r.embeddings.norm(dim=-1).numpy(), 1.0, rtol=1e-6)
    torch.testing.assert_close(r.boxes, letterboxed.tres[0], rtol=0, atol=0)


def test_view_boxes_for_page_equal_jax():
    for grids in ((), ((2, 2),), ((2, 2), (3, 3), (4, 4))):
        np.testing.assert_array_equal(
            tfused.view_boxes_for_page(1700, 2200, grids, 20.0),
            jfused.view_boxes_for_page(1700, 2200, grids, 20.0))


# -- the batch page functions (build_fused_batch_fn, build_split_batch_fn) ---
#
# JAX's tests/test_fused.py:202 and :331: a batch of pages against the page
# function per page (1e-4), and the batch against JAX's batch program by
# stage (the embeddings of JAX's crops, the sorted top-K scores per page);
# then over gloo ranks (one spawn of 2): the pages on a (2, 1) mesh and the
# mmE5 embedder tensor-sharded on (1, 2), against the page function.

BATCH_ATOL = 1e-4
N_BATCH = 3


def _batch_pages(both):
    return np.stack([both.page] + [make_page(*PAGE_HW, seed=s) for s in (2, 3)])


@pytest.fixture(scope="module")
def batches(both, mme5):
    """The port's and JAX's batch functions on the same 3 pages: siglip
    through the fused batch, the int8-mixed mme5 through the split batch."""
    pages = _batch_pages(both)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMTPU_ENC_ATTN_BLF_INTERPRET", "1")
        mp.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
        jdetect = jfused.build_fused_detect_fn(mme5.jdet, PAGE_HW, num_regions=K, emb_size=28)
        jmme5 = jfused.build_split_batch_fn(mme5.jdet, mme5.jemb, PAGE_HW, num_regions=K,
                                            embed_chunk=4)(jnp.asarray(pages))
        out["mme5"] = dict(
            jres=[np.array(x) for x in jmme5],
            jcrops=np.stack([np.array(jdetect(jnp.asarray(p))[4]) for p in pages]),
            fn=tfused.build_split_batch_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K,
                                           embed_chunk=4),
            page_fn=mme5.tfn)
    out["siglip"] = dict(
        fn=tfused.build_fused_batch_fn(both.tdet, both.temb, PAGE_HW, num_regions=K),
        page_fn=tfused.build_fused_page_fn(both.tdet, both.temb, PAGE_HW, num_regions=K))
    for case in out.values():
        case["tres"] = case["fn"](pages)
    out["pages"] = pages
    return out


@pytest.mark.parametrize("family", ["siglip", "mme5"])
def test_batch_fn_equals_page_fn_per_page(batches, family):
    """Every field of every page within 1e-4 of the page function's (JAX's
    bound for its vmapped batch; on the CPU the two are equal)."""
    case = batches[family]
    got = case["tres"]
    assert got.boxes.shape == (N_BATCH, K, 4) and got.valid.dtype == torch.bool
    for b in range(N_BATCH):
        want = case["page_fn"](torch.from_numpy(batches["pages"][b]))
        for name, g, w in zip(got._fields, got, want):
            torch.testing.assert_close(g[b], w, rtol=0, atol=BATCH_ATOL, msg=name)


def test_split_batch_embeddings_of_jax_crops(batches):
    """The split batch's embed half on JAX's crops of the 3 pages, chunk i
    of every page in one call: within 1e-4 of JAX's split batch."""
    case = batches["mme5"]
    got = case["fn"].embed(torch.from_numpy(case["jcrops"]))
    assert got.shape == (N_BATCH, K, 64)
    np.testing.assert_allclose(got.numpy(), case["jres"][4], atol=BATCH_ATOL, rtol=0)


def test_split_batch_sorted_top_k_scores_per_page(batches):
    """Which near-tied boxes win may differ between the frameworks; the K
    best scores of each page do not (2e-7, as the page test)."""
    got, want = batches["mme5"]["tres"].scores.numpy(), batches["mme5"]["jres"][1]
    np.testing.assert_allclose(np.sort(got, axis=1), np.sort(want, axis=1), rtol=0, atol=2e-7)


def test_fused_batch_embeddings_of_jax_crops(both, batches):
    """The fused batch's embed half (all 2·K crops of two pages in one
    call) on JAX's crops: JAX's embeddings of them (its page program's, 4
    crops a call) within 1e-4."""
    got = batches["siglip"]["fn"].embed(torch.from_numpy(np.stack([both.jcrops] * 2)))
    assert got.shape == (2, K, 64)
    np.testing.assert_allclose(got.numpy(), np.stack([both.jres[4]] * 2), atol=BATCH_ATOL,
                               rtol=0)


def test_batch_fn_arguments_are_checked_as_jax(both, mme5):
    class Other:
        config = SimpleNamespace(family="other")

    with pytest.raises(ValueError, match="unsupported split-batch family: other"):
        tfused.build_split_batch_fn(both.tdet, Other(), PAGE_HW, num_regions=K)
    with pytest.raises(AssertionError):
        tfused.build_split_batch_fn(both.tdet, mme5.temb, PAGE_HW, num_regions=K, embed_chunk=3)


@pytest.fixture(scope="module")
def batch_ranks(both):
    """One spawn of 2 gloo ranks: the fused batch (siglip) and the split
    batch (the float tiny mmE5, seed 0) on a (2, 1) mesh, the split batch
    with the mmE5 tree tensor-sharded on (1, 2)."""
    from multimodal_embeddings_tpu_torch.core.mesh import launch
    from multimodal_embeddings_tpu_torch.parallel import dryrun

    pages = _batch_pages(both)[:2]
    det_flat = export_jax_params(both.tdet.model)
    sig = dict(embedder_config=EmbedderConfig(family="siglip", dtype="float32"),
               model_config=DualEncoderConfig(vision=VisionConfig(**VIT), embed_dim=64),
               embedder_params=export_jax_params(both.temb.model))
    mme5 = dict(embedder_config=EmbedderConfig(family="mme5", dtype="float32"),
                model_config=MllamaConfig.tiny(), embedder_params=None)
    common = dict(pages=pages, page_hw=PAGE_HW, num_regions=K,
                  detector_config=DetectorConfig(**DET), detector_params=det_flat)
    runs = {"fused (2, 1)": dict(build="fused", shape=(2, 1), **sig),
            "split (2, 1)": dict(build="split", shape=(2, 1), embed_chunk=4, **mme5),
            "split (1, 2)": dict(build="split", shape=(1, 2), embed_chunk=4, **mme5)}
    results = launch(dryrun.run_cases, 2, [("batch_case", dict(**common, **kw))
                                           for kw in runs.values()],
                     device="cpu", timeout=300)
    for a, b in zip(results[0], results[1]):  # every rank holds the whole batch
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    plain_mme5 = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                                    model_config=MllamaConfig.tiny(), device="cpu")
    page_fns = {"fused (2, 1)": tfused.build_fused_page_fn(both.tdet, both.temb, PAGE_HW,
                                                           num_regions=K)}
    page_fns["split (2, 1)"] = page_fns["split (1, 2)"] = tfused.build_split_page_fn(
        both.tdet, plain_mme5, PAGE_HW, num_regions=K, embed_chunk=4)
    return {name: (got, page_fns[name], pages) for name, got in zip(runs, results[0])}


@pytest.mark.parametrize("name", ["fused (2, 1)", "split (2, 1)", "split (1, 2)"])
def test_batch_fn_on_a_mesh_equals_page_fn(batch_ranks, name):
    got, page_fn, pages = batch_ranks[name]
    assert got[4].shape == (2, K, 64)
    for b in range(2):
        want = page_fn(torch.from_numpy(pages[b]))
        for field, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g[b], w.numpy(), rtol=0, atol=BATCH_ATOL, err_msg=field)
