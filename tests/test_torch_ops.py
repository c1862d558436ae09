"""Device ops of the page program: PyTorch port against the JAX package,
same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.ops import edge_filter as jedge
from multimodal_embeddings_tpu.ops import grid as jgrid
from multimodal_embeddings_tpu.ops import image as jimage
from multimodal_embeddings_tpu.ops import iou as jiou
from multimodal_embeddings_tpu.ops import nms as jnms
from multimodal_embeddings_tpu_torch.ops import edge_filter as tedge
from multimodal_embeddings_tpu_torch.ops import grid as tgrid
from multimodal_embeddings_tpu_torch.ops import image as timage
from multimodal_embeddings_tpu_torch.ops import iou as tiou
from multimodal_embeddings_tpu_torch.ops import nms as tnms

torch.set_num_threads(2)


def _boxes(rng, shape, extent=200.0):
    xy = rng.uniform(0, extent, shape + (2,))
    wh = rng.uniform(5, 60, shape + (2,))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def test_iou_matrix_with_padding_rows():
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, (20,))
    boxes[-3:] = 0.0  # padding rows: IoU 0 against everything
    np.testing.assert_array_equal(
        tiou.iou_matrix(torch.from_numpy(boxes)).numpy(),
        np.asarray(jiou.iou_matrix(jnp.asarray(boxes))),
    )


@pytest.mark.parametrize("class_aware", [False, True])
def test_nms_padded_keep_and_order_identical(class_aware):
    """Distinct scores, dense overlaps: keep masks and orders equal exactly."""
    rng = np.random.default_rng(1)
    boxes = _boxes(rng, (60,), extent=80.0)
    scores = rng.permutation(60).astype(np.float32) / 60
    classes = rng.integers(0, 3, 60).astype(np.int32)
    valid = scores > 0.1
    want = jnms.nms_padded(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid),
        iou_threshold=0.3, class_aware=class_aware,
    )
    got = tnms.nms_padded(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(classes),
        torch.from_numpy(valid), iou_threshold=0.3, class_aware=class_aware,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the fixpoint is the greedy scan: same kept indices as the host oracle
    kept = got[1][got[0]].numpy()
    oracle = jnms.greedy_nms_np(boxes[valid], scores[valid],
                                classes[valid] if class_aware else None, 0.3)
    np.testing.assert_array_equal(kept, np.flatnonzero(valid)[oracle])


def test_batched_nms_ties_sort_stably():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, (3, 40), extent=60.0)
    scores = np.round(rng.uniform(size=(3, 40)), 1).astype(np.float32)  # many ties
    classes = np.zeros((3, 40), np.int32)
    valid = scores >= 0.2
    want = jnms.batched_nms_padded(*(jnp.asarray(a) for a in (boxes, scores, classes, valid)))
    got = tnms.batched_nms_padded(*(torch.from_numpy(a) for a in (boxes, scores, classes, valid)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_internal_edge_mask():
    rng = np.random.default_rng(3)
    cells = np.asarray(
        [(0, 0, 300, 400), (0, 0, 180, 240), (120, 0, 300, 240), (0, 160, 180, 400),
         (120, 160, 300, 400)], np.float32,
    )
    boxes = _boxes(rng, (5, 50), extent=300.0)
    size = np.asarray([300.0, 400.0], np.float32)
    np.testing.assert_array_equal(
        tedge.internal_edge_mask(
            torch.from_numpy(boxes), torch.from_numpy(cells), torch.from_numpy(size)
        ).numpy(),
        np.asarray(jedge.internal_edge_mask(jnp.asarray(boxes), jnp.asarray(cells), jnp.asarray(size))),
    )


def test_grid_cells_copy():
    for rows, cols in ((2, 2), (3, 3), (4, 4)):
        assert [vars(c) for c in tgrid.grid_cells(1700, 2200, rows, cols, 20.0)] == [
            vars(c) for c in jgrid.grid_cells(1700, 2200, rows, cols, 20.0)
        ]


def test_interp_matrix_copy():
    for n_in, n_out in ((2200, 1024), (37, 64), (64, 64)):
        np.testing.assert_array_equal(
            timage._interp_matrix(n_in, n_out), jimage._interp_matrix(n_in, n_out)
        )


def test_extract_views_matmul_f32():
    """f32 (HIGHEST precision on the JAX side): equal to float rounding."""
    page = np.random.default_rng(4).integers(0, 256, (200, 150, 3)).astype(np.float32)
    bounds = [(0, 0, 150, 200), (0, 0, 90, 120), (60, 0, 150, 120), (0, 80, 90, 200)]
    np.testing.assert_allclose(
        timage.extract_views_matmul(torch.from_numpy(page), bounds, 64).numpy(),
        np.asarray(jimage.extract_views_matmul(jnp.asarray(page), bounds, 64)),
        atol=1e-3,
    )


def test_extract_views_matmul_bf16():
    """The page program's bf16 views: weights and both contractions round
    to bf16 on each side; tolerance one bf16 step at 255 (2.0), since the
    frameworks may round a sum the other way."""
    page = np.random.default_rng(5).integers(0, 256, (200, 150, 3)).astype(np.uint8)
    bounds = [(0, 0, 150, 200), (60, 0, 150, 120)]
    got = timage.extract_views_matmul(
        torch.from_numpy(page).bfloat16(), bounds, 64, dtype=torch.bfloat16
    )
    want = jimage.extract_views_matmul(
        jnp.asarray(page, jnp.bfloat16), bounds, 64, dtype=jnp.bfloat16
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2.0
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_and_resize_mxu(dtype):
    """f32: 5e-3 — XLA contracts the source coordinate ``y1 + i·h − 0.5``
    (up to ~120 here) into an FMA, so a blend weight may differ by an ulp of
    that coordinate (~1e-5), times a pixel contrast of up to 255. bf16: two
    uint8 steps (the row blend rounds in bf16, 8 significant bits)."""
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (120, 90, 3)).astype(np.uint8)
    boxes = np.concatenate([_boxes(rng, (10,), extent=60.0), [[-5, -5, 200, 200]]]).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = timage.crop_and_resize_mxu(
        torch.from_numpy(image), torch.from_numpy(boxes), out_size=24, compute_dtype=tdt
    )
    want = jimage.crop_and_resize_mxu(
        jnp.asarray(image), jnp.asarray(boxes), out_size=24, compute_dtype=jdt
    )
    assert got.shape == (11, 24, 24, 3) and got.dtype == torch.float32
    atol = 5e-3 if dtype == "float32" else 2.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# views of four slice shapes: the full page, two grid cells of one shape
# (one batched resize), a tall cell and a wide one
LETTERBOX_BOUNDS = [(0, 0, 150, 200), (0, 0, 90, 120), (60, 0, 150, 120), (0, 80, 40, 200),
                    (10, 150, 150, 190)]


def test_letterbox_views_matmul_f32():
    """f32 both sides (HIGHEST on the JAX side): views to float rounding,
    the placements (scale, (top, left)) exactly JAX's."""
    page = np.random.default_rng(6).integers(0, 256, (200, 150, 3)).astype(np.float32)
    got, gmetas = timage.letterbox_views_matmul(torch.from_numpy(page), LETTERBOX_BOUNDS, 64)
    want, wmetas = jimage.letterbox_views_matmul(jnp.asarray(page), LETTERBOX_BOUNDS, 64)
    assert gmetas == wmetas
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    # the gray bars are exactly 114
    scale, (top, left) = gmetas[3]
    assert top == 0 and left > 0 and bool((got[3, :, :left] == 114.0).all())


def test_letterbox_views_matmul_bf16_page():
    """The page program's form: a bf16 page (uint8 values are exact in bf16),
    an f32 canvas, then bf16. One bf16 step at 255 (2.0) after the cast."""
    page = np.random.default_rng(7).integers(0, 256, (200, 150, 3)).astype(np.uint8)
    got, _ = timage.letterbox_views_matmul(
        torch.from_numpy(page).bfloat16(), LETTERBOX_BOUNDS, 64)
    want, _ = jimage.letterbox_views_matmul(
        jnp.asarray(page, jnp.bfloat16), LETTERBOX_BOUNDS, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    np.testing.assert_allclose(got.bfloat16().float().numpy(),
                               np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)),
                               atol=2.0)


@pytest.mark.parametrize("shape,out", [((200, 150), (97, 73)), ((37, 53), (64, 91)),
                                       ((64, 64), (64, 64))])
def test_resize_bilinear_host_against_jax(shape, out):
    """The host resize against JAX's ``resize_bilinear`` (the gather form of
    the same half-pixel bilinear). JAX computes the source coordinates in
    f32: up to ~1.5e-5 px off at 200 px, times a neighbour difference of up
    to 255, so 1e-2 on 0-255 values (measured 4.3e-3)."""
    img = np.random.default_rng(8).integers(0, 256, (*shape, 3)).astype(np.float32)
    got = timage.resize_bilinear_host(img, *out)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(img), *out))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_translate_boxes_equal():
    cell = tgrid.grid_cells(1700, 2200, 3, 3, 20.0)[4]
    jcell = jgrid.grid_cells(1700, 2200, 3, 3, 20.0)[4]
    boxes = _boxes(np.random.default_rng(9), (6,)).tolist()
    assert tgrid.translate_boxes(boxes, cell) == jgrid.translate_boxes(boxes, jcell)
