"""Stage 0 — the deskew — in the port against the JAX package, on the CPU.

* The filters and warps of ``ops/image.py`` against JAX's on the same f32
  inputs: ``rgb_to_gray``, ``rotate_bound`` and ``resize_bilinear`` equal to
  f32 round-off (1e-4 on 0-255 values; measured equal); ``gaussian_blur``
  within 1e-3 (measured ≤ 3e-5: the port sums the taps in order, XLA's
  convolution in its own order); the binary maps of
  ``adaptive_threshold_gaussian`` and ``edge_map`` differ at no more than 8
  pixels of a 600×800 page (a pixel within an f32 step of its threshold can
  flip; measured 0).
* ``detect_skew``: the port's angle EQUAL to JAX's on the known-rotation
  pages of ``tests/test_image_skew.py`` (−6, −2.5, 2, 5 and 11 degrees), on
  the clean page, and None on the featureless page; the port's exact
  (fixed-point) profile scores within 1e-5 of JAX's f32 scatter sums.
* ``batch_correct_orientation``: a rotated page, a page copied through and
  an invalid file give the same results, the same log lines and
  byte-identical output files, with cv2 and with cv2 taken away from both
  packages.
"""

import dataclasses
import inspect
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_embeddings_tpu.io import images as jimages
from multimodal_embeddings_tpu.ops import image as jimage
from multimodal_embeddings_tpu.ops import skew as jskew
from multimodal_embeddings_tpu.pipeline import orientation as jorient
from multimodal_embeddings_tpu_torch.ops import image as timage
from multimodal_embeddings_tpu_torch.ops import skew as tskew
from multimodal_embeddings_tpu_torch.pipeline import orientation as torient

torch.set_num_threads(2)

# binary maps: pixels that may flip between the two filters' summation orders
MAX_FLIPS = 8


def text_page(h=600, w=800, line_period=24, line_thickness=6, seed=0):
    """Synthetic page: dark horizontal text-line bands on white (the JAX
    test's generator)."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 235.0, np.float32)
    for y in range(40, h - 40, line_period):
        x0 = rng.integers(30, 80)
        x1 = w - rng.integers(30, 120)
        img[y : y + line_thickness, x0:x1] = 30.0
    return img


@pytest.mark.parametrize("name", ["_gaussian_kernel1d", "rotate_bound_shape"])
def test_host_copy_has_the_jax_source(name):
    assert inspect.getsource(getattr(timage, name)) == inspect.getsource(getattr(jimage, name))


def test_constants_equal_jax():
    assert timage._SMALL_GAUSSIAN.keys() == jimage._SMALL_GAUSSIAN.keys()
    for k, v in jimage._SMALL_GAUSSIAN.items():
        assert np.array_equal(timage._SMALL_GAUSSIAN[k], v)
    for name in ("WORK_SIZE", "COARSE_RANGE", "COARSE_STEP", "FINE_STEP", "FINE_HALF_WIDTH"):
        assert getattr(tskew, name) == getattr(jskew, name)
    coarse = tskew._angles(-45.0, 46.0, 1.0, "cpu").numpy()
    fine = tskew._angles(-1.0, 1.05, 0.05, "cpu").numpy()
    assert np.array_equal(coarse, np.asarray(jnp.arange(-45.0, 46.0, 1.0, dtype=jnp.float32)))
    assert np.array_equal(fine, np.asarray(jnp.arange(-1.0, 1.05, 0.05, dtype=jnp.float32)))
    assert (len(coarse), len(fine)) == (91, 41)


def test_gray_and_filters_against_jax():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (96, 130, 3)).astype(np.float32)
    np.testing.assert_allclose(timage.rgb_to_gray(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb))), atol=1e-4)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    for ksize, sigma in ((5, 0.0), (3, 0.0), (11, 0.0), (9, 2.0)):
        np.testing.assert_allclose(
            timage.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy(),
            np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize, sigma)), atol=1e-3)
    gx, gy = timage.sobel_gradients(torch.from_numpy(img))
    jgx, jgy = jimage.sobel_gradients(jnp.asarray(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-3)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), atol=1e-3)


@pytest.mark.parametrize("angle", [0.0, 3.0])
def test_binary_maps_against_jax(angle):
    """The estimator's chain on a page: blur → adaptive threshold → edge
    map, each against JAX's on the same input."""
    page = text_page()
    if angle:
        page = np.asarray(jimage.rotate_bound(jnp.asarray(page), angle))
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(page), 5, 0.0))
    want = np.asarray(jimage.adaptive_threshold_gaussian(jnp.asarray(blurred), 11, 2.0))
    got = timage.adaptive_threshold_gaussian(torch.from_numpy(blurred), 11, 2.0).numpy()
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 255.0}
    assert (got != want).sum() <= MAX_FLIPS
    edges_want = np.asarray(jimage.edge_map(jnp.asarray(want), 50.0, 150.0))
    edges_got = timage.edge_map(torch.from_numpy(want), 50.0, 150.0).numpy()
    assert edges_want.sum() > 1000
    assert (edges_got != edges_want).sum() <= MAX_FLIPS
    for inverse in (False, True):
        a = timage.adaptive_threshold_gaussian(torch.from_numpy(page), 7, 3.0, 200.0, inverse)
        b = jimage.adaptive_threshold_gaussian(jnp.asarray(page), 7, 3.0, 200.0, inverse)
        assert (a.numpy() != np.asarray(b)).sum() <= MAX_FLIPS


@pytest.mark.parametrize("angle", [-6.0, 90.0])
def test_warps_against_jax(angle):
    page = text_page(120, 170)
    rgb = np.random.default_rng(1).uniform(0, 255, (50, 70, 3)).astype(np.float32)
    for img in (page, rgb):
        want = np.asarray(jimage.rotate_bound(jnp.asarray(img), angle))
        got = timage.rotate_bound(torch.from_numpy(img), angle).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
    for out_h, out_w in ((60, 85), (200, 31)):
        want = np.asarray(jimage.resize_bilinear(jnp.asarray(rgb), out_h, out_w))
        got = timage.resize_bilinear(torch.from_numpy(rgb), out_h, out_w).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)
    uint8 = np.random.default_rng(2).integers(0, 256, (33, 21, 3), dtype=np.uint8)
    np.testing.assert_allclose(timage.rotate_bound(torch.from_numpy(uint8), angle).numpy(),
                               np.asarray(jimage.rotate_bound(jnp.asarray(uint8), angle)),
                               atol=1e-4)


def test_profile_scores_against_jax():
    """The port's exact profile against JAX's f32 scatter on the same edge
    map: the scores agree to f32 rounding of the sums."""
    page = np.asarray(jimage.rotate_bound(jnp.asarray(text_page(300, 380)), 2.0))[:300, :380]
    binary = np.asarray(jimage.adaptive_threshold_gaussian(
        jimage.gaussian_blur(jnp.asarray(page), 5, 0.0), 11, 2.0))
    edges = np.asarray(jimage.edge_map(jnp.asarray(binary)))
    angles = np.linspace(-5, 5, 21).astype(np.float32)
    want = np.asarray(jskew._profile_sharpness(jnp.asarray(edges), jnp.asarray(angles)))
    got = tskew._profile_sharpness(torch.from_numpy(edges), torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.argmax(got) == np.argmax(want)


@pytest.mark.parametrize("true_angle", [-6.0, -2.5, 2.0, 5.0, 11.0])
def test_detect_skew_equals_jax_on_known_rotation(true_angle):
    rotated = np.asarray(jimage.rotate_bound(jnp.asarray(text_page(700, 900)), true_angle))
    want = jskew.detect_skew(rotated)
    got = tskew.detect_skew(rotated, device="cpu")
    assert got == want
    assert abs(got - (-true_angle)) < 0.3, (true_angle, got)


def test_detect_skew_clean_and_featureless_pages():
    page = text_page(700, 900)
    assert tskew.detect_skew(page, device="cpu") == jskew.detect_skew(page)
    rgb = np.repeat(page[..., None], 3, axis=2).astype(np.uint8)
    assert tskew.detect_skew(rgb, device="cpu") == jskew.detect_skew(rgb)
    flat = np.full((400, 400), 128.0, np.float32)
    assert tskew.detect_skew(flat, device="cpu") is None
    assert jskew.detect_skew(flat) is None


def test_detect_skew_needs_a_device_that_exists():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tskew.detect_skew(text_page(100, 100))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torient.OrientationCorrector()


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.lines = []

    def emit(self, record):
        if record.name == "mmtpu.orientation":
            self.lines.append((record.levelname, record.getMessage().split(" in ")[0]))


@pytest.mark.parametrize("with_cv2", [True, False])
def test_batch_correct_orientation_writes_the_jax_files(tmp_path, monkeypatch, with_cv2):
    if not with_cv2:
        monkeypatch.setattr(jimages, "cv2", None)
        monkeypatch.setitem(sys.modules, "cv2", None)
    src = tmp_path / "in"
    src.mkdir()
    page = text_page(500, 640)
    rotated = np.clip(np.asarray(jimage.rotate_bound(jnp.asarray(page), 4.0)), 0, 255)
    Image.fromarray(np.repeat(rotated[..., None], 3, 2).astype(np.uint8)).save(src / "a_rot.png")
    Image.fromarray(np.repeat(page[..., None], 3, 2).astype(np.uint8)).save(src / "b_clean.png")
    Image.fromarray(np.full((200, 200, 3), 128, np.uint8)).save(src / "c_flat.jpg")
    (src / "d_invalid.png").write_bytes(b"not an image")
    paths = sorted(str(p) for p in src.iterdir())
    logger = logging.getLogger("mmtpu")
    out = {}
    for name, run in (
        ("jax", lambda o: jorient.batch_correct_orientation(paths, o)),
        ("torch", lambda o: torient.batch_correct_orientation(paths, o, device="cpu")),
    ):
        records = _Records()
        logger.addHandler(records)
        results = run(str(tmp_path / name))
        logger.removeHandler(records)
        files = {p: open(tmp_path / name / p, "rb").read()
                 for p in sorted(os.listdir(tmp_path / name))}
        results = [{**dataclasses.asdict(r),
                    "output_path": r.output_path.replace(str(tmp_path / name), "OUT")}
                   for r in results]
        out[name] = (results, records.lines, files)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2].keys() == out["jax"][2].keys() == {"a_rot.png", "b_clean.png",
                                                               "c_flat.jpg"}
    for name, data in out["jax"][2].items():
        assert out["torch"][2][name] == data, name
    rotated_flags = [r["rotated"] for r in out["jax"][0]]
    assert rotated_flags == [True, False, False, False]


def test_tesseract_fallback_absent():
    assert torient.detect_skew_tesseract("whatever.png") is None
