"""The engine's host side and its load path: the port against the JAX
package in f32 on the CPU.

* ``quantize_dense_tree`` on a tiny float mmE5 tree: the int8 and packed
  int4 values and the scales EQUAL to JAX's (both quantize in f32 with round
  half to even);
* the tiny mmE5 model loaded from a float ``.npz`` with ``quantize`` set,
  against the JAX engine given the same ``weights_path``;
* ``get_image_embeddings`` (siglip; mme5 images of 1, 2 and 4 tiles; a path
  that does not exist) and ``get_text_embeddings`` (one string, a list)
  against the JAX engine on the same bridged tree;
* the host copies (``preprocess_image`` and its helpers,
  ``resize_image_if_needed``) equal to JAX's, bit for bit.

Embeddings are unit vectors compared at 1e-5 absolute: the frameworks sum
in different orders. JAX's int4 projections run its Pallas kernel in
interpret mode, which rounds x to bf16 as K3's plain version does."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox
from PIL import Image

import jax.numpy as jnp

from multimodal_embeddings_tpu.config import EmbedderConfig as JEmbedderConfig
from multimodal_embeddings_tpu.io import images as jimages
from multimodal_embeddings_tpu.kernels import quantization_int4 as jq4
from multimodal_embeddings_tpu.models import mllama_processor as jproc
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu.models import embedder as jembedder
from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models.embedder import MultimodalEmbedder as JEmbedder
from multimodal_embeddings_tpu.models.weights import (
    flatten_params,
    save_checkpoint,
    unflatten_params,
)
from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.io import images as timages
from multimodal_embeddings_tpu_torch.models import mllama_processor as tproc
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import vision_encoder as tve
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.quantized import quantize_dense_tree
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params

torch.set_num_threads(2)

_jax_init = jembedder.deterministic_init_multi
GATES = ("/gate", "/gate_attn", "/gate_ffn", "/attn_gate", "/mlp_gate")
STORAGES = [True, "int4", "int8-mixed", "int4-mixed"]


def _interpret_int4_apply(x, qt, use_kernel=None):
    lead = x.shape[:-1]
    y = jq4.int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale, interpret=True)
    return y.reshape(*lead, qt.packed.shape[-1])


@pytest.fixture(autouse=True)
def _jax_int4_kernel(monkeypatch):
    monkeypatch.setattr(jquant, "int4_apply", _interpret_int4_apply)


def _randomized(flat, seed=0):
    """Every leaf that init leaves trivial made random: gates (0 at init
    would hide a whole branch), norm scales and biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        val = np.asarray(val, np.float32)
        if key.endswith(GATES):
            val = rng.uniform(0.2, 0.8, size=val.shape).astype(np.float32)
        elif key.endswith(("/scale", "/bias")):
            val = (val + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
        out[key] = val
    return out


@pytest.fixture(scope="module")
def float_tree():
    """The tiny float mmE5 tree, as the JAX engine's init makes it, with
    its trivial leaves randomized."""
    jemb = JEmbedder(JEmbedderConfig(family="mme5", dtype="float32"),
                     model_config=jm.MllamaConfig.tiny())
    return _randomized(flatten_params(jemb.variables))


@pytest.mark.parametrize("quantize", STORAGES)
def test_quantize_dense_tree_equals_jax(float_tree, quantize):
    cfg = dataclasses.replace(jm.MllamaConfig.tiny(), quantize=quantize)
    jmodel = jm.MmE5Embedder(cfg)
    tiles, ids = jnp.zeros((1, 4, 28, 28, 3)), jnp.zeros((1, 32), jnp.int32)
    target = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), ids, ids + 1, tiles,
                                                jnp.ones((1,), jnp.int32),
                                                jnp.ones((1, 4), jnp.int32)))
    src = unflatten_params(float_tree)["params"]
    want = flatten_params({"params": jquant.quantize_dense_tree(src, unbox(target)["params"])})
    with torch.device("meta"):
        port = tm.MmE5Embedder(dataclasses.replace(tm.MllamaConfig.tiny(), quantize=quantize))
    got = quantize_dense_tree(float_tree, port, device="cpu")
    assert sorted(got) == sorted(want)
    quantized = [k for k in got if k.endswith(("kernel_q", "kernel_q4"))]
    assert quantized
    for key in got:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)


@pytest.mark.parametrize("quantize", ["int8-mixed", "int4"])
def test_float_npz_loads_quantized(float_tree, quantize, tmp_path, monkeypatch):
    """The tiny model built from a float ``.npz`` with ``quantize`` set
    (quantized at load), against the JAX engine on the same file.

    The JAX engine hands ``load_checkpoint`` its float twin's variables
    still boxed (``LogicallyPartitioned`` leaves, which ``flatten_params``
    turns into 0-d object arrays, so no ``.npz`` matches their shapes); the
    test unboxes the twin's init for it.

    Tolerance: 1e-5 for int8-mixed. The int4 projections round x to bf16
    on both sides, so a last-bit f32 difference upstream can move one x
    across a bf16 rounding boundary, a step of 2^-8 of that x in its
    product; on the 4-tile image (every tower layer int4 over 32 tokens)
    that reached 3.0e-4 of a unit vector, so int4 is held at 1e-3 and
    every quantized leaf of the two engines is compared EQUAL."""
    monkeypatch.setattr(jembedder, "deterministic_init_multi",
                        lambda model, args, seed=0: unbox(_jax_init(model, args, seed)))
    path = str(tmp_path / "mme5_float.npz")
    save_checkpoint(unflatten_params(float_tree), path)
    cfg = dict(family="mme5", dtype="float32", quantize=quantize, weights_path=path)
    jemb = JEmbedder(JEmbedderConfig(**cfg), model_config=jm.MllamaConfig.tiny())
    port = MultimodalEmbedder(EmbedderConfig(**cfg), model_config=tm.MllamaConfig.tiny(),
                              device="cpu")
    kind = "Int4Dense" if quantize == "int4" else "Int8Dense"
    assert type(port.model.text_model.layer0.mlp.gate).__name__ == kind
    jflat = flatten_params(jemb.variables)
    pflat = export_jax_params(port.model)
    stored = [k for k in jflat if k.endswith(("kernel_q", "kernel_q4", "kernel_scale"))]
    assert stored and sorted(jflat) == sorted(pflat)
    for key in stored:
        np.testing.assert_array_equal(pflat[key], np.asarray(jflat[key]), err_msg=key)
    images = _tile_images()
    got = port.get_image_embeddings(images, batch_size=2)
    want = jemb.get_image_embeddings(images, batch_size=2)
    np.testing.assert_allclose(np.array(got), np.array(want),
                               atol=1e-3 if quantize == "int4" else 1e-5)


def _tile_images():
    """uint8 images the 28-px tiler puts on 1, 2 (1 wide, 2 high) and 4
    (2 × 2) tiles."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, 256, size=shape, dtype=np.uint8)
            for shape in ((28, 28, 3), (56, 28, 3), (50, 60, 3))]


def test_tile_counts_of_the_test_images():
    got = [tproc.preprocess_image(im, max_tiles=4, tile_size=28).num_tiles
           for im in _tile_images()]
    assert got == [1, 2, 4]


@pytest.fixture(scope="module")
def mme5_engines(float_tree):
    jemb = JEmbedder(JEmbedderConfig(family="mme5", dtype="float32", batch_size=2),
                     model_config=jm.MllamaConfig.tiny())
    jemb.variables = unflatten_params(float_tree)
    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32", batch_size=2),
                              model_config=tm.MllamaConfig.tiny(), device="cpu",
                              params=float_tree)
    return jemb, port


TEXT = dict(vocab_size=300, max_len=16, width=64, layers=2, heads=2)
VIT = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2)


@pytest.fixture(scope="module")
def siglip_engines():
    cfg = dict(vision=VIT, text=TEXT, embed_dim=32)
    jemb = JEmbedder(JEmbedderConfig(family="siglip", dtype="float32", batch_size=2),
                     model_config=jve.DualEncoderConfig(
                         vision=jve.VisionConfig(**cfg["vision"]),
                         text=jve.TextConfig(**cfg["text"]), embed_dim=32))
    flat = _randomized(flatten_params(jemb.variables), seed=1)
    jemb.variables = unflatten_params(flat)
    port = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32", batch_size=2),
        model_config=tve.DualEncoderConfig(vision=tve.VisionConfig(**cfg["vision"]),
                                           text=tve.TextConfig(**cfg["text"]), embed_dim=32),
        device="cpu", params=flat)
    return jemb, port


@pytest.fixture(params=["siglip", "mme5"])
def engines(request):
    return request.getfixturevalue(f"{request.param}_engines")


def test_get_image_embeddings_matches_jax(engines, tmp_path):
    """Arrays of 1, 2 and 4 tiles, a PNG path and a path that does not exist
    (None in its slot), over batches of 2."""
    jemb, port = engines
    png = str(tmp_path / "page.png")
    Image.fromarray(_tile_images()[2]).save(png)
    images = _tile_images() + [png, str(tmp_path / "missing.png")]
    got = port.get_image_embeddings(images)
    want = jemb.get_image_embeddings(images)
    assert got[-1] is None and want[-1] is None
    assert all(isinstance(v, float) for v in got[0])
    np.testing.assert_allclose(np.array(got[:-1]), np.array(want[:-1]), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(np.array(got[:-1]), axis=-1), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got[2], got[3])  # the array and its PNG


def test_get_text_embeddings_matches_jax(engines):
    jemb, port = engines
    one = port.get_text_embeddings("a caption")
    assert isinstance(one, list) and isinstance(one[0], float)
    np.testing.assert_allclose(one, jemb.get_text_embeddings("a caption"), atol=1e-5)
    texts = ["naïve ünïcode", "", "a longer caption than the others"]
    got = port.get_text_embeddings(texts)
    assert len(got) == 3
    np.testing.assert_allclose(np.array(got), np.array(jemb.get_text_embeddings(texts)),
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(28, 28), (56, 28), (28, 90), (50, 60), (300, 17), (5, 5)])
@pytest.mark.parametrize("max_tiles", [1, 4])
def test_preprocess_image_equals_jax(hw, max_tiles):
    image = np.random.default_rng(hw[0] * hw[1]).integers(0, 256, size=(*hw, 3),
                                                           dtype=np.uint8)
    got = tproc.preprocess_image(image, max_tiles=max_tiles, tile_size=28)
    want = jproc.preprocess_image(image, max_tiles=max_tiles, tile_size=28)
    np.testing.assert_array_equal(got.tiles, want.tiles)
    np.testing.assert_array_equal(got.tile_mask, want.tile_mask)
    assert (got.aspect_ratio_id, got.num_tiles, got.aspect_ratio) == (
        want.aspect_ratio_id, want.num_tiles, want.aspect_ratio)
    h, w = hw
    assert tproc.get_optimal_tiled_canvas(h, w, max_tiles, 28) == \
        jproc.get_optimal_tiled_canvas(h, w, max_tiles, 28)
    assert tproc.get_image_size_fit_to_canvas(h, w, 56, 28, 28) == \
        jproc.get_image_size_fit_to_canvas(h, w, 56, 28, 28)


def test_preprocess_image_of_a_gray_image_equals_jax():
    image = np.random.default_rng(2).integers(0, 256, size=(40, 30), dtype=np.uint8)
    np.testing.assert_array_equal(tproc.preprocess_image(image, tile_size=28).tiles,
                                  jproc.preprocess_image(image, tile_size=28).tiles)


@pytest.mark.parametrize("size,max_dim", [((120, 80), 50), ((40, 90), 60), ((30, 20), 50)])
def test_resize_image_if_needed_equals_jax(size, max_dim):
    img = Image.fromarray(
        np.random.default_rng(size[0]).integers(0, 256, size=(size[1], size[0], 3),
                                                dtype=np.uint8))
    got = timages.resize_image_if_needed(img, max_dim)
    want = jimages.resize_image_if_needed(img, max_dim)
    assert got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_engine_takes_a_tokenizer():
    class Upper:
        def encode_batch(self, texts, max_len, add_image_token=False):
            from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer

            return ByteTokenizer().encode_batch([t.upper() for t in texts], max_len)

    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                              model_config=tm.MllamaConfig.tiny(), device="cpu",
                              tokenizer=Upper())
    default = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                                 model_config=tm.MllamaConfig.tiny(), device="cpu")
    np.testing.assert_array_equal(port.get_text_embeddings("abc"),
                                  default.get_text_embeddings("ABC"))


# -- MultimodalEmbedder(mesh=) over gloo ranks --------------------------------
#
# JAX's tests/test_embedder.py:141 (siglip on a mesh) and :161 (tiny mmE5
# tensor-parallel): one spawn of 4 gloo ranks runs the port's engine on
# (4, 1), (2, 2) and (1, 2) meshes. The mmE5 runs take the parameters of the
# JAX engine on its (4, 2) mesh (trivial leaves randomized, re-placed on
# JAX's shardings) and are held to it within 2e-5 (JAX's own bound against
# its unsharded engine); the siglip runs take ``siglip_engines``' tree and
# are held to its JAX engine; every run to the port's unsharded engine.

TP_ATOL = 2e-5


def _jax_on_mesh(config, model_config, devices8, seed):
    """The JAX engine on a (4, 2) mesh with its trivial leaves randomized
    (kept on their shardings); returns it and its flat parameters."""
    from multimodal_embeddings_tpu.config import MeshConfig as JMeshConfig
    from multimodal_embeddings_tpu.core.mesh import make_mesh as jmake_mesh

    jemb = JEmbedder(config, mesh=jmake_mesh(JMeshConfig(shape=(4, 2)), devices=devices8),
                     model_config=model_config)
    flat = _randomized(flatten_params(jemb.variables), seed=seed)
    jemb.variables = jax.tree.map(lambda old, new: jax.device_put(new, old.sharding),
                                  jemb.variables, unflatten_params(flat))
    return jemb, flat


def _mesh_images(n):
    rng = np.random.default_rng(7)
    shapes = ((28, 28, 3), (56, 28, 3), (50, 60, 3), (40, 40, 3))
    return [rng.integers(0, 256, size=shapes[i % 4], dtype=np.uint8) for i in range(n)]


@pytest.fixture(scope="module")
def mesh_engines(devices8, siglip_engines):
    """The siglip runs are held to ``siglip_engines``' JAX engine (the same
    randomized tree: JAX's own test holds its sharded engine to it), the
    mmE5 runs to JAX's engine on its (4, 2) mesh."""
    from multimodal_embeddings_tpu_torch.core.mesh import launch
    from multimodal_embeddings_tpu_torch.parallel import dryrun

    sig_cfg = dict(vision=VIT, text=TEXT, embed_dim=32)
    jsig = siglip_engines[0]
    sig_flat = flatten_params(jsig.variables)
    jmme5, mme5_flat = _jax_on_mesh(JEmbedderConfig(family="mme5", dtype="float32"),
                                    jm.MllamaConfig.tiny(), devices8, seed=0)
    sig_model = tve.DualEncoderConfig(vision=tve.VisionConfig(**sig_cfg["vision"]),
                                      text=tve.TextConfig(**sig_cfg["text"]), embed_dim=32)
    sig = (EmbedderConfig(family="siglip", dtype="float32"), sig_model, _mesh_images(8), 8,
           sig_flat)
    mme5 = (EmbedderConfig(family="mme5", dtype="float32"), tm.MllamaConfig.tiny(),
            _mesh_images(4), 4, mme5_flat)
    runs = {"siglip (4, 1)": ((4, 1), sig), "siglip (2, 2)": ((2, 2), sig),
            "mme5 (1, 2)": ((1, 2), mme5), "mme5 (2, 2)": ((2, 2), mme5)}
    cases = [("embedder_case", dict(shape=shape, config=c, model_config=mc, images=imgs,
                                    batch_size=bs, params=flat))
             for shape, (c, mc, imgs, bs, flat) in runs.values()]
    results = launch(dryrun.run_cases, 4, cases, device="cpu", timeout=300)
    out = {}
    for name, got in zip(runs, results[0]):
        _, (c, mc, imgs, bs, flat) = runs[name]
        jemb = jsig if name.startswith("siglip") else jmme5
        single = MultimodalEmbedder(c, model_config=mc, device="cpu", params=flat)
        out[name] = (got, np.asarray(jemb.get_image_embeddings(imgs, batch_size=bs)),
                     np.asarray(single.get_image_embeddings(imgs, batch_size=bs)))
    # every rank of a mesh returns the whole list
    np.testing.assert_array_equal(results[3][1], results[0][1])
    return out


@pytest.mark.parametrize("name", ["siglip (4, 1)", "siglip (2, 2)", "mme5 (1, 2)",
                                  "mme5 (2, 2)"])
def test_embedder_on_a_mesh_matches_jax_and_single(mesh_engines, name):
    got, want, single = mesh_engines[name]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TP_ATOL, rtol=0)
    np.testing.assert_allclose(got, single, atol=TP_ATOL, rtol=0)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_engine_refuses_a_mesh_as_jax_does(devices8, quantize):
    from multimodal_embeddings_tpu.config import MeshConfig as JMeshConfig
    from multimodal_embeddings_tpu.core.mesh import make_mesh as jmake_mesh

    with pytest.raises(ValueError) as jerr:
        JEmbedder(JEmbedderConfig(family="mme5", dtype="float32", quantize=quantize),
                  mesh=jmake_mesh(JMeshConfig(shape=(4, 2)), devices=devices8),
                  model_config=jm.MllamaConfig.tiny())
    with pytest.raises(ValueError) as terr:
        # the refusal comes before the mesh is used
        MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32", quantize=quantize),
                           model_config=tm.MllamaConfig.tiny(), device="cpu", mesh=object())
    assert str(terr.value) == str(jerr.value)
