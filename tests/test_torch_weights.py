"""The parameter bridge between the JAX package and the port, and the
port's seeded init."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import layers as jl
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import qwen_vl as jqwen
from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.models import layers as tl
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import qwen_vl as tqwen
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models import vision_encoder as tve
from multimodal_embeddings_tpu_torch.models import yolo as tyolo
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.weights import (
    build_mme5,
    build_qwen,
    export_jax_params,
    init_random,
    load_jax_params,
)

torch.set_num_threads(2)


def _shapes(tree):
    if not isinstance(tree, dict) or "params" in tree:  # abstract JAX init
        tree = traverse_util.flatten_dict(unbox(tree), sep="/")
    return {k: tuple(v.shape) for k, v in tree.items()}


def _random_bn_flat(seed=0):
    """A JAX ConvBnAct(8, 3) over 4 channels with random BatchNorm."""
    x = jnp.zeros((1, 6, 6, 4))
    flat = flatten_params(unbox(jl.ConvBnAct(8, 3).init(jax.random.PRNGKey(seed), x)))
    rng = np.random.default_rng(seed)
    for key in flat:
        if key.endswith(("/var", "/scale")):
            flat[key] = rng.uniform(0.5, 1.5, flat[key].shape).astype(np.float32)
        elif key.endswith(("/mean", "/bias")):
            flat[key] = rng.normal(size=flat[key].shape).astype(np.float32)
    return flat


@pytest.mark.parametrize("glcrm", [True, False])
def test_detector_key_set_and_shapes_match_jax_m(glcrm):
    """The full m-scale detector: every JAX parameter has a port home of the
    converted shape (abstract JAX init: shapes only, no compute)."""
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="m", glcrm=glcrm)
    want = _shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    got = _shapes(export_jax_params(tyolo.DocLayoutYOLO(10, "m", glcrm=glcrm)))
    assert got == want


@pytest.mark.parametrize("mode", ["stage", "block"])
def test_kernel_route_detector_has_the_same_parameters(mode):
    """The K5 route (``pallas_convs``) changes no parameter: the JAX m-scale
    model with the route on and the port's, routed or not, have one key set
    and one set of shapes, and the bridge's round trip stays exact."""
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="m", glcrm=True, pallas_convs=96,
                                 pallas_mode=mode)
    want = _shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    routed = tyolo.DocLayoutYOLO(10, "m", glcrm=True, pallas_convs=96, pallas_mode=mode)
    assert len(routed.kernel_bias_names()) == 2 * (2 + 4)  # c2f_2 and c2f_3
    assert _shapes(export_jax_params(routed)) == want
    assert _shapes(export_jax_params(tyolo.DocLayoutYOLO(10, "m", glcrm=True))) == want
    cfg = DetectorConfig(image_size=64, variant="n", pallas_convs=64, pallas_mode=mode)
    first = LayoutDetector(cfg, dtype=torch.float32, device="cpu", seed=3).model
    second = LayoutDetector(cfg, dtype=torch.float32, device="cpu",
                            params=export_jax_params(first)).model
    for (name, a), (_, b) in zip(first.state_dict().items(), second.state_dict().items()):
        assert torch.equal(a, b), name


def test_vit_b_key_set_and_shapes_match_jax():
    cfg = dict(image_size=448, patch_size=16, width=768, layers=12, heads=12)
    jmodel = jve.ViTower(jve.VisionConfig(**cfg), embed_dim=768)
    want = _shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 448, 448, 3))))
    got = _shapes(export_jax_params(tve.ViTower(tve.VisionConfig(**cfg), 768)))
    assert got == want


def test_batchnorm_fold_formula():
    flat = _random_bn_flat()
    conv = load_jax_params(tl.ConvBnAct(4, 8, 3), flat)
    k = flat["params/conv/kernel"]  # HWIO
    g = flat["params/bn/scale"] / np.sqrt(flat["batch_stats/bn/var"] + np.float32(1e-3))
    np.testing.assert_array_equal(
        conv.conv.weight.detach().numpy(), np.transpose(k * g, (3, 2, 0, 1))
    )
    np.testing.assert_array_equal(
        conv.conv.bias.detach().numpy(),
        flat["params/bn/bias"] - flat["batch_stats/bn/mean"] * g,
    )


def test_attention_weights_reshape():
    x = jnp.zeros((1, 16, 64))
    flat = flatten_params(unbox(jtr.Attention(num_heads=4, head_dim=16).init(jax.random.PRNGKey(0), x)))
    port = load_jax_params(ttr.Attention(64, 4, 16), flat)
    np.testing.assert_array_equal(
        port.q.weight.detach().numpy(), flat["params/q/kernel"].reshape(64, 64)
    )
    np.testing.assert_array_equal(
        port.o.weight.detach().numpy(), flat["params/o/kernel"].reshape(64, 64)
    )


def test_round_trip_is_exact():
    """JAX → port → JAX (identity BatchNorm) → port reproduces every port
    parameter bit for bit, and the exported tree drives the JAX module to
    the same output (1e-5: the JAX BatchNorm multiplies by rsqrt(1+eps)·
    sqrt(1+eps), one or two roundings away from 1)."""
    flat = _random_bn_flat(1)
    first = load_jax_params(tl.ConvBnAct(4, 8, 3), flat)
    exported = export_jax_params(first)
    assert set(exported) == set(flat)
    second = load_jax_params(tl.ConvBnAct(4, 8, 3), exported)
    for a, b in zip(first.state_dict().values(), second.state_dict().values()):
        assert torch.equal(a, b)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 6, 6, 4)), jnp.float32)
    jmod = jl.ConvBnAct(8, 3)
    np.testing.assert_allclose(
        np.asarray(jmod.apply(unflatten_params(exported), x)),
        np.asarray(jmod.apply(unflatten_params(flat), x)), atol=1e-5,
    )


def test_bridge_refuses_mismatches():
    flat = _random_bn_flat()
    missing = {k: v for k, v in flat.items() if not k.endswith("bn/mean")}
    with pytest.raises(KeyError):
        load_jax_params(tl.ConvBnAct(4, 8, 3), missing)
    with pytest.raises(ValueError, match="unused"):
        load_jax_params(tl.ConvBnAct(4, 8, 3), {**flat, "params/extra/kernel": np.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(tl.ConvBnAct(4, 16, 3), flat)


def test_seeded_init_is_deterministic():
    def state(seed):
        model = init_random(tve.ViTower(tve.VisionConfig(64, 16, 32, 1, 2), 16), seed)
        return [t.clone() for t in model.state_dict().values()]

    a, b, c = state(0), state(0), state(1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_seeded_init_distributions():
    model = init_random(tl.ConvBnAct(64, 128, 3), 0)
    std = model.conv.weight.std().item()
    want = 1 / np.sqrt(64 * 9) / np.sqrt(1 + 1e-3)
    assert abs(std - want) < 0.05 * want
    assert torch.count_nonzero(model.conv.bias) == 0


def test_npz_checkpoint_and_engine_dtype(tmp_path):
    """The JAX package's .npz checkpoint format loads through
    ``DetectorConfig.weights_path``; the engine casts to its dtype and keeps
    convolution weights channels_last."""
    cfg = DetectorConfig(image_size=64, variant="n")
    flat = export_jax_params(LayoutDetector(cfg, dtype=torch.float32, device="cpu", seed=3).model)
    path = tmp_path / "det.npz"
    np.savez(path, **flat)
    from_path = LayoutDetector(
        DetectorConfig(image_size=64, variant="n", weights_path=str(path)),
        dtype=torch.bfloat16,
        device="cpu",
    )
    from_flat = LayoutDetector(cfg, dtype=torch.bfloat16, device="cpu", params=flat)
    for a, b in zip(from_path.model.parameters(), from_flat.model.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    w = from_flat.model.backbone.stem.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last)


def _mme5_full_width(quantize):
    """The 11B widths at a depth the test can trace: vision 2 local + 1
    global layers, text 2 layers with cross-attention at 1."""
    def cut(cfg):
        return dataclasses.replace(
            cfg,
            vision=dataclasses.replace(cfg.vision, layers=2, global_layers=1,
                                       intermediate_layers=(0, 1)),
            text=dataclasses.replace(cfg.text, layers=2, cross_attn_layers=(1,)),
            quantize=quantize,
        )
    return cut(jm.MllamaConfig.mme5_11b()), cut(tm.MllamaConfig.mme5_11b())


@pytest.mark.parametrize("quantize", [False, "int8-mixed", True])
def test_mme5_key_set_and_shapes_match_jax(quantize):
    """At the 11B widths: every JAX leaf has a port home of its JAX shape
    (abstract JAX init; the port on the meta device, read through the
    bridge's own shape rules)."""
    jcfg, tcfg = _mme5_full_width(quantize)
    ids = jnp.zeros((1, 8), jnp.int32)
    want = _shapes(jax.eval_shape(
        jm.MmE5Embedder(jcfg).init, jax.random.PRNGKey(0), ids, jnp.ones_like(ids),
        jnp.zeros((1, 1, 560, 560, 3)),
    ))
    with torch.device("meta"):
        port = tm.MmE5Embedder(tcfg)
    got = {}
    for name, mod in port.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, ttr.Dense) and pname == "weight":
                pname, shape = "kernel", mod.kernel_shape
            elif isinstance(mod, torch.nn.Conv2d):
                pname, shape = "kernel", tuple(p.shape[i] for i in (2, 3, 1, 0))
            got["/".join(["params", name.replace(".", "/"), pname])] = shape
    assert got == want


def test_mme5_round_trip_is_exact():
    """JAX tree (int8 leaves included) → port → JAX reproduces every leaf
    bit for bit, with its dtype."""
    cfg = dataclasses.replace(jm.MllamaConfig.tiny(), quantize="int8-mixed")
    ids = jnp.zeros((1, 8), jnp.int32)
    struct = jax.eval_shape(
        jm.MmE5Embedder(cfg).init, jax.random.PRNGKey(0), ids, jnp.ones_like(ids),
        jnp.zeros((1, 1, 28, 28, 3)),
    )
    rng = np.random.default_rng(0)
    flat = {
        key: rng.integers(-127, 128, leaf.shape).astype(np.int8) if leaf.dtype == np.int8
        else rng.normal(size=leaf.shape).astype(np.float32)
        for key, leaf in traverse_util.flatten_dict(unbox(struct), sep="/").items()
    }
    tcfg = dataclasses.replace(tm.MllamaConfig.tiny(), quantize="int8-mixed")
    port = build_mme5(tcfg, torch.float32, "cpu", params=flat)
    out = export_jax_params(port)
    assert set(out) == set(flat)
    for key, val in flat.items():
        assert out[key].dtype == val.dtype, key
        np.testing.assert_array_equal(out[key], val, err_msg=key)


@pytest.mark.parametrize("engine", ["detector", "siglip", "mme5"])
def test_engines_default_to_the_card(engine):
    """Built without a device, an engine goes to CUDA; where there is none
    it raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if engine == "detector":
            LayoutDetector(DetectorConfig(image_size=64, variant="n"))
        else:
            MultimodalEmbedder(EmbedderConfig(family=engine),
                               model_config=tm.MllamaConfig.tiny() if engine == "mme5" else None)


def _port_shapes(model):
    """The JAX-side key set of a port model on the meta device, read through
    the bridge's own shape rules."""
    got = {}
    for name, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            shape = tuple(p.shape)
            if isinstance(mod, ttr.Dense) and pname == "weight":
                pname, shape = "kernel", mod.kernel_shape
            elif isinstance(mod, torch.nn.Conv2d):
                pname, shape = "kernel", tuple(p.shape[i] for i in (2, 3, 1, 0))
            got["/".join(["params", name.replace(".", "/"), pname])] = shape
    return got


def _qwen_cut(cfg, quantize):
    """The 32B widths at a depth the test can trace: vision 2 layers with
    block 1 full attention, text 2 layers."""
    return dataclasses.replace(
        cfg, quantize=quantize,
        vision=dataclasses.replace(cfg.vision, layers=2, fullatt_block_indexes=(1,)),
        text=dataclasses.replace(cfg.text, layers=2),
    )


@pytest.mark.parametrize("quantize", [False, True, "int4"])
def test_qwen_32b_key_set_and_shapes_match_jax(quantize):
    jcfg = _qwen_cut(jqwen.QwenVLConfig.qwen25_vl_32b(), quantize)
    tcfg = _qwen_cut(tqwen.QwenVLConfig.qwen25_vl_32b(), quantize)
    ids = jnp.zeros((1, 8), jnp.int32)
    want = _shapes(jax.eval_shape(jqwen.QwenVLModel(jcfg).init, jax.random.PRNGKey(0), ids,
                                  jnp.zeros((1, 56, 56, 3))))
    with torch.device("meta"):
        port = tqwen.QwenVLModel(tcfg)
    assert _port_shapes(port) == want


@pytest.mark.parametrize("quantize", ["int4", True])
def test_qwen_round_trip_is_exact(quantize):
    """JAX tree (uint8 int4 nibbles or int8 leaves included) → port → JAX
    reproduces every leaf bit for bit, with its dtype."""
    cfg = dataclasses.replace(jqwen.QwenVLConfig.tiny(), quantize=quantize)
    struct = jax.eval_shape(jqwen.QwenVLModel(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 56, 56, 3)))
    rng = np.random.default_rng(0)

    def draw(leaf):
        if leaf.dtype == np.uint8:
            return rng.integers(0, 256, leaf.shape).astype(np.uint8)
        if leaf.dtype == np.int8:
            return rng.integers(-127, 128, leaf.shape).astype(np.int8)
        return rng.normal(size=leaf.shape).astype(np.float32)

    flat = {key: draw(leaf)
            for key, leaf in traverse_util.flatten_dict(unbox(struct), sep="/").items()}
    assert any(v.dtype == np.uint8 for v in flat.values()) == (quantize == "int4")
    tcfg = dataclasses.replace(tqwen.QwenVLConfig.tiny(), quantize=quantize)
    port = build_qwen(tcfg, torch.float32, "cpu", params=flat)
    out = export_jax_params(port)
    assert set(out) == set(flat)
    for key, val in flat.items():
        assert out[key].dtype == val.dtype, key
        np.testing.assert_array_equal(out[key], val, err_msg=key)


def test_qwen_qkv_flatten_order():
    """The fused vision qkv (C, 3, H, D): output column (s·H + h)·D + d,
    so the port's q/k/v views are the JAX ``qkv[..., s, :, :]``."""
    cfg = tqwen.QwenVLConfig.tiny()
    tower = jqwen.QwenVisionTower(jqwen.QwenVLConfig.tiny().vision, 64)
    flat = flatten_params(unbox(tower.init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))))
    port = load_jax_params(tqwen.QwenVisionTower(cfg.vision, 64, torch.float32).float(), flat)
    kernel = flat["params/qkv_0/kernel"]  # (32, 3, 2, 16)
    w = port.qkv_0.weight.detach().numpy()
    np.testing.assert_array_equal(w[:, (1 * 2 + 1) * 16 : (1 * 2 + 1) * 16 + 16], kernel[:, 1, 1])
    assert port.qkv_0.bias.shape == (3, 2, 16)


# -- checkpoints: .safetensors and .npz, read and written as JAX does ---------

from multimodal_embeddings_tpu.models import detector as jdetector  # noqa: E402
from multimodal_embeddings_tpu.models import embedder as jembedder  # noqa: E402
from multimodal_embeddings_tpu.models import weights as jweights  # noqa: E402
from multimodal_embeddings_tpu_torch.models import weights as tweights  # noqa: E402


def _det_flat(seed=3):
    """A tiny detector's parameters in the JAX layout (the port's seeded init
    with random BatchNorm, so the fold is not the identity)."""
    cfg = DetectorConfig(image_size=64, variant="n")
    flat = export_jax_params(LayoutDetector(cfg, dtype=torch.float32, device="cpu", seed=seed).model)
    rng = np.random.default_rng(seed)
    for key, val in flat.items():
        if key.endswith(("bn/var", "bn/scale")):
            flat[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key.endswith(("bn/mean", "bn/bias")):
            flat[key] = rng.normal(scale=0.2, size=val.shape).astype(np.float32)
    return flat


def _pages(n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(90, 70, 3), dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def det_safetensors(tmp_path_factory):
    """A JAX-written ``.safetensors`` of a tiny detector (JAX's
    ``save_checkpoint_safetensors``) and the JAX detector loaded from it."""
    path = str(tmp_path_factory.mktemp("st") / "det.safetensors")
    jweights.save_checkpoint_safetensors(unflatten_params(_det_flat()), path)
    jdet = jdetector.LayoutDetector(
        jdetector.DetectorConfig(image_size=64, variant="n", weights_path=path),
        dtype=jnp.float32,
    )
    return path, jdet


def test_safetensors_checkpoint_detector_equals_jax(det_safetensors):
    """The repair: a JAX-written ``.safetensors`` loads into the port's
    detector (``DetectorConfig.weights_path``) as into JAX's, with the same
    detections (f32 on both: boxes within 1e-3 px, scores within 1e-5,
    classes equal; head maps within 1e-4)."""
    path, jdet = det_safetensors
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n", weights_path=path),
                         dtype=torch.float32, device="cpu")
    pages = _pages()
    want, got = jdet.detect_batch(pages), det.detect_batch(pages)
    assert len(got) == len(want) == 2
    assert sum(len(c) for _, c, _ in want) > 0
    for (gb, gc, gs), (wb, wc, ws) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_allclose(gb, wb, atol=1e-3)
        np.testing.assert_allclose(gs, ws, atol=1e-5)
    x = np.random.default_rng(1).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    wmaps = jdet.model.apply(jdet.variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        gmaps = det.model(torch.from_numpy(x))
    for g, w in zip(jax.tree.leaves(gmaps), jax.tree.leaves(wmaps)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_safetensors_checkpoint_mme5_engine_equals_jax(tmp_path, monkeypatch):
    """The repair for the mmE5 engine: one JAX-written ``.safetensors`` of
    the tiny model, loaded by both engines, gives the same image
    embeddings (f32, within 2e-5). The JAX engine is handed an unboxed init,
    which its loader needs."""
    cfg = tm.MllamaConfig.tiny()
    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                              model_config=cfg, device="cpu", seed=4)
    path = str(tmp_path / "mme5.safetensors")
    jweights.save_checkpoint_safetensors(unflatten_params(export_jax_params(port.model)), path)
    init = jembedder.deterministic_init_multi
    monkeypatch.setattr(jembedder, "deterministic_init_multi",
                        lambda model, args, seed=0: unbox(init(model, args, seed)))
    jcfg = jembedder.EmbedderConfig(family="mme5", dtype="float32", weights_path=path)
    jemb = jembedder.MultimodalEmbedder(jcfg, model_config=jm.MllamaConfig.tiny())
    temb = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32", weights_path=path),
                              model_config=cfg, device="cpu")
    images = [np.random.default_rng(s).integers(0, 256, (40, 30, 3), dtype=np.uint8)
              for s in range(2)]
    want, got = jemb.get_image_embeddings(images), temb.get_image_embeddings(images)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5)


def test_safetensors_checkpoint_parse_cli_equals_jax(tmp_path, monkeypatch):
    """The repair for ``cli/parse.py --weights x.safetensors``: both CLIs on
    one JAX-written file write byte-identical HTML and index. (The JAX CLI's
    shape target comes from ``jax.eval_shape``, which its loader cannot
    flatten; the test hands it a concrete init, as the ``.npz`` test does.)"""
    import os

    from PIL import Image

    from multimodal_embeddings_tpu.cli import parse as jcli
    from multimodal_embeddings_tpu_torch.cli import parse as tcli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax, "eval_shape", lambda fn, *args: fn(*args))
    model = build_qwen(tqwen.QwenVLConfig.tiny(), torch.float32, "cpu", seed=2)
    flat = export_jax_params(model)
    rng = np.random.default_rng(2)
    for key, val in flat.items():  # decisive logits
        scale = 0.5 if key.endswith(("/scale", "/bias")) else 0.1
        flat[key] = (val + rng.normal(scale=scale, size=val.shape)).astype(np.float32)
    jweights.save_checkpoint_safetensors(unflatten_params(flat), "tiny.safetensors")
    os.makedirs("pages")
    for i, (w, h) in enumerate([(120, 90), (90, 120)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(f"pages/d{i}.png")
    base = ["--input_folder", "pages", "--size", "tiny", "--weights", "tiny.safetensors",
            "--max_new_tokens", "8"]
    assert jcli.main([*base, "--output_folder", "out_jax"]) == 0
    assert tcli.main([*base, "--output_folder", "out_port", "--device", "cpu"]) == 0
    names = sorted(os.listdir("out_jax"))
    assert names == sorted(os.listdir("out_port")) and len(names) == 5
    for name in names:
        assert open(f"out_port/{name}", "rb").read() == open(f"out_jax/{name}", "rb").read()


def _typed_tree():
    rng = np.random.default_rng(5)
    return {
        "params": {
            "a": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                  "bias": rng.normal(size=(4,)).astype(jnp.bfloat16)},
            "q": {"kernel_q": rng.integers(-127, 128, (4, 6), dtype=np.int8),
                  "kernel_q4": rng.integers(0, 256, (2, 6), dtype=np.uint8),
                  "kernel_scale": rng.uniform(size=(1, 6)).astype(np.float16)},
            "n": {"ids": np.arange(5, dtype=np.int32), "big": np.arange(3, dtype=np.int64),
                  "d": rng.normal(size=(2, 2)), "flag": np.array([True, False]),
                  "scalar": np.float32(0.5)},
        }
    }


def test_safetensors_reader_equals_the_library(tmp_path):
    """The port's own reader gives what ``safetensors.numpy.load_file``
    gives on a JAX-written file, for every dtype in it (bf16 widened to f32
    exactly); a dtype it does not take raises."""
    from safetensors.numpy import load_file

    path = str(tmp_path / "t.safetensors")
    jweights.save_checkpoint_safetensors(_typed_tree(), path)
    want, got = load_file(path), tweights.load_safetensors(path)
    assert sorted(got) == sorted(want)
    for key in want:
        w = want[key]
        if w.dtype == jnp.bfloat16:
            assert got[key].dtype == np.float32
            w = w.astype(np.float32)
        else:
            assert got[key].dtype == w.dtype, key
        assert got[key].shape == w.shape
        np.testing.assert_array_equal(got[key], w)
    header = b'{"x":{"dtype":"F8_E4M3","shape":[1],"data_offsets":[0,1]}}'
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(len(header).to_bytes(8, "little") + header + b"\0")
    with pytest.raises(ValueError, match="F8_E4M3"):
        tweights.load_safetensors(str(bad))


@pytest.mark.parametrize("fmt", ["npz", "safetensors"])
def test_port_writer_is_read_by_jax(tmp_path, fmt):
    """``save_checkpoint`` / ``save_checkpoint_safetensors`` of a port module
    are read by JAX's ``load_checkpoint`` (shape-validated against the JAX
    tree) and by the port's, as ``export_jax_params`` gives them."""
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu", seed=6)
    flat = export_jax_params(det.model)
    path = str(tmp_path / f"det.{fmt}")
    save = tweights.save_checkpoint if fmt == "npz" else tweights.save_checkpoint_safetensors
    save(det.model, path)
    target = unflatten_params({k: np.zeros_like(v) for k, v in flat.items()})
    loaded = flatten_params(jweights.load_checkpoint(path, target))
    port = tweights.load_checkpoint(path)
    assert sorted(loaded) == sorted(port) == sorted(flat)
    for key, val in flat.items():
        np.testing.assert_array_equal(np.asarray(loaded[key]), val)
        np.testing.assert_array_equal(port[key], val)


def test_missing_tensor_raises_extra_tensor_warns(tmp_path, monkeypatch):
    """JAX's rules: a tensor the model needs and the file lacks raises; a
    tensor the model lacks is logged as unused and dropped before the
    (strict) bridge."""
    flat = _det_flat(seed=7)
    missing = dict(flat)
    del missing["params/backbone/stem/conv/kernel"]
    tweights.save_safetensors(missing, str(tmp_path / "missing.safetensors"))
    with pytest.raises(KeyError, match="backbone/stem/conv/kernel"):
        LayoutDetector(DetectorConfig(image_size=64, variant="n",
                                      weights_path=str(tmp_path / "missing.safetensors")),
                       dtype=torch.float32, device="cpu")
    warnings = []
    monkeypatch.setattr(tweights.logger, "warning", lambda *a: warnings.append(a))
    extra = dict(flat, **{"params/not_in_model/kernel": np.ones(3, np.float32)})
    np.savez(tmp_path / "extra.npz", **extra)
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n",
                                        weights_path=str(tmp_path / "extra.npz")),
                         dtype=torch.float32, device="cpu")
    assert len(warnings) == 1 and warnings[0][1] == 1
    ref = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu", params=flat)
    for a, b in zip(det.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unused"):  # the bridge itself stays strict
        load_jax_params(ref.model, extra)


@pytest.mark.parametrize("quantize", [False, "int8-mixed", "int4"])
def test_jax_param_keys_is_the_export_key_set(quantize):
    """``jax_param_keys`` lists the bridge's keys without touching a value:
    the export's key set, plus a float ``kernel`` at each quantized site."""
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu")
    assert tweights.jax_param_keys(det.model) == set(export_jax_params(det.model))
    model = build_mme5(dataclasses.replace(tm.MllamaConfig.tiny(), quantize=quantize),
                       torch.float32, "cpu")
    keys, exported = tweights.jax_param_keys(model), set(export_jax_params(model))
    extra = keys - exported
    assert exported <= keys
    assert all(k.endswith("/kernel") for k in extra)
    assert bool(extra) == bool(quantize)
