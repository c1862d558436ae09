"""ViT tower and its transformer parts: PyTorch port against the JAX
modules in f32, same weights through the bridge.

The JAX attention takes the BLF Pallas kernel (interpret mode) at L=256,
as on the TPU; the port takes K1's plain version on the CPU. Tolerances
are absolute, f32: the two frameworks sum in different orders."""

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models import vision_encoder as tve
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _blf_interpret(monkeypatch):
    monkeypatch.setenv("MMTPU_ENC_ATTN_BLF_INTERPRET", "1")


def _jax_flat(module, x, seed=0):
    """Init a JAX module, then give every bias/scale a random value so the
    bridge's handling of each parameter is visible in the outputs."""
    flat = flatten_params(unbox(module.init(jax.random.PRNGKey(seed), x)))
    rng = np.random.default_rng(seed)
    for key, val in flat.items():
        if key.endswith(("/bias", "/scale")):
            flat[key] = (val + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
    return flat


def _compare(jax_module, port_module, x_np, atol, prefix=""):
    x = jnp.asarray(x_np)
    flat = _jax_flat(jax_module, x)
    want = jax_module.apply(unflatten_params(flat), x)
    load_jax_params(port_module, flat, prefix)
    with torch.no_grad():
        got = port_module(torch.from_numpy(x_np))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_fast_layer_norm():
    # inputs with a large mean: the one-pass variance formula is what is ported
    x = _tokens((2, 16, 64)) + 3.0
    _compare(jtr.FastLayerNorm(), ttr.FastLayerNorm(64), x, atol=1e-5)


def test_gelu_mlp():
    _compare(jtr.GeluMLP(256), ttr.GeluMLP(64, 256), _tokens((2, 16, 64)), atol=1e-5)


@pytest.mark.parametrize("heads", [2, 4])
def test_attention_blf(heads):
    """L=256: the JAX module dispatches to encoder_attention_blf."""
    _compare(
        jtr.Attention(num_heads=heads, head_dim=64 // heads),
        ttr.Attention(64, heads, 64 // heads),
        _tokens((2, 256, 64)), atol=1e-5,
    )


def test_encoder_block():
    _compare(jtr.EncoderBlock(num_heads=2), ttr.EncoderBlock(64, 2), _tokens((2, 256, 64)),
             atol=2e-5)


VIT = dict(image_size=256, patch_size=16, width=64, layers=2, heads=2)


def test_vit_tower():
    """Unit-norm f32 embeddings: 1e-5 absolute is a cosine within 1e-9."""
    images = np.random.default_rng(3).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    port = tve.ViTower(tve.VisionConfig(**VIT), embed_dim=32)
    _compare(jve.ViTower(jve.VisionConfig(**VIT), embed_dim=32), port, images, atol=1e-5)
    norms = np.linalg.norm(port(torch.from_numpy(images)).detach().numpy(), axis=-1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-6)


def test_embedder_takes_the_dual_encoders_vision_scope():
    cfg = jve.DualEncoderConfig(vision=jve.VisionConfig(**VIT), embed_dim=32)
    images = np.random.default_rng(4).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    dual = jve.DualEncoder(cfg)
    tokens = jnp.zeros((1, cfg.text.max_len), jnp.int32)
    flat = flatten_params(unbox(dual.init(
        jax.random.PRNGKey(0), jnp.asarray(images[:1]), tokens, jnp.ones_like(tokens)
    )))
    want = dual.apply(unflatten_params(flat), jnp.asarray(images), method=dual.encode_image)
    port_cfg = tve.DualEncoderConfig(vision=tve.VisionConfig(**VIT), embed_dim=32)
    embedder = MultimodalEmbedder(
        EmbedderConfig(family="siglip", dtype="float32"), model_config=port_cfg,
        device="cpu", params=flat,
    )
    got = embedder.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_config_mirrors_jax():
    for cls in ("VisionConfig", "TextConfig", "DualEncoderConfig"):
        jcls, tcls = getattr(jve, cls), getattr(tve, cls)
        assert [f.name for f in jcls.__dataclass_fields__.values()] == [
            f.name for f in tcls.__dataclass_fields__.values()
        ]
    assert tve.DualEncoderConfig.base() == tve.DualEncoderConfig(
        vision=tve.VisionConfig(448, 16, 768, 12, 12), text=tve.TextConfig(), embed_dim=768
    )
