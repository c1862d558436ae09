"""ViT tower and its transformer parts: PyTorch port against the JAX
modules in f32, same weights through the bridge.

The JAX attention takes the BLF Pallas kernel (interpret mode) at L=256,
as on the TPU; the port takes K1's plain version on the CPU. With
``MMTPU_ENC_ATTN_BLF=0`` both take the proj-BHLD route (a recorder shows
which K1 form each package called), and with ``MMTPU_ENC_ATTN_PROJ=0`` as
well the generic route through ``sdpa``. Tolerances
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


TEXT = dict(vocab_size=300, max_len=16, width=64, layers=2, heads=2)


def _text_inputs():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 300, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    mask[2, 1:] = 0
    return ids, mask


def test_text_tower():
    """The padding mask (one row of 9 tokens, one of 1), last-token pool,
    projection and L2 norm: 1e-5 absolute on unit vectors."""
    ids, mask = _text_inputs()
    jmod = jve.TextTower(jve.TextConfig(**TEXT), embed_dim=32)
    flat = flatten_params(unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                          jnp.asarray(mask))))
    rng = np.random.default_rng(6)
    for key, val in flat.items():
        if key.endswith(("/bias", "/scale")):
            flat[key] = (val + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
    want = jmod.apply(unflatten_params(flat), jnp.asarray(ids), jnp.asarray(mask))
    port = load_jax_params(tve.TextTower(tve.TextConfig(**TEXT), 32), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-6)


def test_dual_encoder():
    """Both towers and exp(logit_scale) of one bridged tree (every leaf of
    the JAX tree is used, or the bridge raises)."""
    cfg = jve.DualEncoderConfig(vision=jve.VisionConfig(**VIT), text=jve.TextConfig(**TEXT),
                                embed_dim=32)
    images = np.random.default_rng(4).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    ids, mask = _text_inputs()
    dual = jve.DualEncoder(cfg)
    args = (jnp.asarray(images), jnp.asarray(ids[:2]), jnp.asarray(mask[:2]))
    flat = flatten_params(unbox(dual.init(jax.random.PRNGKey(0), *args)))
    flat["params/logit_scale"] = np.array([2.5], np.float32)
    want = dual.apply(unflatten_params(flat), *args)
    port = load_jax_params(tve.DualEncoder(tve.DualEncoderConfig(
        vision=tve.VisionConfig(**VIT), text=tve.TextConfig(**TEXT), embed_dim=32)), flat)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (images, ids[:2], mask[:2])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(
            port.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
            np.asarray(dual.apply(unflatten_params(flat), jnp.asarray(ids), jnp.asarray(mask),
                                  method=dual.encode_text)), atol=1e-5)


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


# --- the proj-BHLD route (MMTPU_ENC_ATTN_BLF=0) ------------------------------


@pytest.fixture
def proj_route(monkeypatch):
    """Both packages off the BLF route and on proj-BHLD: JAX through
    ``MMTPU_ENC_ATTN_PROJ_INTERPRET=1`` (its ``_proj_bhld`` with the Pallas
    kernel in interpret mode), the port through ``MMTPU_ENC_ATTN_BLF=0``.
    Returns the calls each package made to K1's whole-row wrapper (True for
    the BHLD form), and to the BLF form of the port; JAX's calls include
    those of ``init``, so each of its calls shows twice."""
    from multimodal_embeddings_tpu.kernels import encoder_attention as jk1
    from multimodal_embeddings_tpu_torch.kernels import encoder_attention as tk1

    monkeypatch.delenv("MMTPU_ENC_ATTN_BLF_INTERPRET")
    monkeypatch.setenv("MMTPU_ENC_ATTN_PROJ_INTERPRET", "1")
    monkeypatch.setenv("MMTPU_ENC_ATTN_BLF", "0")
    calls = {"jax": [], "port": [], "port_blf": []}

    def recorder(side, real):
        def call(*args, **kwargs):
            calls[side].append(kwargs.get("bhld_inputs", False))
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(jk1, "encoder_attention", recorder("jax", jk1.encoder_attention))
    monkeypatch.setattr(ttr, "encoder_attention", recorder("port", tk1.encoder_attention))
    monkeypatch.setattr(ttr, "encoder_attention_blf",
                        recorder("port_blf", tk1.encoder_attention_blf))
    return calls


@pytest.mark.parametrize("heads", [2, 4])
def test_attention_proj_bhld(heads, proj_route):
    _compare(
        jtr.Attention(num_heads=heads, head_dim=64 // heads),
        ttr.Attention(64, heads, 64 // heads),
        _tokens((2, 256, 64)), atol=1e-5,
    )
    assert proj_route == {"jax": [True] * 2, "port": [True], "port_blf": []}


def test_vit_tower_proj_bhld(proj_route):
    """The small ViT (L = 256, 2 heads, 2 layers) with every block's
    attention on the proj-BHLD route in both packages."""
    images = np.random.default_rng(3).uniform(size=(2, 256, 256, 3)).astype(np.float32)
    port = tve.ViTower(tve.VisionConfig(**VIT), embed_dim=32)
    _compare(jve.ViTower(jve.VisionConfig(**VIT), embed_dim=32), port, images, atol=1e-5)
    layers = VIT["layers"]
    assert proj_route == {"jax": [True] * 2 * layers, "port": [True] * layers,
                          "port_blf": []}


def test_attention_sdpa_route(proj_route, monkeypatch):
    """``MMTPU_ENC_ATTN_PROJ=0`` too: the generic route through ``sdpa``
    (K1 in its (B, L, H, D) form at L = 256), against JAX's ``sdpa`` (the
    XLA path on the CPU)."""
    monkeypatch.delenv("MMTPU_ENC_ATTN_PROJ_INTERPRET")
    monkeypatch.setenv("MMTPU_ENC_ATTN_PROJ", "0")
    _compare(jtr.Attention(num_heads=2, head_dim=32), ttr.Attention(64, 2, 32),
             _tokens((2, 256, 64)), atol=1e-5)
    assert proj_route == {"jax": [], "port": [False], "port_blf": []}
