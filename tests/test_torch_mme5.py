"""The mmE5 model: the port's Mllama modules against the JAX package's, in
f32 on the CPU, same weights through the bridge.

JAX runs these modules on the CPU as its own tests do: the vision tower's
key prefix becomes a boolean mask on the XLA path, and int8 projections
dequantize; the port takes K1's and K2's plain versions. The int4 forms run
JAX's int4 projections through its Pallas kernel in interpret mode
(``int4_apply`` patched, as ``test_torch_qwen_vl.py`` does), which rounds x
to bf16 as K3's plain version does. Tolerances are absolute, f32: the
frameworks sum in different orders (the quantized forms also multiply the
scale in after the sum instead of before)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import quantization_int4 as jq4
from multimodal_embeddings_tpu.models import mllama_processor as jproc
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu.models import tokenizer as jtok
from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.models import mllama_processor as tproc
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import tokenizer as ttok
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)

GATES = ("/gate", "/gate_attn", "/gate_ffn", "/attn_gate", "/mlp_gate")


def _randomize(flat, seed):
    """Give every leaf that init leaves trivial a random value: int8
    kernels and their scales, gates (0 at init would hide a whole branch),
    norm scales and biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        if key.endswith("kernel_q"):
            val = rng.integers(-127, 128, size=val.shape).astype(np.int8)
        elif key.endswith("kernel_q4"):
            val = rng.integers(0, 256, size=val.shape).astype(np.uint8)
        elif key.endswith("kernel_scale"):
            val = (rng.uniform(0.5, 1.5, size=val.shape) * 0.02 / 127).astype(np.float32)
        elif key.endswith(GATES):
            val = rng.uniform(0.2, 0.8, size=val.shape).astype(np.float32)
        elif key.endswith(("/scale", "/bias")):
            val = (np.asarray(val) + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
        out[key] = np.asarray(val)
    return out


def _jax_flat(module, *args, seed=0, **kwargs):
    flat = flatten_params(unbox(module.init(jax.random.PRNGKey(seed), *args, **kwargs)))
    return _randomize(flat, seed)


def _interpret_int4_apply(x, qt, use_kernel=None):
    lead = x.shape[:-1]
    y = jq4.int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale, interpret=True)
    return y.reshape(*lead, qt.packed.shape[-1])


@pytest.fixture
def jax_int4_kernel(monkeypatch):
    """JAX's int4 projections on its Pallas kernel in interpret mode."""
    monkeypatch.setattr(jquant, "int4_apply", _interpret_int4_apply)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _compare(jax_module, port_module, args, atol=1e-5, **kwargs):
    jargs = [jnp.asarray(a) for a in args]
    flat = _jax_flat(jax_module, *jargs, **kwargs)
    want = jax_module.apply(unflatten_params(flat), *jargs, **kwargs)
    load_jax_params(port_module, flat)
    with torch.no_grad():
        got = port_module(*(torch.from_numpy(np.asarray(a)) for a in args), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_copies_equal_the_originals():
    """ByteTokenizer, the CLIP constants and the aspect-ratio ids."""
    texts = [EmbedderConfig().prompt, "naïve ünïcode", ""]
    for add_image in (False, True):
        for got, want in zip(ttok.ByteTokenizer().encode_batch(texts, 32, add_image),
                             jtok.ByteTokenizer().encode_batch(texts, 32, add_image)):
            np.testing.assert_array_equal(got, want)
    assert (tproc.IMAGE_MEAN, tproc.IMAGE_STD) == (jproc.IMAGE_MEAN, jproc.IMAGE_STD)
    for tiles in (1, 2, 4, 6):
        assert tproc.get_all_supported_aspect_ratios(tiles) == \
            jproc.get_all_supported_aspect_ratios(tiles)
        assert tproc.num_aspect_ratio_ids(tiles) == jproc.num_aspect_ratio_ids(tiles)
    assert tproc.aspect_ratio_to_id((2, 2)) == jproc.aspect_ratio_to_id((2, 2))


@pytest.mark.parametrize(
    "name", ["tiny", "mme5_11b", "mme5_11b_int8", "mme5_11b_int8_mixed", "mme5_11b_int4",
             "mme5_2b"]
)
def test_configs_mirror_jax(name):
    got, want = getattr(tm.MllamaConfig, name)(), getattr(jm.MllamaConfig, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vision.patches_per_tile == want.vision.patches_per_tile
    assert got.vision.num_aspect_ratio_ids == want.vision.num_aspect_ratio_ids


@pytest.mark.parametrize("quantize", [False, None, True, "int8", "int4", "int8-mixed",
                                      "int4-mixed"])
def test_split_quantize_mirrors_jax_setup(quantize):
    """The (vision, text) storage of each ``quantize`` value, against the
    JAX embedder's ``setup`` (read from its bound submodules)."""
    cfg = dataclasses.replace(jm.MllamaConfig.tiny(), quantize=quantize)
    bound = jm.MmE5Embedder(cfg).bind({"params": {}})
    want = (bound.vision_model.quantize, bound.text_model.quantize)
    assert tm.split_quantize(quantize) == want
    port = tm.MmE5Embedder(cfg)
    vision_q, text_q = want
    kinds = {False: "Dense", None: "Dense", True: "Int8Dense", "int8": "Int8Dense",
             "int4": "Int4Dense"}
    assert type(port.vision_model.local0.mlp.fc1).__name__ == kinds[vision_q]
    assert type(port.text_model.layer0.mlp.gate).__name__ == kinds[text_q]
    assert type(port.vision_model.multi_modal_projector).__name__ == "Dense"


def test_rms_norm():
    _compare(jtr.RMSNorm(), ttr.RMSNorm(64), [_tokens((2, 16, 64)) + 3.0])


def test_rope():
    cos, sin = jtr.rope_frequencies(16, 32, 500000.0)
    tcos, tsin = ttr.rope_frequencies(16, 32, 500000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin), atol=1e-6)
    x = _tokens((2, 12, 3, 16))
    want = jtr.apply_rope(jnp.asarray(x), cos, sin)
    got = ttr.apply_rope(torch.from_numpy(x), tcos, tsin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _sdpa_case(kind, dtype):
    rng = np.random.default_rng(2)
    lq, lk = (12, 12) if kind == "causal" else (9, 13)
    q, k, v = (_tokens((2, lq, 4, 16), 3), _tokens((2, lk, 2, 16), 4), _tokens((2, lk, 2, 16), 5))
    valid = rng.uniform(size=(2, lk)) < 0.7
    valid[:, 0] = True
    mask = valid[:, None, None, :]
    jargs = [jnp.asarray(a, dtype) for a in (q, k, v)]
    want = jtr.sdpa(*jargs, mask=jnp.asarray(mask), causal=kind == "causal")
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = ttr.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                   mask=torch.from_numpy(mask), causal=kind == "causal")
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("kind", ["causal", "cross"])
def test_sdpa_gqa_masks(kind):
    """GQA 4 query heads over 2 kv heads, a padding mask, and causal
    (self) or a ragged kv length (cross)."""
    got, want = _sdpa_case(kind, jnp.float32)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("kind", ["causal", "cross"])
def test_sdpa_bf16_numerics(kind):
    """The bf16 branch (bf16 logits, e rounded to bf16 before the
    denominator): one bf16 step at |o| < 2 (2^-7), for sums taken in
    another order."""
    got, want = _sdpa_case(kind, jnp.bfloat16)
    np.testing.assert_allclose(got, want, atol=2**-7)


@pytest.mark.parametrize("quantize", [False, True])
def test_llama_block(quantize):
    x = _tokens((2, 12, 64))
    mask = np.ones((2, 1, 1, 12), bool)
    mask[1, ..., 9:] = False
    jmod = jtr.LlamaBlock(num_heads=4, num_kv_heads=2, head_dim=16, mlp_hidden=128,
                          max_len=32, quantize=quantize)
    port = ttr.LlamaBlock(64, 4, 2, 16, 128, quantize=quantize)
    _compare(jmod, port, [x, mask])


def _compare_cross(quantize, seed=3):
    x, vis = _tokens((2, 12, 64), 6), _tokens((2, 13, 64), 7)
    cmask = np.ones((2, 1, 1, 13), bool)
    cmask[0, ..., 10:] = False
    jmod = jtr.CrossAttentionBlock(num_heads=4, num_kv_heads=2, head_dim=16,
                                   mlp_hidden=128, quantize=quantize)
    jargs = (jnp.asarray(x), jnp.asarray(vis), jnp.asarray(cmask))
    flat = _jax_flat(jmod, *jargs, seed=seed)
    want = jmod.apply(unflatten_params(flat), *jargs)
    port = load_jax_params(ttr.CrossAttentionBlock(64, 4, 2, 16, 128, quantize=quantize), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(vis), torch.from_numpy(cmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True])
def test_cross_attention_block(quantize):
    _compare_cross(quantize)


@pytest.mark.parametrize("block", ["local", "global"])
def test_encoder_blocks_with_key_prefix(block):
    """L = 8 with keys 5..7 masked, as the tower pads 5 tokens to 8."""
    cls_j, cls_t = {
        "local": (jtr.EncoderBlock, ttr.EncoderBlock),
        "global": (jtr.GatedEncoderBlock, ttr.GatedEncoderBlock),
    }[block]
    _compare(cls_j(num_heads=2), cls_t(64, 2), [_tokens((2, 8, 64))], key_valid_len=5)


TINY = jm.MllamaConfig.tiny()


@pytest.mark.parametrize("tiles", [1, 2])
def test_vision_encoder(tiles):
    """One tile and no tile mask (the page program: K1 with the key prefix),
    and a 2-tile stack with one padding tile (the masked plain path)."""
    rng = np.random.default_rng(8)
    images = rng.normal(size=(2, tiles, 28, 28, 3)).astype(np.float32)
    ar_ids = np.array([1, 2] if tiles == 1 else [2, 5], np.int32)
    tile_mask = np.array([[1] * tiles, [1] + [0] * (tiles - 1)], np.int32)
    jmod = jm.MllamaVisionEncoder(TINY.vision, out_dim=64)
    args = (jnp.asarray(images), jnp.asarray(ar_ids), jnp.asarray(tile_mask))
    flat = _jax_flat(jmod, *args)
    params = unflatten_params(flat)
    port = load_jax_params(tm.MllamaVisionEncoder(TINY.vision, 64, torch.float32), flat)
    if tiles == 1:
        want, wmask = jmod.apply(params, *args, all_tiles_real=True)
        tmask = None
    else:
        want, wmask = jmod.apply(params, *args)
        tmask = torch.from_numpy(tile_mask)
    with torch.no_grad():
        got, gmask = port(torch.from_numpy(images), torch.from_numpy(ar_ids), tmask)
    assert got.shape == want.shape == (2, tiles * 5, 64)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("quantize", [True, "int4"])
def test_vision_encoder_quantized(quantize, jax_int4_kernel):
    """The one-tile page crop (K1 with the key prefix) through an int8 and
    an int4 tower, their projections (with the fc biases) on K2's and K3's
    plain versions."""
    rng = np.random.default_rng(12)
    images = rng.normal(size=(2, 1, 28, 28, 3)).astype(np.float32)
    ar_ids = np.array([1, 1], np.int32)
    jmod = jm.MllamaVisionEncoder(TINY.vision, out_dim=64, quantize=quantize)
    args = (jnp.asarray(images), jnp.asarray(ar_ids), jnp.ones((2, 1), jnp.int32))
    flat = _jax_flat(jmod, *args)
    want, _ = jmod.apply(unflatten_params(flat), *args, all_tiles_real=True)
    port = load_jax_params(tm.MllamaVisionEncoder(TINY.vision, 64, torch.float32, quantize),
                           flat)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(images), torch.from_numpy(ar_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("quantize", [False, True, "int4"])
def test_text_model(quantize, jax_int4_kernel):
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 256, size=(2, 10)).astype(np.int32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    vis = _tokens((2, 6, 64), 10)
    vmask = np.ones((2, 6), np.int32)
    vmask[0, 4:] = 0
    jmod = jm.MllamaTextModel(TINY.text, quantize=quantize)
    args = [ids, mask, vis, vmask]
    _compare(jmod, tm.MllamaTextModel(TINY.text, torch.float32, quantize), args)


@pytest.fixture(scope="module", params=[False, True, "int8-mixed", "int4", "int4-mixed"])
def embedders(request):
    """The tiny mmE5 model in both packages on one bridged tree, and two
    crops embedded with the engine's prompt."""
    cfg = dataclasses.replace(TINY, quantize=request.param)
    jmodel = jm.MmE5Embedder(cfg)
    ids, mask = ttok.ByteTokenizer().encode_batch([EmbedderConfig().prompt], 32)
    ids, mask = np.repeat(ids, 2, 0), np.repeat(mask, 2, 0)
    crops = np.random.default_rng(11).normal(size=(2, 28, 28, 3)).astype(np.float32)
    flat = _jax_flat(jmodel, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(crops))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jquant, "int4_apply", _interpret_int4_apply)
        want = jmodel.apply(unflatten_params(flat), jnp.asarray(ids), jnp.asarray(mask),
                            jnp.asarray(crops))
    port = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="float32", quantize=request.param),
        model_config=tm.MllamaConfig.tiny(), device="cpu", params=flat,
    )
    return port, crops, np.asarray(want), flat


def test_embedder_matches_jax(embedders):
    port, crops, want, _ = embedders
    got = port.encode_image(torch.from_numpy(crops)).numpy()
    assert got.shape == (2, 64) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert np.all(cos >= 0.99999), cos


def test_embedder_storage(embedders):
    port, *_ = embedders
    vision_q, text_q = tm.split_quantize(port.model_config.quantize)
    kinds = {False: "Dense", True: "Int8Dense", "int4": "Int4Dense"}
    assert port.model.text_model.layer0.attn.q.__class__.__name__ == kinds[text_q]
    assert port.model.vision_model.local0.attn.q.__class__.__name__ == kinds[vision_q]
    assert port.prompt_ids.shape == (1, 32)


def test_engine_bf16_runs_on_the_cpu(embedders):
    """The same tree in bf16: types follow the JAX modules (f32 gates and
    norm scales, bf16 kernels) and the result stays close."""
    port, crops, want, flat = embedders
    bf = MultimodalEmbedder(
        EmbedderConfig(family="mme5", dtype="bfloat16", quantize=port.model_config.quantize),
        model_config=tm.MllamaConfig.tiny(), device="cpu", params=flat,
    )
    assert bf.model.vision_model.global0.gate_attn.dtype == torch.float32
    q = bf.model.vision_model.local0.attn.q
    if isinstance(q, ttr.Dense):
        assert q.weight.dtype == torch.bfloat16
    else:
        assert q.kernel_scale.dtype == torch.float32
    got = bf.encode_image(torch.from_numpy(crops)).numpy()
    cos = (got * want).sum(-1)
    assert np.all(cos >= 0.99), cos
