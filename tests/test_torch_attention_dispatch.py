"""The attention dispatch switches of the port's ``models/transformer.py``
against the JAX package's, on the same inputs and weights.

* a quantized block skips the BLF and proj-BHLD routes, as JAX gates them;
* ``MMTPU_F32_LOGITS=1``: ``sdpa``'s XLA path computes bf16 q·k with an f32
  result instead of rounding the logits to bf16;
* ``MMTPU_ENC_ATTN=0``: ``sdpa``'s whole-row K1 dispatch is off, so a key
  prefix becomes a key mask and unmasked self-attention takes the XLA path.

JAX runs on the CPU as its own tests do (the XLA path; ``_on_tpu_backend``
is patched to True where the test reads JAX's TPU dispatch). Route recorders
replace the port's kernel wrappers where a test says a route must not be
taken. Tolerances are stated at each comparison."""

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)


def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _forbid(monkeypatch, *names):
    """Replace the port's kernel wrappers ``names`` with recorders that fail
    the test when called."""
    def forbidden(name):
        def call(*args, **kwargs):
            raise AssertionError(f"{name} was called")
        return call

    for name in names:
        monkeypatch.setattr(ttr, name, forbidden(name))


def _attention_pair(quantize, x, seed=0, **call):
    """A JAX ``Attention`` (4 heads of 16) with random weights and its port
    twin loaded through the bridge; returns (JAX output, port module)."""
    jmod = jtr.Attention(num_heads=4, head_dim=16, quantize=quantize)
    jx = jnp.asarray(x)
    flat = flatten_params(unbox(jmod.init(jax.random.PRNGKey(seed), jx, **call)))
    rng = np.random.default_rng(seed)
    for key, val in flat.items():  # int8 leaves that init leaves trivial
        if key.endswith("kernel_q"):
            flat[key] = rng.integers(-127, 128, size=val.shape).astype(np.int8)
        elif key.endswith("kernel_scale"):
            flat[key] = (rng.uniform(0.5, 1.5, size=val.shape) * 0.02 / 127).astype(np.float32)
    want = np.asarray(jmod.apply(unflatten_params(flat), jx, **call))
    port = load_jax_params(ttr.Attention(x.shape[-1], 4, 16, quantize=quantize), flat)
    return want, port


def test_quantized_block_skips_the_blf_route(monkeypatch):
    """An int8 unmasked self-attention block at L = 256 (inside JAX's
    whole-row window, L % 16 = 0): JAX runs its quantized projections and
    ``sdpa``, never BLF; so must the port. f32, 1e-5 absolute: the same
    arithmetic summed in other orders."""
    _forbid(monkeypatch, "encoder_attention_blf")
    x = _randn(1, (2, 256, 64))
    want, port = _attention_pair("int8", x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_f32_logits_switch(monkeypatch):
    """q and k of mean 2 in every column put the logits near 256, where a
    bf16 step is 2 (1/4 after the 1/8 scale): ``MMTPU_F32_LOGITS=1`` keeps
    them in f32 on both sides. A masked call, which neither side sends to
    K1. The f32 logits differ in their last bits between the two
    frameworks (other summation orders), so a probability next to a bf16
    rounding boundary may round the other way and move its output by up to
    2^-8·p·|v|. Tolerance, per output: 2 bf16 steps at its magnitude plus
    2^-7 of the attention-weighted mean |v|; without the switch most of
    the port's outputs leave it."""
    q, k = _randn(2, (2, 64, 4, 64)) + 2, _randn(3, (2, 64, 4, 64)) + 2
    v = _randn(4, (2, 64, 4, 64))
    mask = np.ones((2, 1, 1, 64), bool)
    mask[1, ..., 40:] = False
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    rounded = ttr.sdpa(tq, tk, tv, mask=tmask).float().numpy()

    monkeypatch.setenv("MMTPU_F32_LOGITS", "1")
    want = jtr.sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), mask=jnp.asarray(mask))
    want = np.asarray(want.astype(jnp.float32))
    got = ttr.sdpa(tq, tk, tv, mask=tmask)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    logits = torch.einsum("blhd,bmhd->bhlm", tq.float(), tk.float()) / 8.0
    probs = torch.softmax(logits.masked_fill(~tmask, -1e30), dim=-1)
    weighted = torch.einsum("bhlm,bmhd->blhd", probs, tv.float().abs()).numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    allowed = 2 * step + 2.0**-7 * weighted
    assert np.all(np.abs(got - want) <= allowed)
    assert np.mean(np.abs(rounded - want) > allowed) > 0.5


@pytest.mark.parametrize("case", ["prefix", "unmasked", "attention_prefix"])
def test_enc_attn_switch_off(case, monkeypatch):
    """``MMTPU_ENC_ATTN=0``, with JAX dispatching as on a TPU: ``sdpa``
    with a key prefix masks the keys, unmasked self-attention at L = 256
    takes the XLA path, and ``Attention``'s prefix call goes through
    ``sdpa`` too; K1 is never launched. f32, 1e-5 absolute."""
    monkeypatch.setenv("MMTPU_ENC_ATTN", "0")
    monkeypatch.setattr(jtr, "_on_tpu_backend", lambda: True)
    _forbid(monkeypatch, "encoder_attention", "encoder_attention_blhd")
    if case == "attention_prefix":
        x = _randn(5, (2, 256, 64))
        want, port = _attention_pair(False, x, key_valid_len=249)
        with torch.no_grad():
            got = port(torch.from_numpy(x), key_valid_len=249).numpy()
    else:
        q, k, v = (_randn(s, (2, 256, 4, 16)) for s in (6, 7, 8))
        n = 249 if case == "prefix" else None
        want = np.asarray(jtr.sdpa(*(jnp.asarray(a) for a in (q, k, v)), key_valid_len=n))
        got = ttr.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), key_valid_len=n).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_enc_attn_switch_leaves_k1_on_by_default(monkeypatch):
    """Without the variable the same calls launch K1 (the recorder sees
    them), so the test above reads the switch and not a shape rule."""
    calls = []
    monkeypatch.delenv("MMTPU_ENC_ATTN", raising=False)
    monkeypatch.setattr(ttr, "encoder_attention", lambda *a, **kw: calls.append(kw) or a[0])
    q = torch.zeros(1, 256, 4, 16)
    ttr.sdpa(q, q, q, key_valid_len=249)
    ttr.sdpa(q, q, q)
    assert calls == [{"valid_len": 249}, {}]
