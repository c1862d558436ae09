"""K7, the LayerNorm statistics: the plain PyTorch version against the JAX
Pallas kernel (interpret mode), and ``FastLayerNorm`` under
``MMTPU_LN_STATS=1`` against the JAX module.

Tolerance 1e-6 absolute on mean and rstd of O(1) rows of up to 4096 values:
both sides take f32 sums in different orders."""

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import ln_stats as jls
from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.kernels import ln_stats as k7
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)
ATOL = 1e-6


def _x(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * rng.uniform(0.5, 2.0) + 0.5).astype(np.float32)


# after the first three, the rows chip_smoke.py holds the card's kernel to at
# its edges: one 16-byte word a row, rows that are no whole number of 16-byte
# words a lane, D = 12 (24 bytes a bf16 row: element loads), one block of 8
# rows, 8 or 16 KB a row
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 256), (1, 24, 1280), (3, 8, 768), (1, 8, 4),
                                   (1, 8, 40), (3, 24, 12), (2, 16, 1000), (1, 8, 768),
                                   (1, 8, 4096)])
def test_plain_matches_pallas(shape, dtype):
    x = _x(sum(shape), shape)
    jx = jnp.asarray(x, dtype)
    want_m, want_r = jls.ln_stats(jx, eps=1e-6, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got_m, got_r = k7.ln_stats(tx, 1e-6)
    assert got_m.shape == got_r.shape == (*shape[:2], 1)
    assert got_m.dtype == got_r.dtype == torch.float32
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=ATOL)


def test_pick_row_block_is_the_jax_rule():
    for l in (8, 16, 784, 1608, 1600, 4000):
        for d in (64, 768, 1280, 4096):
            for itemsize in (2, 4):
                assert k7.pick_row_block(l, d, itemsize) == jls.pick_row_block(l, d, itemsize)


def test_wrapper_checks_and_launch_count():
    before = k7.ln_stats.launches
    k7.ln_stats(torch.ones(1, 8, 16))  # CPU: plain version
    assert k7.ln_stats.launches == before
    with pytest.raises(ValueError):
        k7.ln_stats(torch.ones(8, 16))
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        k7.ln_stats(torch.ones(1, 8, 16, device="meta"))


@pytest.mark.parametrize("shape", [(2, 16, 64), (2, 8, 1280)])
def test_fast_layer_norm_with_the_switch(shape, monkeypatch):
    """Same output as the JAX module (which on the CPU takes its fallback,
    the formula K7 computes), and the statistics equal the JAX formula's."""
    x = _x(7, shape) + 3.0  # a large mean: the one-pass formula is what is ported
    jmod = jtr.FastLayerNorm()
    flat = flatten_params(unbox(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))))
    rng = np.random.default_rng(1)
    flat = {k: (v + rng.normal(scale=0.1, size=v.shape)).astype(np.float32)
            for k, v in flat.items()}
    want = np.asarray(jmod.apply(unflatten_params(flat), jnp.asarray(x)))
    port = load_jax_params(ttr.FastLayerNorm(shape[-1]), flat)
    calls = []
    real = ttr.ln_stats
    monkeypatch.setattr(ttr, "ln_stats", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("MMTPU_LN_STATS", "1")
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    xf = jnp.asarray(x)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    rstd = jax.lax.rsqrt(jnp.maximum(jnp.mean(xf * xf, axis=-1, keepdims=True)
                                     - mean * mean, 0.0) + 1e-6)
    got_m, got_r = k7.ln_stats(torch.from_numpy(x), 1e-6)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(mean), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(rstd), atol=ATOL)


@pytest.mark.parametrize("shape,taken", [((2, 16, 64), True), ((2, 12, 64), False),
                                         ((2, 1, 8, 64), False), ((16, 64), False)])
def test_fast_layer_norm_gate(shape, taken, monkeypatch):
    """K7 only for a 3-D input with L % 8 == 0 (the JAX gate without its
    TPU VMEM budget), and only with the switch on; the output is the same
    either way."""
    x = torch.from_numpy(_x(3, shape))
    ln = ttr.FastLayerNorm(shape[-1])
    off = ln(x)
    calls = []
    real = ttr.ln_stats
    monkeypatch.setattr(ttr, "ln_stats", lambda *a: calls.append(1) or real(*a))
    assert torch.equal(ln(x), off) and not calls
    monkeypatch.setenv("MMTPU_LN_STATS", "1")
    on = ln(x)
    assert len(calls) == int(taken)
    torch.testing.assert_close(on, off, atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 1001, 768), (3, 17, 12)])
def test_plain_matches_the_formula_on_ragged_rows(shape, dtype):
    """Rows that are no multiple of 8 (which the JAX kernel refuses, and the
    card's blocks of 8 rows end inside): the one-pass formula in f64."""
    x = torch.from_numpy(_x(sum(shape), shape)).to(getattr(torch, dtype))
    xd = x.double().numpy()
    m = xd.mean(-1, keepdims=True)
    rstd = 1 / np.sqrt(np.maximum((xd * xd).mean(-1, keepdims=True) - m * m, 0) + 1e-6)
    got_m, got_r = k7.ln_stats(x, 1e-6)
    np.testing.assert_allclose(got_m.numpy(), m, atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), rstd, atol=ATOL * np.abs(rstd).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_on_a_view_off_alignment(dtype):
    """x one element past its allocation (the card's kernel takes element
    loads there): the same bits as on an aligned copy, twice."""
    shape = (4, 16, 768)
    buf = torch.from_numpy(_x(5, (int(np.prod(shape)) + 1,))).to(getattr(torch, dtype))
    x = buf[1:].view(shape)
    want = k7.ln_stats(x.clone(), 1e-6)
    for _ in range(2):
        got = k7.ln_stats(x, 1e-6)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
