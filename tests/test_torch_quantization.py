"""Weight-only int8: the port's quantization helpers, K2's plain version and
``Int8Dense`` against the JAX package, plus the storage rules and the
synthetic weights of ``models/quantized.py``.

K2's plain version is held against the JAX Pallas kernel in interpret
mode. Both sum the products of x with the exact int8 values in f32, in
different orders (the kernel in K blocks of 512), so outputs agree to
f32 round-off: rtol 1e-5, with an absolute floor of 1e-5·max|y| for outputs
that cancel to near zero.

K8 (``stochastic_round_quantize``) is held against the JAX Pallas kernel in
interpret mode too, handed JAX's own uniforms: the int8 values must be
EXACTLY equal (the same f32 division, add and floor). On the port's own
draws it must pass JAX's statistical tests."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import quantization as jq
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu_torch.kernels import quantization as tq
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import quantized as tquant
from multimodal_embeddings_tpu_torch.models.weights import build_mme5, load_jax_params

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
    )


@pytest.mark.parametrize("shape,axes", [((64, 48), (0,)), ((16, 4, 24), (0,)),
                                        ((4, 8, 40), (0, 1))])
def test_quantize_tensor_is_bit_exact(shape, axes):
    w = (_rng(0).normal(size=shape) * 0.05).astype(np.float32)
    w[0, ...] = 0.0  # an all-zero row takes the 1e-8 floor where it is the max
    want = jq.quantize_tensor(jnp.asarray(w), contract_axes=axes)
    got = tq.quantize_tensor(torch.from_numpy(w), contract_axes=axes)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    for dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        np.testing.assert_array_equal(
            tq.dequantize(got, dtype).float().numpy(),
            np.asarray(jq.dequantize(want, jdt).astype(jnp.float32)),
        )


@pytest.mark.parametrize("m,k,n", [(8, 512, 128), (37, 200, 136), (64, 1100, 256),
                                   (3, 40, 24)])
def test_int8_matmul_plain_matches_pallas(m, k, n):
    rng = _rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    q = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, size=(1, n)) * 0.02 / 127).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), interpret=True)
    got = tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale))
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_int8_matmul_plain_bf16_matches_pallas_bf16():
    """bf16 x, bf16 out: the same f32 sums rounded once; tolerance 2 bf16
    steps (2^-7 relative) over the f32 floor."""
    rng = _rng(5)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    q = rng.integers(-127, 128, size=(512, 128)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, size=(1, 128)) * 0.02 / 127).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
                          interpret=True)
    got = tq.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(q),
                         torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5 * np.abs(want).max())


def test_int8_apply_keeps_leading_axes():
    rng = _rng(6)
    x = rng.normal(size=(2, 3, 40)).astype(np.float32)
    qt = jq.quantize_tensor(jnp.asarray(rng.normal(size=(40, 24)).astype(np.float32)))
    want = jq.int8_apply(jnp.asarray(x), qt, use_kernel=False)
    got = tq.int8_apply(torch.from_numpy(x), tq.QTensor(
        torch.from_numpy(np.array(qt.q)), torch.from_numpy(np.array(qt.scale))))
    assert got.shape == (2, 3, 24)
    _close(got.numpy(), want)


def _int8_flat(module, x, seed):
    flat = traverse_util.flatten_dict(unbox(module.init(jax.random.PRNGKey(0), x)), sep="/")
    rng = _rng(seed)
    for key, val in flat.items():
        if key.endswith("kernel_q"):
            flat[key] = rng.integers(-127, 128, size=val.shape).astype(np.int8)
        elif key.endswith("kernel_scale"):
            flat[key] = (rng.uniform(0.5, 1.5, size=val.shape) * 0.02 / 127).astype(np.float32)
        else:
            flat[key] = rng.normal(scale=0.1, size=val.shape).astype(np.float32)
    return flat


@pytest.mark.parametrize("features,bias", [(24, True), ((4, 6), False)])
def test_int8_dense_matches_int8_dense_general(features, bias):
    x = _rng(7).normal(size=(2, 5, 40)).astype(np.float32)
    jmod = jquant.Int8DenseGeneral(features=features, use_bias=bias, dtype=jnp.float32)
    flat = _int8_flat(jmod, jnp.asarray(x), seed=8)
    want = jmod.apply(traverse_util.unflatten_dict(flat, sep="/"), jnp.asarray(x))
    out = int(np.prod(features))
    port = load_jax_params(tquant.Int8Dense(40, out, bias=bias, dtype=torch.float32), flat)
    assert port.kernel_q.dtype == torch.int8
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.reshape(np.asarray(want).shape).numpy(), want)


def test_launch_counter_and_dispatch():
    x, q, s = torch.zeros(4, 8), torch.zeros(8, 16, dtype=torch.int8), torch.ones(16)
    before = tq.int8_matmul.launches
    tq.int8_matmul(x, q, s)  # CPU: plain version
    assert tq.int8_matmul.launches == before
    with pytest.raises(ValueError):  # only a CPU tensor takes the plain version
        tq.int8_matmul(x.to("meta"), q.to("meta"), s.to("meta"))
    with pytest.raises(ValueError):
        tq.int8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        tq.int8_matmul(x, q[:4], s)


def test_storage_dtypes():
    p2, p1 = torch.empty(4, 4), torch.empty(4)
    assert tquant.storage_dtype("weight", p2, torch.bfloat16) == torch.bfloat16
    assert tquant.storage_dtype("kernel_scale", torch.empty(1, 4), torch.bfloat16) == torch.float32
    assert tquant.storage_dtype("scale", p1, torch.bfloat16) == torch.float32
    assert tquant.storage_dtype("kernel_q", torch.empty(4, 4, dtype=torch.int8),
                                torch.bfloat16) == torch.int8


def test_synthetic_weights_and_param_bytes_match_jax():
    """The tiny int8-mixed tree: the same leaves, byte count and
    distributions as ``synthetic_int8_init`` (not its values: the two
    frameworks draw differently), and the same draw for the same seed."""
    cfg = jm.MllamaConfig.tiny()
    jmodel = jm.MmE5Embedder(dataclasses.replace(cfg, quantize="int8-mixed"))
    ids = jnp.zeros((1, 8), jnp.int32)
    args = (ids, jnp.ones_like(ids), jnp.zeros((1, 1, 28, 28, 3)))
    jtree = jquant.synthetic_int8_init(jmodel, args, seed=0)
    tcfg = dataclasses.replace(tm.MllamaConfig.tiny(), quantize="int8-mixed")
    a = build_mme5(tcfg, torch.float32, "cpu", seed=0)
    b = build_mme5(tcfg, torch.float32, "cpu", seed=0)
    assert tquant.param_bytes(a) == jquant.param_bytes(jtree)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    ints = [p for p in a.parameters() if p.dtype == torch.int8]
    assert ints and all(int(p.min()) >= -127 and int(p.max()) <= 127 for p in ints)
    for name, p in a.named_parameters():
        if p.is_floating_point() and p.dim() == 1:
            assert torch.all(p == np.float32(0.02)), name
    big = a.text_model.tok_embed.embedding
    assert abs(big.std().item() - 0.02) < 0.002


# --- stochastic rounding (K8) -----------------------------------------------


def _jax_uniforms(seed, rows, cols):
    """The uniforms JAX's ``_sr_quantize_2d`` draws: threefry on the
    row-padded (block = min(rows, 256)) shape, the first ``rows`` rows."""
    pad = (-rows) % min(rows, 256)
    u = jax.random.uniform(jax.random.key(seed), (rows + pad, cols), jnp.float32)
    return np.array(u[:rows])


@pytest.mark.parametrize("shape,axes,seed,dtype", [
    ((256, 128), (0,), 0, "float32"),
    ((300, 96), (0,), 1, "float32"),   # 300 rows: JAX pads to 512 and slices
    ((32, 4, 8), (0,), 5, "float32"),  # rank 3: the collapse to (32, 32)
    ((64, 48), (0,), 2, "bfloat16"),
])
def test_sr_equals_jax_on_jax_uniforms(shape, axes, seed, dtype):
    """Handed JAX's own uniforms, the port's int8 values and scales are
    EQUAL to JAX's (interpret mode)."""
    w = (_rng(seed).normal(size=shape) * 0.05).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = jq.stochastic_round_quantize(jnp.asarray(w, jdt), axes, seed=seed, interpret=True)
    cols = int(np.prod([n for a, n in enumerate(shape) if a not in axes]))
    u = _jax_uniforms(seed, w.size // cols, cols)
    got = tq.stochastic_round_quantize(torch.from_numpy(w).to(getattr(torch, dtype)), axes,
                                       seed=seed, u=torch.from_numpy(u))
    assert got.q.dtype == torch.int8 and got.q.shape == shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def test_sr_exact_integers_equal_jax_on_jax_uniforms():
    col = np.float32([127.0, -127.0, 0.0, 63.5, -63.5, 127.0, -127.0, 0.0])
    w = np.stack([col, col / 2.0], axis=1) / np.float32(127.0)
    want = jq.stochastic_round_quantize(jnp.asarray(w), (0,), seed=3, interpret=True)
    got = tq.stochastic_round_quantize(torch.from_numpy(w), (0,), seed=3,
                                       u=torch.from_numpy(_jax_uniforms(3, 8, 2)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))


def test_sr_unbiased_on_the_ports_draws():
    """JAX's test on the port's own uniforms: a constant strictly between
    two levels (w/scale = 44.45) averages to the value over 8 seeds, and
    every sample is one of the two adjacent levels."""
    w = torch.full((256, 128), 0.35)
    w[0, :] = 1.0
    qs = [tq.stochastic_round_quantize(w, (0,), seed=s).q[1:] for s in range(8)]
    mean_q = torch.stack(qs).double().mean().item()
    assert abs(mean_q - 0.35 * 127.0) < 0.15, mean_q
    for q in qs:
        assert set(torch.unique(q).tolist()) <= {44, 45}


def test_sr_exact_integers_stable_on_the_ports_draws():
    """Values that are exact multiples of their scale never move
    (floor(k + u) = k for u in [0, 1)): the division must be IEEE."""
    col = np.float32([127.0, -127.0, 0.0, 63.5, -63.5, 127.0, -127.0, 0.0])
    w = torch.from_numpy(np.stack([col, col / 2.0], axis=1) / np.float32(127.0))
    got = tq.stochastic_round_quantize(w, (0,), seed=3).q.numpy()
    expect = np.int8([127, -127, 0, 64, -64, 127, -127, 0])
    exact = np.abs(col - np.round(col)) < 1e-6
    np.testing.assert_array_equal(got[exact, 0], expect[exact])
    np.testing.assert_array_equal(got[exact, 1], expect[exact])


def test_sr_higher_rank_within_one_level():
    """JAX's rank-3 test on the port's draws: the layout is restored and
    every value lies within one level of w."""
    w = torch.from_numpy(_rng(7).normal(size=(32, 4, 8)).astype(np.float32))
    qt = tq.stochastic_round_quantize(w, (0,), seed=5)
    assert qt.q.shape == w.shape and qt.q.dtype == torch.int8
    assert qt.scale.shape == (1, 4, 8)
    err = (qt.q.double() * qt.scale.double() - w.double()).abs()
    assert bool((err <= qt.scale.double() + 1e-6).all())


def test_sr_seeded_draws_and_wrapper_checks():
    w = torch.from_numpy(_rng(8).normal(size=(40, 24)).astype(np.float32))
    before = tq._sr_quantize_2d.launches
    a, b = (tq.stochastic_round_quantize(w, seed=s).q for s in (11, 11))
    assert tq._sr_quantize_2d.launches == before  # the CPU takes the plain version
    assert torch.equal(a, b)
    assert not torch.equal(a, tq.stochastic_round_quantize(w, seed=12).q)
    u = tq.sr_uniform((40, 24), 11, "cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(a, tq.stochastic_round_quantize(w, seed=0, u=u).q)
    with pytest.raises(ValueError):
        tq.stochastic_round_quantize(w, u=torch.zeros(24, 40))
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        m = w.to("meta")
        tq._sr_quantize_2d(m, torch.ones(1, 24, device="meta"), torch.zeros(40, 24, device="meta"))
