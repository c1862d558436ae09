"""YOLOv10 / GL-CRM blocks: PyTorch port against the JAX modules in f32.

Every BatchNorm gets random scale, bias, mean and variance, so the
bridge's fold (w·γ/σ, β − μ·γ/σ) is exercised, not just its identity.
The JAX PSA attention takes the packed BLF Pallas kernel (interpret mode),
or with ``MMTPU_PSA_BLF=0`` its ``sdpa``, as the port does.
Tolerance 2e-5 absolute on activations up to ~10 (measured differences up
to 7e-6): the port folds BatchNorm into the conv (one rounding of w·γ/σ
per weight) where JAX normalises after it, and the frameworks sum
convolutions in different orders."""

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import layers as jl
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.models import layers as tl
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)
ATOL = 2e-5


@pytest.fixture(autouse=True)
def _psa_interpret(monkeypatch):
    monkeypatch.setenv("MMTPU_PSA_BLF_INTERPRET", "1")


def randomize_norms(flat, seed=0):
    """Random BatchNorm statistics and affine parameters, and biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        if key.endswith("/var"):
            val = rng.uniform(0.5, 1.5, val.shape)
        elif key.endswith("/scale"):
            val = rng.uniform(0.5, 1.5, val.shape)
        elif key.endswith(("/mean", "/bias")):
            val = rng.normal(scale=0.2, size=val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


def compare(jax_module, port_module, shape, seed=0):
    """Same NHWC input through both (the port computes NCHW)."""
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    variables = unbox(jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    flat = randomize_norms(flatten_params(variables), seed)
    want = np.asarray(jax_module.apply(unflatten_params(flat), jnp.asarray(x)))
    load_jax_params(port_module, flat)
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize(
    "k,s,g,d,act",
    [(1, 1, 1, 1, True), (3, 2, 1, 1, True), (3, 1, 1, 2, True), (3, 1, 16, 1, False),
     (7, 1, 16, 1, True)],
)
def test_conv_bn_act(k, s, g, d, act):
    compare(
        jl.ConvBnAct(16, k, strides=s, groups=g, dilation=d, act=act),
        tl.ConvBnAct(16, 16, k, s, groups=g, dilation=d, act=act),
        (2, 12, 12, 16),
    )


@pytest.mark.parametrize("c_in,hw", [(3, (16, 12)), (8, (10, 14))])
def test_s2d_conv_bn_act(c_in, hw):
    """JAX's space-to-depth stem cell (``ConvBnAct(s2d=True)``) against the
    port's one stride-2 conv on the same weights: the port leaves the s2d
    form out, and loses no result by it."""
    compare(jl.ConvBnAct(16, 3, strides=2, s2d=True), tl.ConvBnAct(c_in, 16, 3, 2),
            (2, *hw, c_in))


def test_bottleneck():
    compare(jl.Bottleneck(16), tl.Bottleneck(16, 16), (2, 8, 8, 16))


@pytest.mark.parametrize("shortcut", [False, True])
@pytest.mark.parametrize("use_cib", [False, True])
def test_c2f(shortcut, use_cib):
    compare(
        jl.C2f(32, n=2, shortcut=shortcut, use_cib=use_cib),
        tl.C2f(24, 32, n=2, shortcut=shortcut, use_cib=use_cib),
        (2, 8, 8, 24),
    )


@pytest.mark.parametrize("long_kernel", [False, True])
def test_cib(long_kernel):
    compare(
        jl.CIB(16, long_kernel=long_kernel),
        tl.CIB(16, 16, long_kernel=long_kernel),
        (2, 10, 10, 16),
    )


def test_crm_bottleneck():
    compare(jl.CRMBottleneck(16, dilation=4), tl.CRMBottleneck(16, 16, dilation=4),
            (2, 12, 12, 16))


@pytest.mark.parametrize("dilation", [2, 4])
def test_g2l_crm(dilation):
    compare(
        jl.G2L_CRM(32, n=2, dilation=dilation),
        tl.G2L_CRM(24, 32, n=2, dilation=dilation),
        (2, 12, 12, 24),
    )


def test_scdown():
    compare(jl.SCDown(32), tl.SCDown(16, 32), (2, 12, 12, 16))


def test_sppf():
    """Inputs of both signs: the −inf border padding of the max-pools
    matters wherever a border window is all negative."""
    compare(jl.SPPF(32), tl.SPPF(16, 32), (2, 9, 9, 16))


@pytest.mark.parametrize("heads", [1, 2])
def test_psa_attention(heads):
    compare(
        jl.PSAAttention(128, num_heads=heads),
        tl.PSAAttention(128, num_heads=heads),
        (2, 4, 4, 128),
    )


def test_psa_attention_production_head_geometry():
    """m-scale PSA: 288 channels, 4 heads of [q(36) | k(36) | v(72)]."""
    compare(jl.PSAAttention(288, num_heads=4), tl.PSAAttention(288, num_heads=4),
            (1, 4, 4, 288))


def test_psa():
    compare(jl.PSA(256), tl.PSA(256, 256), (2, 4, 4, 256))


@pytest.mark.parametrize("hw", [4, 16])
def test_psa_attention_sdpa_route(hw, monkeypatch):
    """``MMTPU_PSA_BLF=0``: both packages leave the packed kernel for
    ``sdpa`` on strided views of the [q|k|v] slab — the port's takes K1 at
    L = 256 and the XLA-numerics path at L = 16, JAX's the XLA path on the
    CPU."""
    from multimodal_embeddings_tpu.models import transformer as jtr

    monkeypatch.delenv("MMTPU_PSA_BLF_INTERPRET")
    monkeypatch.setenv("MMTPU_PSA_BLF", "0")
    calls = {"jax": 0, "port": 0}

    def recorder(side, real):
        def call(*args, **kwargs):
            calls[side] += 1
            return real(*args, **kwargs)
        return call

    def refuse(*args, **kwargs):
        raise AssertionError("the packed kernel ran under MMTPU_PSA_BLF=0")

    monkeypatch.setattr(jtr, "sdpa", recorder("jax", jtr.sdpa))
    monkeypatch.setattr(tl, "sdpa", recorder("port", tl.sdpa))
    monkeypatch.setattr(tl, "encoder_attention_blf_packed", refuse)
    compare(jl.PSAAttention(128, num_heads=2), tl.PSAAttention(128, num_heads=2),
            (1, hw, hw, 128))
    assert calls == {"jax": 2, "port": 1}  # JAX: init and apply


def test_upsample2x():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(jl.upsample2x(jnp.asarray(x)))
    got = tl.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)
