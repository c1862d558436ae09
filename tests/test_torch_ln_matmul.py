"""K6, the fused LayerNorm→matmul: the plain PyTorch version against the
JAX Pallas kernel (interpret mode), and the fused blocks and towers in bf16
against the JAX modules under ``MMTPU_LN_FUSE_INTERPRET=1`` (JAX fuses
only a bf16 block input, so these run in bf16 on both sides).

Tolerances. f32: 1e-5 absolute. bf16: per output, 2 bf16 steps at its
magnitude plus the summation bound of the repository's matmul checks —
``2·K·2⁻²⁴·Σ|xn·w|`` — plus one bf16 step of one normalised input of the
row times its weight (statistics that differ in the last f32 bit may round
an input the other way), and a mean error under 5% of a bf16 step (a
systematic fault, such as an unrounded xn or a one-pass variance, moves
most outputs). Blocks: 8 bf16 steps at the output's largest magnitude — the
JAX XLA path and torch round the attention and MLP intermediates at other
places. Towers: cosine ≥ 0.9999 per image."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels.ln_matmul import ln_matmul as jax_ln_matmul
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu.models import vision_encoder as jve
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.kernels import ln_matmul as k6
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import transformer as ttr
from multimodal_embeddings_tpu_torch.models import vision_encoder as tve
from multimodal_embeddings_tpu_torch.models.quantized import materialize
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)


def _step(v):
    _, exp = np.frexp(np.maximum(np.abs(v), 2.0**-126))
    return np.ldexp(1.0, exp - 8)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 1.5 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32)
    beta = rng.normal(scale=0.2, size=(k,)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    bias = rng.normal(scale=0.5, size=(n,)).astype(np.float32)
    return x, gamma, beta, w, bias


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(40, 128, 96), (200, 256, 384)])
def test_plain_matches_pallas_f32(m, k, n, with_bias):
    x, gamma, beta, w, bias = _operands(m + n, m, k, n)
    b = bias if with_bias else None
    want = jax_ln_matmul(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(w),
                         bias=None if b is None else jnp.asarray(b), interpret=True)
    got = k6.ln_matmul(*(torch.from_numpy(a) for a in (x, gamma, beta, w)),
                       bias=None if b is None else torch.from_numpy(b))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 128, 256), (200, 384, 1152)])
def test_plain_matches_pallas_bf16(m, k, n, with_bias):
    x, gamma, beta, w, bias = _operands(m * 3 + n, m, k, n)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jb = jnp.asarray(bias, jnp.bfloat16) if with_bias else None
    want = np.asarray(jax_ln_matmul(jx, jnp.asarray(gamma), jnp.asarray(beta), jw, bias=jb,
                                    interpret=True).astype(jnp.float32))
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    tb = torch.from_numpy(bias).bfloat16() if with_bias else None
    got = k6.ln_matmul(tx, torch.from_numpy(gamma), torch.from_numpy(beta), tw, bias=tb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    xf = tx.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + 1e-6) * torch.from_numpy(gamma)
          + torch.from_numpy(beta)).bfloat16().float()
    # the two sides' statistics may differ in the last f32 bit, so one
    # normalised input next to a rounding boundary may round to the
    # neighbouring bf16 value (measured: 1 of 76800 inputs here), which
    # moves each output of its row by up to step(xn)·|w|
    wabs = tw.float().abs().numpy()
    flip = np.outer(_step(xn.numpy()).max(-1), wabs.max(0))
    allowed = 2 * k * 2.0**-24 * (xn.abs().numpy() @ wabs) + flip + 2 * _step(want)
    err = np.abs(got - want)
    assert np.all(err <= allowed)
    assert err.mean() <= 0.05 * _step(want).mean()


def test_wrapper_checks_and_launch_count():
    x, g, w = torch.ones(4, 8), torch.ones(8), torch.ones(8, 16)
    before = k6.ln_matmul.launches
    k6.ln_matmul(x, g, g, w, bias=torch.ones(16))  # CPU: plain version
    assert k6.ln_matmul.launches == before
    with pytest.raises(ValueError):
        k6.ln_matmul(x, g, g, torch.ones(7, 16))
    with pytest.raises(ValueError):
        k6.ln_matmul(x, g, g, w, bias=torch.ones(15))
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        m = x.to("meta")
        k6.ln_matmul(m, g.to("meta"), g.to("meta"), w.to("meta"))


# --- fused blocks and towers, bf16 ------------------------------------------


def _bf16_values(flat, seed=0, min_dim=0):
    """Random biases and norm scales, then every leaf with at least
    ``min_dim`` dimensions rounded to bf16, so a bf16 port holds exactly
    the values the JAX module computes with."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        val = np.asarray(val, np.float32)
        if key.endswith(("/bias", "/scale")):
            val = val + rng.normal(scale=0.1, size=val.shape).astype(np.float32)
        if val.ndim >= min_dim:
            val = np.asarray(jnp.asarray(val, jnp.bfloat16).astype(jnp.float32))
        out[key] = val
    return out


@pytest.fixture
def fused_calls(monkeypatch):
    """Count the port's K6 calls (CPU: each one runs the plain version)."""
    monkeypatch.setenv("MMTPU_LN_FUSE_INTERPRET", "1")
    calls = []
    real = ttr.ln_matmul
    monkeypatch.setattr(ttr, "ln_matmul", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("fuse,sites", [(True, 2), ("attn", 1), ("mlp", 1), (False, 0)])
def test_encoder_block_fused_bf16(fuse, sites, fused_calls):
    x = jnp.asarray(np.random.default_rng(2).normal(size=(2, 16, 128)), jnp.bfloat16)
    jmod = jtr.EncoderBlock(num_heads=2, dtype=jnp.bfloat16, fuse_ln=fuse)
    flat = _bf16_values(flatten_params(unbox(jmod.init(jax.random.PRNGKey(0), x))))
    want = np.asarray(jmod.apply(unflatten_params(flat), x).astype(jnp.float32))
    port = load_jax_params(ttr.EncoderBlock(128, 2, fuse_ln=fuse), flat).bfloat16()
    with torch.no_grad():
        got = port(torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16())
    assert len(fused_calls) == sites and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 8 * _step(np.abs(want).max())


def test_fusion_gate(fused_calls):
    """No fusion for an f32 input or a width not divisible by 128."""
    for width, dtype in ((128, torch.float32), (64, torch.bfloat16)):
        block = ttr.EncoderBlock(width, 2, fuse_ln=True).to(dtype)
        with torch.no_grad():
            block(torch.randn(1, 8, width, dtype=dtype))
    assert not fused_calls


def _cosines(got, want):
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    return (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)


def test_vit_tower_fused_bf16(fused_calls):
    """Two layers at width 128; bf16 parameters on both sides (a bf16 residual
    stream, which is what the port's bf16 ViT runs)."""
    cfg = dict(image_size=64, patch_size=16, width=128, layers=2, heads=2, fuse_ln=True)
    images = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jmod = jve.ViTower(jve.VisionConfig(**cfg), embed_dim=64, dtype=jnp.bfloat16)
    flat = _bf16_values(flatten_params(unbox(jmod.init(jax.random.PRNGKey(0),
                                                       jnp.asarray(images)))))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), unflatten_params(flat))
    want = np.asarray(jmod.apply(params, jnp.asarray(images)))
    port = load_jax_params(tve.ViTower(tve.VisionConfig(**cfg), 64), flat).bfloat16()
    with torch.no_grad():
        got = port(torch.from_numpy(images)).numpy()
    assert len(fused_calls) == 4
    assert _cosines(got, want).min() >= 0.9999


def test_mllama_tower_fuse_mlp_bf16(fused_calls):
    """The mmE5 tower's ``fuse_ln="mlp"`` at width 128: fc1 of every local
    block on K6; matrices bf16 and norms f32, the port's storage types."""
    cfg = jm.MllamaVisionConfig(image_size=28, patch_size=14, width=128, layers=2,
                                global_layers=1, heads=2, intermediate_layers=(0, 1),
                                fuse_ln="mlp")
    rng = np.random.default_rng(4)
    images = rng.normal(size=(2, 1, 28, 28, 3)).astype(np.float32)
    args = (jnp.asarray(images), jnp.ones((2,), jnp.int32), jnp.ones((2, 1), jnp.int32))
    jmod = jm.MllamaVisionEncoder(cfg, out_dim=64, dtype=jnp.bfloat16)
    variables = unbox(jmod.init(jax.random.PRNGKey(0), *args, all_tiles_real=True))
    flat = _bf16_values(flatten_params(variables), min_dim=2)
    flat = {k: (v + 0.5 if k.endswith(("/gate", "/gate_attn", "/gate_ffn")) else v)
            for k, v in flat.items()}
    want, _ = jmod.apply(unflatten_params(flat), *args, all_tiles_real=True)
    want = np.asarray(want.astype(jnp.float32))
    tcfg = tm.MllamaVisionConfig(**dataclasses.asdict(cfg))
    with torch.device("meta"):
        port = tm.MllamaVisionEncoder(tcfg, 64, torch.bfloat16)
    load_jax_params(materialize(port, "cpu", torch.bfloat16), flat)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(images), torch.ones(2, dtype=torch.long))
    assert len(fused_calls) == cfg.layers
    assert _cosines(got.float().numpy(), want).min() >= 0.9999


# --- the wgmma form's rule and persistent schedule (pure Python) ------------

PATH_SHAPES = [(37632, 768, 2304), (37632, 768, 3072), (12864, 1280, 5120)]


@pytest.mark.parametrize("m,k,n", PATH_SHAPES)
def test_form_rule_path_shapes_take_wgmma(m, k, n):
    assert k6.ln_mm_form(m, k, n) == "wgmma"
    assert k6.wgmma_stages(k) == 4


@pytest.mark.parametrize("m,k,n,aligned,dtype,want", [
    (300, 1000, 1030, True, torch.bfloat16, "mma_sync"),  # N % 8 != 0
    (50, 100, 64, True, torch.bfloat16, "mma_sync"),  # K % 8 != 0
    (64, 768, 256, False, torch.bfloat16, "mma_sync"),  # a base off 16 bytes
    (64, 8392, 256, True, torch.bfloat16, "mma_sync"),  # not even 3 stages fit
    (64, 8384, 256, True, torch.bfloat16, "wgmma"),  # 3 stages
    (1, 8, 16, True, torch.bfloat16, "wgmma"),
    (1024, 768, 512, True, torch.float32, "f32"),
])
def test_form_rule_edges(m, k, n, aligned, dtype, want):
    assert k6.ln_mm_form(m, k, n, aligned, dtype) == want


def test_form_for_reads_alignment():
    x, w = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, 32, dtype=torch.bfloat16)
    assert k6.form_for(x, w) == "wgmma"
    flat = torch.zeros(4 * 64 + 16, dtype=torch.bfloat16)
    start = (-flat.data_ptr() % 16) // 2 + 4  # 8 bytes past a 16-byte boundary
    off = flat[start:start + 4 * 64].view(4, 64)
    assert k6.form_for(off, w) == "mma_sync"
    assert k6.form_for(x, w, torch.zeros(32, dtype=torch.bfloat16)) == "wgmma"


@pytest.mark.parametrize("m,k,n,ctas", [
    (37632, 768, 2304, 132), (37632, 768, 3072, 132), (12864, 1280, 5120, 132),
    (1, 136, 48, 132), (8192, 768, 2304, 132), (4096, 768, 768, 132), (300, 3000, 1040, 7)])
def test_plan_covers_each_unit_once_in_contiguous_row_block_major_runs(m, k, n, ctas):
    plan = k6.ln_mm_wgmma_plan(m, k, n, ctas)
    assert plan.mb == -(-m // 128) and plan.nt == -(-n // 256) and plan.nchunks == -(-k // 64)
    assert plan.grid == min(ctas, plan.units)
    seen = []
    sizes = []
    for j in range(plan.grid):
        units = plan.units_of(j)
        sizes.append(len(units))
        assert units, "every CTA has work"
        assert units == sorted(units)  # row-block-major
        flat = [rb * plan.nt + nj for rb, nj in units]
        assert flat == list(range(flat[0], flat[-1] + 1))  # contiguous
        if seen:
            assert flat[0] == seen[-1] + 1  # the runs follow one another
        seen += flat
        # one statistics pass per row block the run meets
        assert plan.stats_passes(j) == len({rb for rb, _ in units})
    assert seen == list(range(plan.units))  # every unit exactly once
    assert max(sizes) - min(sizes) <= 1


def test_plan_runs_start_mid_row_block():
    plan = k6.ln_mm_wgmma_plan(8192, 768, 2304, 132)
    assert plan.units > plan.grid
    starts = [plan.share(j)[0] for j in range(plan.grid)]
    assert any(u0 % plan.nt for u0 in starts)
    assert max(plan.stats_passes(j) for j in range(plan.grid)) == 2
    # the ViT qkv shape: 2,646 units over 132 CTAs, runs of 20-21 units
    # meeting 3-4 row blocks each
    qkv = k6.ln_mm_wgmma_plan(37632, 768, 2304, 132)
    passes = [qkv.stats_passes(j) for j in range(qkv.grid)]
    assert min(passes) >= 3 and max(passes) <= 4


def test_shared_memory_fits_every_k_the_form_accepts():
    accepted = [k for k in range(8, 9000, 8) if k6.ln_mm_form(128, k, 256) == "wgmma"]
    assert accepted[-1] == 8384 and len(accepted) == 8384 // 8
    for k in accepted:
        stages = k6.wgmma_stages(k)
        assert stages in (3, 4)
        assert k6.wgmma_smem(k, stages) <= 232448
        assert stages == 3 or k6.wgmma_smem(k, 4) <= 232448
        assert k6.ln_mm_wgmma_plan(128, k, 256, 132).smem == k6.wgmma_smem(k, stages)
    assert k6.wgmma_stages(8392) == 0
    with pytest.raises(ValueError):
        k6.ln_mm_wgmma_plan(128, 8392, 256, 132)


def test_narrowed_vit_fc1_against_pallas_bf16():
    """A path shape narrowed to (256, 768) x (768, 512) with a bias, the
    CPU dispatch against the JAX kernel in interpret mode (the bf16
    tolerance of ``test_plain_matches_pallas_bf16``)."""
    m, k, n = 256, 768, 512
    x, gamma, beta, w, bias = _operands(14, m, k, n)
    jx, jw, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, bias))
    want = np.asarray(jax_ln_matmul(jx, jnp.asarray(gamma), jnp.asarray(beta), jw, bias=jb,
                                    interpret=True).astype(jnp.float32))
    tx, tw, tb = (torch.from_numpy(a).bfloat16() for a in (x, w, bias))
    assert k6.form_for(tx, tw, tb) == "wgmma"
    got = k6.ln_matmul(tx, torch.from_numpy(gamma), torch.from_numpy(beta), tw, bias=tb)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    got = got.float().numpy()
    xf = tx.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + 1e-6) * torch.from_numpy(gamma)
          + torch.from_numpy(beta)).bfloat16().float()
    wabs = tw.float().abs().numpy()
    flip = np.outer(_step(xn.numpy()).max(-1), wabs.max(0))
    # the product rounds once and, with the bias, the sum again
    pre = np.asarray(jax_ln_matmul(jx, jnp.asarray(gamma), jnp.asarray(beta), jw,
                                   interpret=True).astype(jnp.float32))
    allowed = (2 * k * 2.0**-24 * (xn.abs().numpy() @ wabs) + flip
               + 2 * _step(pre) + 2 * _step(want))
    err = np.abs(got - want)
    assert np.all(err <= allowed)
    assert err.mean() <= 0.05 * _step(want).mean()
