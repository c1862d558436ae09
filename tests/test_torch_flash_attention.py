"""Flash attention (K4): the port's plain version against the JAX Pallas
kernel in interpret mode, and the port's ``sdpa`` dispatch against JAX
``sdpa``.

``flash_attention_v2`` (K4 on its K/V-resident schedule) against the JAX
``flash_attention_v2`` the same way, and against the port's v1.

Tolerances. f32: the two sum the same products in different orders, 2e-6
absolute on outputs of magnitude ≤ 1 (random keys, softmax-weighted
averages of N(0, 1) values). bf16: both round ``p`` to bf16 against the same
per-block running max and sum in f32; outputs may still round to the
neighbouring bf16 value, so 2 bf16 steps at the output's magnitude (2^-7
relative) plus 1e-3 absolute for outputs near zero."""

import importlib
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu_torch.kernels import flash_attention as tfa
from multimodal_embeddings_tpu_torch.kernels import encoder_attention as tk1
from multimodal_embeddings_tpu_torch.models import transformer as ttr

# the JAX kernels package re-exports the function under the module's name
jfa = importlib.import_module("multimodal_embeddings_tpu.kernels.flash_attention")
torch.set_num_threads(2)


def _inputs(seed, b, l, h, kvh, dk, dv):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, l, h, dk)).astype(np.float32)
    k = rng.normal(size=(b, l, kvh, dk)).astype(np.float32)
    v = rng.normal(size=(b, l, kvh, dv)).astype(np.float32)
    return q, k, v


CASES = [
    # (b, l, h, kvh, dk, dv, causal, lengths)
    (1, 130, 2, 2, 16, 16, False, None),
    (2, 129, 4, 2, 16, 16, True, None),  # GQA 2, causal, ragged L
    (2, 200, 2, 1, 24, 40, False, (200, 57)),  # Dk != Dv, lengths
    (1, 127, 3, 3, 32, 32, True, (100,)),  # causal with lengths
    (1, 1, 2, 1, 16, 8, False, None),
    (2, 256, 5, 1, 16, 16, True, (1, 255)),  # GQA 5, lengths 1 and L-1
]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_f32(case):
    b, l, h, kvh, dk, dv, causal, lengths = case
    q, k, v = _inputs(l + h, b, l, h, kvh, dk, dv)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=None if lens is None else jnp.asarray(lens), causal=causal, interpret=True,
    )
    got = tfa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        lengths=None if lens is None else torch.from_numpy(lens), causal=causal,
    )
    assert got.shape == (b, l, h, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("case", [CASES[1], CASES[2], CASES[5]])
def test_plain_matches_pallas_bf16(case):
    b, l, h, kvh, dk, dv, causal, lengths = case
    q, k, v = _inputs(l + 7, b, l, h, kvh, dk, dv)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    want = jfa.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        lengths=None if lens is None else jnp.asarray(lens), causal=causal, interpret=True,
    )
    got = tfa.flash_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        lengths=None if lens is None else torch.from_numpy(lens), causal=causal,
    )
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7, atol=1e-3)


def test_block_loop_rounds_p_per_block():
    """bf16: the block loop is not a whole-row softmax — rounding p against
    each block's running max gives other bits than one max over the row,
    and the block loop is the one that equals the Pallas kernel bit for
    bit here."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _inputs(3, 1, 384, 2, 2, 16, 16))
    got = tfa.flash_attention(q, k, v)
    whole = tk1.encoder_attention_reference(q, k, v)
    want = jfa.flash_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                               interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert (got.float() - want).abs().max() <= (whole.float() - want).abs().max()
    assert not torch.equal(got, whole)


def test_launch_counter_and_dispatch():
    q = torch.zeros(1, 4, 2, 8)
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, q, q)  # CPU: plain version
    assert tfa.flash_attention.launches == before
    with pytest.raises(ValueError):  # only a CPU tensor takes the plain version
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q[:, :3], q)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, lengths=torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_takes_k4_at_2048(causal, monkeypatch):
    """Port ``sdpa`` at L = 2048 (the flash threshold) goes to K4 and agrees
    with JAX ``sdpa`` (the XLA path on the CPU) in f32."""
    b, l, h, kvh, d = 1, 2048, 2, 1, 16
    q, k, v = _inputs(11, b, l, h, kvh, d, d)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(ttr, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = ttr.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    want = jtr.sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_sdpa_kv_lengths_takes_k4_at_2048(monkeypatch):
    b, l, h, d = 2, 2048, 2, 16
    q, k, v = _inputs(12, b, l, h, h, d, d)
    lens = np.asarray([2048, 700], np.int32)
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(ttr, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = ttr.sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                   kv_lengths=torch.from_numpy(lens))
    want = jtr.sdpa(*(jnp.asarray(a) for a in (q, k, v)), kv_lengths=jnp.asarray(lens))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize(
    "l,kvh,mask,causal,want_route",
    [(2047, 2, False, False, "xla"), (1024, 2, False, False, "k1"), (1030, 2, False, False, "xla"),
     (1024, 1, False, False, "xla"), (1024, 2, True, False, "xla"), (512, 2, False, True, "xla"),
     (2048, 1, False, True, "k4"), (128, 2, False, False, "xla")],
)
def test_sdpa_dispatch_order(l, kvh, mask, causal, want_route, monkeypatch):
    """The JAX package's order on a TPU: flash at L ≥ 2048 unmasked, the
    whole-row kernel for unmasked non-causal self-attention without GQA at
    L ∈ [256, 1664], L % 16 = 0, else the XLA path."""
    routes = []
    monkeypatch.setattr(ttr, "flash_attention", lambda *a, **kw: routes.append("k4"))
    monkeypatch.setattr(ttr, "encoder_attention", lambda *a, **kw: routes.append("k1"))
    q = torch.zeros(1, l, 2, 8)
    k = torch.zeros(1, l, kvh, 8)
    m = torch.ones(1, 1, 1, l, dtype=torch.bool) if mask else None
    out = ttr.sdpa(q, k, k, mask=m, causal=causal)
    assert routes == ([] if want_route == "xla" else [want_route])
    if want_route == "xla":
        assert out.shape == (1, l, 2, 8)


@pytest.mark.parametrize("l,valid,want_route", [(1608, 1601, "k1"), (100, 90, "xla"),
                                                (1600, 1600, "k1"), (1608, 1608, "xla"),
                                                (2048, 2000, "xla")])
def test_sdpa_key_valid_len_dispatch(l, valid, want_route, monkeypatch):
    """A static key prefix goes to K1 where the whole-row kernel takes L
    padded to 16 (else a key mask on the XLA path); a prefix covering every
    key is no mask at all."""
    routes = []
    monkeypatch.setattr(ttr, "encoder_attention",
                        lambda *a, **kw: routes.append(("k1", kw.get("valid_len"))))
    rng = np.random.default_rng(l)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, l, 2, 8)).astype(np.float32))
               for _ in range(3))
    out = ttr.sdpa(q, k, v, key_valid_len=valid)
    if want_route == "k1":
        assert routes == [("k1", None if valid >= l else valid)]
    else:
        assert routes == []
        want = jtr.sdpa(*(jnp.asarray(t.numpy()) for t in (q, k, v)), key_valid_len=valid)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6)


# --- K4 on its K/V-resident schedule (flash_attention_v2) ------------------

V2_CASES = [
    # (b, l, h, kvh, dk, dv, causal, lengths): the JAX tests' own cases
    # (tests/test_flash_attention.py::TestFlashV2), then GQA
    (2, 256, 4, 4, 64, 64, False, None),
    (2, 384, 4, 4, 64, 64, True, None),
    (2, 200, 4, 4, 64, 64, False, None),
    (2, 256, 3, 3, 32, 64, False, (256, 130)),
    (2, 129, 4, 2, 16, 24, True, (129, 40)),
]


def _both_v2(case, seed, dtype):
    b, l, h, kvh, dk, dv, causal, lengths = case
    q, k, v = _inputs(seed, b, l, h, kvh, dk, dv)
    lens = None if lengths is None else np.asarray(lengths, np.int32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jfa.flash_attention_v2(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        lengths=None if lens is None else jnp.asarray(lens), causal=causal, interpret=True,
    )
    got = tfa.flash_attention_v2(
        *(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
        lengths=None if lens is None else torch.from_numpy(lens), causal=causal,
    )
    assert got.shape == (b, l, h, dv) and got.dtype == dtype
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("case", V2_CASES)
def test_v2_plain_matches_pallas_v2_f32(case):
    """Tolerance 2e-5, the JAX tests' own for v2."""
    got, want = _both_v2(case, 20 + case[1], torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("case", [V2_CASES[1], V2_CASES[3], V2_CASES[4]])
def test_v2_plain_matches_pallas_v2_bf16(case):
    """2 bf16 steps at the output's magnitude, plus 1e-3 absolute for
    outputs near zero (the module docstring's bf16 tolerance)."""
    got, want = _both_v2(case, 30 + case[1], torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_plain_is_the_v1_plain(dtype):
    """v2 is v1's contract on another schedule: on the CPU both wrappers
    give the same bits."""
    for case in (V2_CASES[1], V2_CASES[4]):
        b, l, h, kvh, dk, dv, causal, lengths = case
        q, k, v = (torch.from_numpy(a).to(dtype) for a in _inputs(l, b, l, h, kvh, dk, dv))
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
        assert torch.equal(tfa.flash_attention_v2(q, k, v, lengths=lens, causal=causal),
                           tfa.flash_attention(q, k, v, lengths=lens, causal=causal))


def test_v2_launch_counter_and_dispatch():
    q = torch.zeros(1, 4, 2, 8)
    before = (tfa.flash_attention.launches, tfa.flash_attention_v2.launches)
    tfa.flash_attention_v2(q, q, q)  # CPU: plain version
    assert (tfa.flash_attention.launches, tfa.flash_attention_v2.launches) == before
    with pytest.raises(ValueError):  # only a CPU tensor takes the plain version
        tfa.flash_attention_v2(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError):
        tfa.flash_attention_v2(q, q[:, :3], q)


def test_attn_candidates_script_runs_on_the_cpu():
    """``scripts/torch_attn_candidates_bench.py`` at L cut to 48: every case
    times its three candidates; no kernel launches on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "torch_attn_candidates_bench",
        pathlib.Path(__file__).parent.parent / "scripts" / "torch_attn_candidates_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    results = bench.run(iters=1, device="cpu", max_len=48)
    assert list(results) == [name for name, _, _ in bench.CASES]
    assert [r["valid"] for r in results.values()] == [48, 41, 20]
    for r in results.values():
        assert all(r[key] > 0 for key in ("sdpa_ms", "flash_v1_ms", "flash_v2_ms"))
        assert r["launches"] == {"flash_attention": 0, "flash_attention_v2": 0}


# --- the launch plan of the bf16 wgmma kernel --------------------------------

_ROW = (1 << 20) * 64  # a 64-byte-aligned base address


def _ops(*operands):
    """(base, (batch, row, head) strides) triples for ``_plan``, each given
    as (element offset from an aligned base, strides)."""
    return [(_ROW + 2 * off, strides) for off, strides in operands]


@pytest.mark.parametrize("name,offset,strides,path,width", [
    # the Qwen vision v: qkv[:, :, 2] of a (1, 4960, 3, 16, 80) projection
    ("qwen qkv v slice", 2 * 16 * 80, (4960 * 3 * 16 * 80, 3 * 16 * 80, 80), "tma", 0),
    ("contiguous (B, L, H, D)", 0, (1608 * 16 * 80, 16 * 80, 80), "tma", 0),
    ("row stride of 40 bf16", 0, (300 * 40, 40, 0), "tma", 0),
    ("base 8 bytes off", 4, (300 * 4 * 64, 4 * 64, 64), "cp.async", 8),
    ("base 4 bytes off", 2, (300 * 4 * 64, 4 * 64, 64), "cp.async", 4),
    ("row stride of 36 bf16", 0, (300 * 2 * 36, 2 * 36, 36), "cp.async", 8),
    ("row stride of 81 bf16", 0, (300 * 81, 81, 0), "cp.async", 2),
])
def test_plan_path_per_operand(name, offset, strides, path, width):
    """TMA takes a 16-byte-aligned base and strides that are multiples of 16
    bytes; anything else goes through cp.async at the widest copy that
    divides them, per operand (the other two stay on TMA)."""
    heads = 1 if strides[2] == 0 else 2
    good = (0, (300 * heads * 64, heads * 64, 64))
    for i in range(3):
        ops = [good] * 3
        ops[i] = (offset, strides)
        plan = tfa._plan(2, 300, heads, heads, 64, 64, _ops(*ops), v2=False)
        want_paths = ["tma"] * 3
        want_paths[i] = path
        assert plan.paths == tuple(want_paths), (name, i, plan)
        assert plan.widths[i] == width and sum(plan.widths) == width, (name, plan)


def test_plan_shared_memory_fits_every_head_dim():
    """Every (Dk, Dv) ≤ 128: dims padded to 16, 2-4 ring stages, the bytes
    within the 227 KB a CTA may take (the card's 80/80 plan: 4 stages)."""
    ops = _ops(*[(0, (1 << 20, 1 << 12, 128))] * 3)
    for dk in range(1, 129):
        for dv in range(1, 129):
            plan = tfa._plan(1, 256, 1, 1, dk, dv, ops, v2=False)
            assert plan.dkp == -(-dk // 16) * 16 and plan.dvp == -(-dv // 16) * 16
            assert 2 <= plan.stages <= 4 and plan.smem <= 232448, (dk, dv, plan)
            if plan.stages < 4:  # one more stage would not fit
                bigger = plan.smem + 2 * 128 * (tfa._dim_cols(plan.dkp) + tfa._dim_cols(plan.dvp))
                assert bigger > 232448
    assert tfa._plan(1, 256, 1, 1, 40, 56, ops, v2=False)[:2] == (48, 64)
    assert tfa._plan(1, 256, 1, 1, 40, 56, ops, v2=False).smem == 148560
    assert tfa._plan(1, 256, 1, 1, 80, 80, ops, v2=False)[4:] == (4, 1, 1, 185424)
    assert tfa._plan(1, 256, 1, 1, 128, 128, ops, v2=False)[4:] == (3, 1, 1, 230480)


@pytest.mark.parametrize("b,l,h,want", [
    (1, 4960, 1, (8, 5)),     # B·H = 1: 39 query tiles over 40 CTAs
    (2, 6432, 16, (4, 1)),    # B·H = 32: 128 CTAs of 13 tiles
    (48, 784, 16, (1, 1)),    # B·H = 768 fills the card alone
    (1, 1100, 2, (8, 2)),     # 9 query tiles, not a multiple of C
])
def test_plan_v2_cluster(b, l, h, want):
    """v2's cluster size C and clusters per head S: the fewest rounds of
    query-tile steps for one CTA per SM; v1 always 1 and 1."""
    ops = _ops(*[(0, (l * h * 80, h * 80, 80))] * 3)
    plan = tfa._plan(b, l, h, h, 80, 80, ops, v2=True)
    assert (plan.cluster, plan.splits) == want
    nq = -(-l // 128)
    assert plan.cluster * plan.splits <= max(nq, 1) * 2 and plan.cluster <= 8
    assert b * h * plan.cluster * plan.splits <= max(132, b * h)
    assert tfa._plan(b, l, h, h, 80, 80, ops, v2=False)[5:7] == (1, 1)


def test_plan_v2_cluster_reads_the_card():
    """With the H100's answer (132 CTAs resident in clusters of 1 or 2, 120
    in clusters of 4 or 8) the 4-tile shape takes C = 2 and S = 2: 128 CTAs
    in one wave, where C = 4 would need two."""
    resident = {1: 132, 2: 132, 4: 120, 8: 120}
    ops = _ops(*[(0, (6432 * 16 * 80, 16 * 80, 80))] * 3)
    plan = tfa._plan(2, 6432, 16, 16, 80, 80, ops, True, lambda dvp, smem, c: resident[c])
    assert (plan.cluster, plan.splits) == (2, 2)


def test_plan_ignores_causal_and_lengths():
    """The plan is a function of shapes and addresses only: causal and
    lengths never enter it, so v1 and v2 run one form on one input."""
    import inspect

    assert list(inspect.signature(tfa._plan).parameters) == [
        "b", "l", "h", "kvh", "dk", "dv", "operands", "v2", "resident"]
    q = torch.zeros(1, 300, 4, 40, dtype=torch.bfloat16)
    kv = torch.zeros(1, 300, 2, 56, dtype=torch.bfloat16)
    assert tfa.plan_for(q, kv[..., :40], kv) == tfa.plan_for(q, kv[..., :40], kv)
    assert tfa.plan_for(q, kv[..., :40], kv).paths == ("tma", "tma", "tma")


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """Head dims past 128, a non-unit feature stride, other dtypes and
    mismatched shapes raise before any launch."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    tfa._kernel_checks(q, q, q)
    big = torch.zeros(1, 8, 2, 129, dtype=torch.bfloat16)
    for args in ((big, big, q), (q, q, big), (q, q, q.half()), (q.half(),) * 3,
                 (q, q, torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16)[..., ::2])):
        with pytest.raises(ValueError):
            tfa._kernel_checks(*args)
    for fn in (tfa.flash_attention, tfa.flash_attention_v2):
        with pytest.raises(ValueError):
            fn(q, q[:, :7], q)
        with pytest.raises(ValueError):
            fn(q, torch.zeros(1, 8, 3, 64, dtype=torch.bfloat16), q)
        with pytest.raises(ValueError):
            fn(q.to("meta"), q.to("meta"), q.to("meta"))
