"""Packed int4: the port's quantization helpers, K3's plain version and
``Int4Dense`` against the JAX package, plus the synthetic int4 weights of
``models/quantized.py``.

K3's plain version is held against the JAX Pallas kernel in interpret mode.
Both round x to bf16, sum the group's exact bf16·int4 products in f32 and add
``part · scale`` group by group; they differ only in the order of the
within-group sums, so outputs agree to f32 round-off: rtol 1e-5 with an
absolute floor of 1e-5·max|y| for outputs that cancel to near zero.

``Int4Dense`` is held against ``Int4DenseGeneral`` twice: once with the JAX
module's Pallas kernel in interpret mode (the same tolerance), and once with
its CPU fallback, which dequantizes first and does NOT round x to bf16. The
second differs by the bf16 rounding of x: each product moves by at most
2^-9 of itself, so the tolerance is 2^-8 · (|x| @ |W|) per output."""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import quantization_int4 as jq4
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu_torch.kernels import quantization_int4 as tq4
from multimodal_embeddings_tpu_torch.models import quantized as tquant
from multimodal_embeddings_tpu_torch.models.weights import load_jax_params

torch.set_num_threads(2)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), want, rtol=1e-5, atol=1e-5 * np.abs(want).max()
    )


@pytest.mark.parametrize("k,n,group", [(256, 48, 128), (200, 24, 128), (64, 16, 128),
                                       (384, 8, 64)])
def test_quantize_unpack_dequantize_are_bit_exact(k, n, group):
    w = (_rng(k + n).normal(size=(k, n)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 floor
    want = jq4.quantize_tensor_int4(jnp.asarray(w), group_size=group)
    got = tq4.quantize_tensor_int4(torch.from_numpy(w), group_size=group)
    assert got.packed.dtype == torch.uint8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tq4.unpack_int4(got).numpy(), np.asarray(jq4.unpack_int4(want)))
    for dtype in (torch.float32, torch.bfloat16):
        jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
        np.testing.assert_array_equal(
            tq4.dequantize_int4(got, dtype).float().numpy(),
            np.asarray(jq4.dequantize_int4(want, jdt).astype(jnp.float32)),
        )


@pytest.mark.parametrize("k", [2, 100, 127 * 2, 256, 130])
def test_group_size_rule(k):
    assert tq4.int4_group_size(k) == jq4.int4_group_size(k)
    with pytest.raises(ValueError):
        tq4.int4_group_size(k + 1)


def _q4(rng, k, n, n_groups):
    packed = rng.integers(0, 256, size=(k // 2, n)).astype(np.uint8)
    scale = rng.normal(scale=0.02, size=(n_groups, n)).astype(np.float32)
    return packed, scale


@pytest.mark.parametrize(
    "m,k,n,n_groups",
    [(8, 512, 128, 4), (37, 256, 136, 2), (1, 384, 40, 3), (5, 200, 24, 1),
     (130, 128, 128, 1), (2, 72, 16, 1)],
)
def test_int4_matmul_plain_matches_pallas(m, k, n, n_groups):
    """f32 x, rounded to bf16 by both; ragged M/N and single-group K."""
    rng = _rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed, scale = _q4(rng, k, n, n_groups)
    want = jq4.int4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                           interpret=True)
    got = tq4.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scale))
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_plain_rounds_f32_x_to_bf16():
    """An f32 x and its bf16 rounding give the same f32 output; the JAX CPU
    fallback (no rounding) does not."""
    rng = _rng(3)
    x = rng.normal(size=(4, 256)).astype(np.float32)
    packed, scale = _q4(rng, 256, 32, 2)
    p, s = torch.from_numpy(packed), torch.from_numpy(scale)
    a = tq4.int4_matmul(torch.from_numpy(x), p, s)
    b = tq4.int4_matmul(torch.from_numpy(x).bfloat16().float(), p, s)
    assert torch.equal(a, b)
    fallback = np.asarray(jq4.int4_apply(jnp.asarray(x), jq4.Q4Tensor(jnp.asarray(packed),
                                                                     jnp.asarray(scale))))
    assert not np.array_equal(a.numpy(), fallback)


def test_int4_matmul_plain_bf16_matches_pallas_bf16():
    """bf16 x, bf16 out: the same f32 sums rounded once; tolerance 2 bf16
    steps (2^-7 relative) over the f32 floor."""
    rng = _rng(5)
    x = rng.normal(size=(16, 512)).astype(np.float32)
    packed, scale = _q4(rng, 512, 128, 4)
    want = jq4.int4_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(packed),
                           jnp.asarray(scale), interpret=True)
    got = tq4.int4_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(packed),
                          torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5 * np.abs(want).max())


def test_int4_apply_keeps_leading_axes():
    rng = _rng(6)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    packed, scale = _q4(rng, 256, 24, 2)
    qt = tq4.Q4Tensor(torch.from_numpy(packed), torch.from_numpy(scale))
    got = tq4.int4_apply(torch.from_numpy(x), qt)
    want = tq4.int4_matmul(torch.from_numpy(x.reshape(6, 256)), qt.packed, qt.scale)
    assert got.shape == (2, 3, 24)
    assert torch.equal(got.reshape(6, 24), want)


def test_launch_counter_and_dispatch():
    x, p, s = torch.zeros(4, 8), torch.zeros(4, 16, dtype=torch.uint8), torch.ones(1, 16)
    before = tq4.int4_matmul.launches
    tq4.int4_matmul(x, p, s)  # CPU: plain version
    assert tq4.int4_matmul.launches == before
    with pytest.raises(ValueError):  # only a CPU tensor takes the plain version
        tq4.int4_matmul(x.to("meta"), p.to("meta"), s.to("meta"))
    with pytest.raises(ValueError):
        tq4.int4_matmul(x, p.to(torch.int8), s)
    with pytest.raises(ValueError):
        tq4.int4_matmul(x, p[:2], s)
    with pytest.raises(ValueError):
        tq4.int4_matmul(x, p, torch.ones(3, 16))


# (M, K, N, n_groups) of the GEMV form: the Qwen2.5-VL-32B decode shapes and
# the chip check's GEMV edge cases
GEMV_SHAPES = {
    "q,o": (1, 5120, 5120, 40), "k,v": (1, 5120, 1024, 40),
    "gate,up": (1, 5120, 27648, 40), "down": (1, 27648, 5120, 216),
    "lm_head": (1, 5120, 152064, 40),
    "M 2": (2, 5120, 1024, 40), "M 3": (3, 5120, 1024, 40), "M 4": (4, 5120, 1024, 40),
    "N 1030": (1, 5120, 1030, 40), "N 40": (3, 2048, 40, 16),
    "one group of 100 rows": (2, 200, 520, 1), "shares cross tiles": (1, 16384, 16384, 128),
    "K 8": (1, 8, 16, 1), "element loads": (4, 1024, 768, 8),
    "group wider than the x window M 4": (4, 2048, 520, 1),
    "group wider than the x window M 2": (2, 4096, 256, 1),
    "groups wider than the x window M 1": (1, 8192, 300, 2),
    "wide groups, tiles cut": (1, 20480, 300, 5),
}


@pytest.mark.parametrize("ctas", [264, 132, 7])
@pytest.mark.parametrize("name", list(GEMV_SHAPES))
def test_gemv_plan_covers_every_tile_row_once(name, ctas):
    """The shares of ``gemv_plan`` cover every (256-column tile, packed row)
    exactly once; each starts and ends on a group boundary (a tile edge is
    one); no share is empty; the grid never exceeds the CTAs asked for; the
    shares differ by at most one unit."""
    m, k, n, n_groups = GEMV_SHAPES[name]
    plan = tq4.gemv_plan(m, k, n, n_groups, ctas)
    assert plan.mt == (1 if m == 1 else 2 if m == 2 else 4)
    assert plan.tiles == -(-n // 256) and plan.n_groups == n_groups
    assert 1 <= plan.grid <= min(ctas, plan.units)
    half = k // n_groups // 2
    covered = np.zeros((plan.tiles, k // 2), np.int32)
    sizes = []
    for c in range(plan.grid):
        u0, u1 = plan.share(c)
        assert u1 > u0
        sizes.append(u1 - u0)
        for u in range(u0, u1):
            t, g = divmod(u, n_groups)
            covered[t, g * half:(g + 1) * half] += 1
    assert (covered == 1).all()
    assert plan.share(0)[0] == 0 and plan.share(plan.grid - 1)[1] == plan.units
    assert max(sizes) - min(sizes) <= 1
    if plan.grid < ctas:  # few units: at least _GEMV_MIN_UNITS per CTA where possible
        assert plan.grid == max(1, -(-plan.units // tq4._GEMV_MIN_UNITS))


def test_gemv_plan_cut_tiles_and_checks():
    """A tile is cut when more than one CTA shares it; the plan refuses more
    than 4 rows and a grid of no CTA."""
    whole = tq4.GemvPlan(1, 4, 10, 2)  # 40 units, 20 per CTA: tiles 0-1 and 2-3
    assert whole.cut_tiles() == 0
    cut = tq4.GemvPlan(1, 4, 10, 3)  # 14, 13, 13 units: tiles 1 and 2 are cut
    assert [cut.share(c) for c in range(3)] == [(0, 14), (14, 27), (27, 40)]
    assert cut.cut_tiles() == 2
    # the chip check's wide-group edge: 6 units, 2 per CTA, both tiles cut
    assert tq4.gemv_plan(*GEMV_SHAPES["wide groups, tiles cut"], 264).cut_tiles() == 2
    with pytest.raises(ValueError):
        tq4.gemv_plan(5, 256, 256, 2, 264)
    with pytest.raises(ValueError):
        tq4.gemv_plan(1, 256, 256, 2, 0)


def _int4_flat(module, x, seed):
    flat = traverse_util.flatten_dict(unbox(module.init(jax.random.PRNGKey(0), x)), sep="/")
    rng = _rng(seed)
    for key, val in flat.items():
        if key.endswith("kernel_q4"):
            flat[key] = rng.integers(0, 256, size=val.shape).astype(np.uint8)
        elif key.endswith("kernel_scale"):
            flat[key] = rng.normal(scale=0.02, size=val.shape).astype(np.float32)
        else:
            flat[key] = rng.normal(scale=0.1, size=val.shape).astype(np.float32)
    return flat


def _interpret_apply(x, qt, use_kernel=None):
    lead = x.shape[:-1]
    y = jq4.int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale, interpret=True)
    return y.reshape(*lead, qt.packed.shape[-1])


@pytest.mark.parametrize("features,bias,in_f", [(24, True, 256), ((4, 6), True, 40),
                                                (16, False, 384)])
@pytest.mark.parametrize("jax_path", ["pallas_interpret", "cpu_fallback"])
def test_int4_dense_matches_int4_dense_general(features, bias, in_f, jax_path, monkeypatch):
    x = _rng(7).normal(size=(2, 5, in_f)).astype(np.float32)
    jmod = jquant.Int4DenseGeneral(features=features, use_bias=bias, dtype=jnp.float32)
    flat = _int4_flat(jmod, jnp.asarray(x), seed=8)
    if jax_path == "pallas_interpret":
        monkeypatch.setattr(jquant, "int4_apply", _interpret_apply)
    want = np.asarray(jmod.apply(traverse_util.unflatten_dict(flat, sep="/"), jnp.asarray(x)))
    out = int(np.prod(features))
    shape = features if isinstance(features, tuple) else None
    port = load_jax_params(
        tquant.Int4Dense(in_f, out, bias=bias, dtype=torch.float32, bias_shape=shape), flat
    )
    assert port.kernel_q4.dtype == torch.uint8
    with torch.no_grad():
        got = port(torch.from_numpy(x)).reshape(want.shape).numpy()
    if jax_path == "pallas_interpret":
        _close(got, want)
    else:
        w = np.abs(np.asarray(jq4.dequantize_int4(
            jq4.Q4Tensor(jnp.asarray(flat["params/kernel_q4"]),
                         jnp.asarray(flat["params/kernel_scale"])),
            jnp.float32)))
        bound = 2.0**-8 * (np.abs(x) @ w).reshape(want.shape) + 1e-6
        assert np.all(np.abs(got - want) <= bound)


def test_quant_dense_cls():
    assert tquant.quant_dense_cls("int4") is tquant.Int4Dense
    assert tquant.quant_dense_cls(True) is tquant.Int8Dense
    assert tquant.quant_dense_cls("int8") is tquant.Int8Dense


def test_synthetic_int4_weights():
    """uint8 nibbles uniform over 0-255, 2-D f32 scales N(0, 0.02), the same
    draw for the same seed."""
    def make(seed):
        return tquant.synthetic_int8_init(
            tquant.materialize(tquant.Int4Dense(1024, 512, bias=True), "cpu", torch.float32),
            seed,
        )

    a, b = make(0), make(0)
    assert a.kernel_q4.dtype == torch.uint8 and a.kernel_scale.dtype == torch.float32
    assert a.kernel_scale.shape == (8, 512)
    assert torch.equal(a.kernel_q4, b.kernel_q4) and torch.equal(a.kernel_scale, b.kernel_scale)
    vals = a.kernel_q4.flatten().long()
    assert int(vals.min()) == 0 and int(vals.max()) == 255
    assert abs(vals.float().mean().item() - 127.5) < 1.0
    assert abs(a.kernel_scale.std().item() - 0.02) < 0.002
    assert torch.all(a.bias == np.float32(0.02))
    assert tquant.param_bytes(a) == 512 * 512 + 8 * 512 * 4 + 512 * 4


# (M, K, N, n_groups, 16-byte-aligned operands, form): the Qwen2.5-VL-32B
# projections at prefill (M = 1535) and decode, the chip check's ragged
# shapes, and its wgmma-form edges
FORM_CASES = {
    "prefill q,o": (1535, 5120, 5120, 40, True, "wgmma"),
    "prefill k,v": (1535, 5120, 1024, 40, True, "wgmma"),
    "prefill gate,up": (1535, 5120, 27648, 40, True, "wgmma"),
    "prefill down": (1535, 27648, 5120, 216, True, "wgmma"),
    "decode q,o": (1, 5120, 5120, 40, True, "gemv"),
    "decode gate,up": (1, 5120, 27648, 40, True, "gemv"),
    "decode down": (1, 27648, 5120, 216, True, "gemv"),
    "decode lm_head": (1, 5120, 152064, 40, True, "gemv"),
    "ragged G 200": (37, 200, 136, 1, True, "mma_sync"),
    "ragged K 8": (1, 8, 16, 1, True, "gemv"),
    "ragged G 72": (130, 72, 200, 1, True, "mma_sync"),
    "ragged N 1030": (300, 1024, 1030, 8, True, "mma_sync"),
    "ragged N 40": (5, 384, 40, 3, True, "mma_sync"),
    "ragged N 24": (9, 256, 24, 2, True, "mma_sync"),
    "ragged M 3": (3, 5120, 1030, 40, True, "gemv"),
    "ragged M 2": (2, 2048, 520, 16, True, "gemv"),
    "edge M 5": (5, 1024, 256, 8, True, "wgmma"),
    "edge M 129": (129, 512, 384, 4, True, "wgmma"),
    "edge N 1040": (200, 1024, 1040, 8, True, "wgmma"),
    "edge N 48": (300, 512, 48, 4, True, "wgmma"),
    "edge G 64": (64, 640, 256, 10, True, "wgmma"),
    "edge G 256": (300, 1024, 256, 4, True, "wgmma"),
    "edge one group of 512": (150, 512, 256, 1, True, "wgmma"),
    "edge 370 tiles": (1200, 512, 4736, 4, True, "wgmma"),
    "edge packed off 16 B": (64, 1024, 256, 8, False, "mma_sync"),
    "G 192": (64, 384, 256, 2, True, "mma_sync"),
}


@pytest.mark.parametrize("name", list(FORM_CASES))
def test_form_rule(name):
    """``mm_form`` is the launcher's rule: the GEMV for M <= 4; the wgmma
    form where TMA can describe every operand with whole chunks (G = 64 or a
    multiple of 128, N % 16 == 0, 16-byte-aligned bases), which every Qwen
    prefill projection takes; the mma.sync form for the rest. ``form_for``
    reads the alignment from the operands the kernel would get."""
    m, k, n, n_groups, aligned, form = FORM_CASES[name]
    assert tq4.mm_form(m, k, n, n_groups, aligned) == form
    if m * k + k // 2 * n <= 2**24:
        x = torch.zeros(m, k, dtype=torch.bfloat16)
        buf = torch.zeros(k // 2 * n + 8, dtype=torch.uint8)
        packed = (buf[:-8] if aligned else buf[8:]).view(k // 2, n)
        assert tq4.form_for(x, packed, torch.zeros(n_groups, n)) == form


def test_wgmma_grid():
    """CTAs in clusters of adjacent N tiles: as many as the card holds, never
    more than one cluster per tile group."""
    assert tq4.wgmma_grid(1535, 27648, 132, 2) == 132
    assert tq4.wgmma_grid(1535, 1024, 132, 2) == 96  # k,v: 12 x 4 tile pairs
    assert tq4.wgmma_grid(1535, 1040, 132, 2) == 120  # 9 N tiles: 5 pairs, one tile past N
    assert tq4.wgmma_grid(5, 48, 132, 2) == 2
    assert tq4.wgmma_grid(1535, 27648, 131, 2) == 130
    assert tq4.wgmma_grid(1535, 27648, 120, 4) == 120
    assert tq4.wgmma_grid(1535, 5120, 132, 1) == 132


def _bits_bf16(bits: torch.Tensor) -> torch.Tensor:
    """int32 values below 2^15 read as the bits of bf16 values, as f32."""
    return bits.to(torch.int16).view(torch.bfloat16).float()


def _q_pair(w: torch.Tensor, sel: int) -> torch.Tensor:
    """The kernel's ``q_pair`` on int64 words w, in torch bit operations:
    PRMT(w, 0, sel) (selector nibble i picks byte i of the result: 0-3 from
    w, 4-7 zero), then ``(t & 0x000F000F) | 0x43004300``, then the bf16x2 FMA
    ``t * 1 - 136``. Returns the (low half, high half) values as f32."""
    result = torch.zeros_like(w)
    for i in range(4):
        src = (sel >> (4 * i)) & 0xF
        byte = (w >> (8 * src)) & 0xFF if src < 4 else torch.zeros_like(w)
        result |= byte << (8 * i)
    t = (result & 0x000F000F) | 0x43004300
    return _bits_bf16(t & 0xFFFF) - 136.0, _bits_bf16(t >> 16) - 136.0


def test_bf16_nibble_trick_is_exact_for_every_byte():
    """``0x4300 | n`` is the bf16 128 + n, and 128 + n - 136 is exactly
    n - 8 in bf16, for the low and the high nibble of all 256 bytes."""
    b = torch.arange(256, dtype=torch.int64)
    for nib in (b & 15, b >> 4):
        v = _bits_bf16(0x4300 | nib)
        assert torch.equal(v, 128.0 + nib.float())
        q = (v.bfloat16() - torch.tensor(136.0, dtype=torch.bfloat16)).float()
        assert torch.equal(q, (nib - 8).float())


def test_dequant_word_selectors_follow_the_layout():
    """The kernel's four ``q_pair`` calls per word (selectors 0x4140,
    0x4342, and the word shifted right 4 for the high nibbles) give, for 16
    packed bytes of a row, the 16 columns' low-nibble q then their
    high-nibble q in column order: ``unpack_int4``'s rows p and G/2 + p."""
    rng = _rng(12)
    packed = rng.integers(0, 256, size=(8, 16)).astype(np.uint8)
    want = tq4.unpack_int4(tq4.Q4Tensor(torch.from_numpy(packed), torch.ones(1, 16))).float()
    words = torch.from_numpy(packed.view("<u4").astype(np.int64))  # (8, 4) little-endian words
    for shift, rows in ((0, want[:8]), (4, want[8:])):
        cols = []
        for c in range(4):
            w = words[:, c] >> shift
            for sel in (0x4140, 0x4342):
                lo, hi = _q_pair(w, sel)
                cols += [lo, hi]
        assert torch.equal(torch.stack(cols, dim=1), rows)


def _wgmma_order(x: np.ndarray, packed: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The wgmma form's arithmetic in its order, on the CPU: chunks of KC =
    64 (G = 64) or 128 weight rows; chunk ``sub`` of group g is packed rows
    g·G/2 + sub·KC/2 .. (+KC/2), dequantized by the bf16 trick into B rows
    low nibbles then high nibbles, against x columns g·G + sub·KC/2 .. and
    g·G + G/2 + sub·KC/2 ..; ``part`` starts from zero at each group's first
    chunk (scale-d = 0), and after the group's last chunk acc = fma(part,
    scale[g], acc) in f32 (the product exact in f64, one rounding)."""
    m, k = x.shape
    n_groups, n = scale.shape
    g = k // n_groups
    kc = 64 if g == 64 else 128
    half = kc // 2
    xb = torch.from_numpy(x).bfloat16().float()
    p = torch.from_numpy(packed.astype(np.int64))
    acc = torch.zeros(m, n, dtype=torch.float32)
    for grp in range(n_groups):
        part = torch.zeros(m, n, dtype=torch.float32)
        for sub in range(g // kc):
            rows = p[grp * g // 2 + sub * half: grp * g // 2 + (sub + 1) * half]
            b = torch.cat([_bits_bf16(0x4300 | (rows & 15)) - 136.0,
                           _bits_bf16(0x4300 | (rows >> 4)) - 136.0])
            lo = grp * g + sub * half
            a = torch.cat([xb[:, lo:lo + half], xb[:, lo + g // 2:lo + g // 2 + half]], dim=1)
            part = part + a @ b
        s = torch.from_numpy(scale[grp]).double()
        acc = (part.double() * s + acc.double()).float()
    return acc.numpy()


@pytest.mark.parametrize("m,k,n,n_groups", [(8, 512, 128, 4), (37, 512, 48, 2),
                                             (16, 640, 32, 10), (5, 512, 16, 1)])
def test_wgmma_order_emulation_matches_pallas(m, k, n, n_groups):
    """The wgmma form's order (G = 128, 256, 64, and one group of 512 rows
    in four chunks) against the JAX Pallas kernel in interpret mode. Both
    sum exact bf16·int4 products in f32 group by group, in different orders
    within a group: rtol 1e-5 with a floor of 1e-5·max|y|."""
    rng = _rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    packed, scale = _q4(rng, k, n, n_groups)
    want = jq4.int4_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scale),
                           interpret=True)
    assert tq4.mm_form(max(m, 5), k, n, n_groups) == "wgmma"
    _close(_wgmma_order(x, packed, scale), want)
