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


# (M, K, N) of the mmE5-11B text stack (chip_smoke.py's K2_SHAPES)
_K2_SHAPES = [(512, 4096, 4096), (512, 4096, 1024), (512, 4096, 14336), (512, 14336, 4096),
              (12808, 4096, 1024)]


@pytest.mark.parametrize("m,k,n", _K2_SHAPES)
def test_int8_mm_form_takes_wgmma_at_the_text_shapes(m, k, n):
    assert tq.int8_mm_form(m, k, n) == "wgmma"
    assert tq.int8_mm_form(m, k, n, dtype=torch.float32) == "f32"


@pytest.mark.parametrize("m,k,n,aligned", [
    (4, 4096, 1024, True),     # M <= 4
    (1, 8, 16, True),
    (37, 200, 136, True),      # N % 16 != 0
    (300, 1000, 1030, True),   # N % 16 != 0
    (130, 72, 200, True),      # N % 16 != 0
    (64, 1020, 256, True),     # K % 8 != 0
    (64, 1024, 256, False),    # a base off 16 bytes
])
def test_int8_mm_form_falls_back_to_mma_sync(m, k, n, aligned):
    assert tq.int8_mm_form(m, k, n, aligned) == "mma_sync"


def test_int8_form_for_reads_the_operands_alignment():
    """``form_for`` takes the alignment from the contiguous operands it
    hands the kernel: an x view 8 bytes into its buffer is refused."""
    q, s = torch.zeros(256, 64, dtype=torch.int8), torch.ones(64)
    buf = torch.zeros(8 * 256 + 4, dtype=torch.bfloat16)
    base = buf.data_ptr() % 16
    x = buf[(16 - base) % 16 // 2:][: 8 * 256].view(8, 256)  # 16-byte aligned view
    assert tq.form_for(x, q, s) == ("wgmma" if tq._aligned(q, s) else "mma_sync")
    off = buf[((16 - base) % 16 + 8) % 16 // 2:][: 8 * 256].view(8, 256)
    assert off.data_ptr() % 16 == 8
    assert tq.form_for(off, q, s) == "mma_sync"
    assert tq.form_for(x.float(), q, s) == "f32"


_PLANS = [(*shape, 132) for shape in _K2_SHAPES] + [
    (5, 1024, 256, 132), (129, 512, 384, 132), (300, 512, 48, 132), (200, 1024, 1040, 132),
    (64, 200, 256, 132), (1200, 512, 4736, 132), (256, 2048, 512, 132), (512, 4096, 1024, 8),
    (512, 4096, 14336, 2), (40, 128, 16, 132), (600, 20488, 1040, 132),
]


@pytest.mark.parametrize("m,k,n,ctas", _PLANS)
def test_int8_wgmma_plan_covers_every_unit_once(m, k, n, ctas):
    """Every (group, chunk) unit is in exactly one cluster's share, each
    sequence's shares are contiguous in order and differ in size by at most
    one unit, no cluster is left without work, and a sequence is one M
    tile's groups where the card holds 8 clusters per M tile."""
    plan = tq.int8_wgmma_plan(m, k, n, ctas)
    tm = plan.tile_m
    assert tm == tq.wgmma_tile_m(m, k, n, ctas) and tm in (128, 256)
    chunk = {128: 128, 256: 64}[tm]
    assert plan.mt == -(-m // tm) and plan.nt == -(-n // 128) and plan.nchunks == -(-k // chunk)
    assert plan.seqs == (plan.mt if 8 * plan.mt <= ctas // 2 else 1)
    assert plan.ws_floats == plan.grid * 2 * 2 * 128 * tm // 2
    assert plan.grid % plan.cluster == 0 and plan.grid <= max(ctas, plan.cluster)
    assert plan.clusters % plan.seqs == 0
    assert plan.sets == min(ctas // plan.cluster // plan.seqs, plan.units // plan.seqs)
    shares = [plan.share(j) for j in range(plan.sets)]
    assert shares[0][0] == 0 and shares[-1][1] == plan.units // plan.seqs
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [b - a for a, b in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    covered = np.zeros((plan.groups, plan.nchunks), np.int64)
    for c in range(plan.clusters):
        units = plan.units_of(c)
        assert units and len({g % plan.mt for g, _ in units} if plan.seqs > 1 else {0}) == 1
        for g, ch in units:
            covered[g, ch] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,k,n,ctas", _PLANS)
def test_int8_wgmma_plan_orders_a_cut_tiles_partials(m, k, n, ctas):
    """A group's contributors are listed in cluster order with ascending,
    adjacent chunk ranges that cover the group once: the fixed order in
    which the kernel sums a cut tile's partials (k order)."""
    plan = tq.int8_wgmma_plan(m, k, n, ctas)
    cut = 0
    for g in range(plan.groups):
        parts = plan.contributors(g)
        assert [c for c, _, _ in parts] == sorted(c for c, _, _ in parts)
        assert parts[0][1] == 0 and parts[-1][2] == plan.nchunks
        assert all(a[2] == b[1] and a[1] < a[2] for a, b in zip(parts, parts[1:]))
        # the contributors are adjacent sets of one sequence: the kernel
        # finds them by walking the share starts from its own
        seqs = plan.seqs
        assert [c % seqs for c, _, _ in parts] == [g % seqs] * len(parts)
        sets = [c // seqs for c, _, _ in parts]
        assert sets == list(range(sets[0], sets[-1] + 1))
        cut += len(parts) > 1
    assert cut == plan.cut_groups()


@pytest.mark.parametrize("tile_m", [128, 256])
def test_int8_wgmma_plan_at_the_text_shapes(tile_m):
    """At the card's 132 CTAs: k,v keeps 64 or 66 clusters busy (its groups
    cut into 512 units), gate,up's 7,168 units give shares of 108-109 (no
    partial wave), each M tile its own sequence; the cross-attention k,v's
    51 or 101 M tiles share one."""
    mt = 512 // tile_m
    kv = tq.int8_wgmma_plan(512, 4096, 1024, 132, tile_m)
    assert (kv.tile_m, kv.units, kv.seqs, kv.clusters) == (tile_m, 512, mt, 66 // mt * mt)
    assert kv.groups == mt * 4 and kv.cut_groups() == kv.groups
    gu = tq.int8_wgmma_plan(512, 4096, 14336, 132, tile_m)
    assert (gu.groups, gu.units, gu.seqs) == (mt * 56, 7168, mt)
    assert {b - a for a, b in map(gu.share, range(gu.sets))} == (
        {108, 109} if tile_m == 256 else {112})
    cross = tq.int8_wgmma_plan(12808, 4096, 1024, 132, tile_m)
    assert cross.seqs == 1 and cross.clusters == 66
    one = tq.int8_wgmma_plan(512, 4096, 1024, 2 * kv.groups, tile_m)  # a cluster per group
    assert one.cut_groups() == 0 and one.clusters == one.groups


@pytest.mark.parametrize("m,k,n,tile_m,seqs", [
    (512, 4096, 4096, 128, 4),    # q,o: 32-chunk shares, none cut on 128 rows
    (512, 4096, 1024, 128, 4),    # k,v
    (512, 4096, 14336, 256, 2),   # gate,up
    (512, 14336, 4096, 256, 2),   # down
    (12808, 4096, 1024, 256, 1),  # cross k,v: 51 M tiles share one sequence
    (600, 20488, 1040, 256, 3),
    (128, 65536, 4096, 128, 1),   # M <= 128
])
def test_int8_wgmma_tile_and_sequence_rules(m, k, n, tile_m, seqs):
    """256-row tiles where a share of the 256-row plan holds at least 64
    chunks; a sequence per M tile where the card holds 8 clusters per M
    tile."""
    plan = tq.int8_wgmma_plan(m, k, n, 132)
    assert (plan.tile_m, plan.seqs) == (tile_m, seqs)


def test_int8_matmul_plain_matches_pallas_at_a_narrowed_text_shape():
    """K2's plain version (the CPU path) against the JAX Pallas kernel in
    interpret mode at a narrowed text-stack shape, f32 (rtol 1e-5) and bf16
    (2 bf16 steps over the f32 floor)."""
    rng = _rng(13)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    q = rng.integers(-127, 128, size=(512, 384)).astype(np.int8)
    scale = (rng.uniform(0.5, 1.5, size=(1, 384)) * 0.02 / 127).astype(np.float32)
    want = jq.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), interpret=True)
    _close(tq.int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(scale)).numpy(), want)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q),
                                     jnp.asarray(scale), interpret=True).astype(jnp.float32))
    got = tq.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(q),
                         torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                               atol=1e-5 * np.abs(want).max())


def test_int8_matmul_cpu_dispatch_at_a_wgmma_shape():
    """A CPU tensor at a shape the wgmma form takes still goes to the plain
    version: the same values, no launch counted, no workspace made."""
    rng = _rng(14)
    x = torch.from_numpy(rng.normal(size=(64, 512)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, size=(512, 384)).astype(np.int8))
    s = torch.from_numpy((rng.uniform(0.5, 1.5, size=(384,)) * 0.02 / 127).astype(np.float32))
    assert tq.int8_mm_form(64, 512, 384) == "wgmma"
    before, scratch, args = tq.int8_matmul.launches, dict(tq._scratch), dict(tq._launch_args)
    got = tq.int8_matmul(x, q, s)
    assert tq.int8_matmul.launches == before
    assert tq._scratch == scratch and tq._launch_args == args
    assert torch.equal(got, tq.int8_matmul_reference(x, q, s))


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
