"""K1's plain PyTorch versions against the JAX Pallas kernels (interpret
mode) at the production head geometry, small L, f32; and the launch plan of
the CUDA kernel (``_plan``: padded head dims, copy widths, shared memory),
which is pure Python.

Tolerance 1e-5 absolute: both sides compute the same f32 arithmetic and
differ only in summation order over L ≤ 256 keys of O(1) terms."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import encoder_attention as jk1
from multimodal_embeddings_tpu.kernels.encoder_attention import (
    encoder_attention as jax_k1,
    encoder_attention_blf as jax_blf,
    encoder_attention_blf_packed as jax_blf_packed,
    encoder_attention_blhd as jax_blhd,
    encoder_attention_padded as jax_padded,
)
from multimodal_embeddings_tpu.models import transformer as jtr
from multimodal_embeddings_tpu_torch.kernels import encoder_attention as k1
from multimodal_embeddings_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run on one intra-op thread here. With two, in a
    process where XLA has run a Pallas kernel in interpret mode, the first
    ``torch.exp`` after a matmul computed the second thread's half of its
    output with a relative error of up to 1.5e-4 (about 3 in 16 fresh
    processes; every later call and every single-threaded run exact), which
    put ``test_blf_plain_matches_pallas[64-False]``, the first test of this
    file, 4.4e-5 off. The fault is in that first call, not in the port."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randn(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("l", [64, 256])
def test_blf_plain_matches_pallas(scratch, l):
    """ViT geometry: H=12, D=64."""
    q, k, v = (_randn(s, (2, l, 768)) for s in (1, 2, 3))
    want = jax_blf(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=12,
        interpret=True, scratch=scratch,
    )
    got = k1.encoder_attention_blf(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads=12
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("l", [64, 256])
def test_blf_packed_plain_matches_pallas(l):
    """PSA geometry: 4 heads of [q(36) | k(36) | v(72)]."""
    qkv = _randn(4, (2, l, 4 * 144))
    want = jax_blf_packed(
        jnp.asarray(qkv), heads=4, key_dim=36, head_dim=72, interpret=True
    )
    got = k1.encoder_attention_blf_packed(torch.from_numpy(qkv), 4, 36, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_blf_dv_differs_from_d():
    q, k = _randn(5, (1, 64, 4 * 32)), _randn(6, (1, 64, 4 * 32))
    v = _randn(7, (1, 64, 4 * 48))
    want = jax_blf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=4, interpret=True)
    got = k1.encoder_attention_blf(*(torch.from_numpy(x) for x in (q, k, v)), heads=4)
    assert got.shape == (1, 64, 4 * 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_bf16_matches_pallas_bf16():
    """The working dtype: bf16 in, bf16 out, e rounded to bf16 before PV on
    both sides. Tolerance one bf16 ulp at |o| < 1 (2^-8): the f32 sums
    differ in order and the final rounding may land on either side."""
    q, k, v = (_randn(s, (2, 64, 768)) for s in (8, 9, 10))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_blf(jq, jk, jv, heads=12, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = k1.encoder_attention_blf(tq, tk, tv, heads=12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=2**-8
    )


@pytest.mark.parametrize("l,valid_len,dv", [(21, 17, 16), (40, 33, 24), (40, 1, 16)])
def test_masked_plain_matches_pallas_padded(l, valid_len, dv):
    """The Mllama key prefix: JAX pads L to 16 and masks keys past
    valid_len with −1e30; the port leaves them out. Every row, padded or
    not, is a query on both sides."""
    q, k = _randn(11, (2, l, 3, 16)), _randn(12, (2, l, 3, 16))
    v = _randn(13, (2, l, 3, dv))
    want = jax_padded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      valid_len=valid_len, interpret=True)
    got = k1.encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               valid_len=valid_len)
    assert got.shape == (2, l, 3, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_masked_wrapper_checks():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError):
        k1.encoder_attention(q, q, q, valid_len=0)
    with pytest.raises(ValueError):
        k1.encoder_attention(q, q, q, valid_len=9)
    with pytest.raises(ValueError):
        k1.encoder_attention(q, q[:, :7], q, valid_len=4)
    before = k1.encoder_attention.launches
    full = k1.encoder_attention(q + 1, q, q + 2)
    assert k1.encoder_attention.launches == before  # CPU: plain version
    torch.testing.assert_close(full, torch.full_like(q, 2.0))
    with pytest.raises(ValueError):
        m = q.to("meta")
        k1.encoder_attention(m, m, m, valid_len=4)


def test_launch_counter_counts_only_kernel_launches():
    q = torch.zeros(1, 16, 64)
    before = k1.encoder_attention_blf.launches
    k1.encoder_attention_blf(q, q, q, heads=1)  # CPU: plain version
    assert k1.encoder_attention_blf.launches == before


@pytest.mark.parametrize("packed", [False, True])
def test_non_cpu_tensor_never_takes_plain_path(packed):
    """Only a CPU tensor reaches the plain version; any other device must
    launch the kernel or raise."""
    if packed:
        with pytest.raises(ValueError):
            k1.encoder_attention_blf_packed(torch.zeros(1, 16, 144, device="meta"), 1, 36, 72)
    else:
        q = torch.zeros(1, 16, 64, device="meta")
        with pytest.raises(ValueError):
            k1.encoder_attention_blf(q, q, q, heads=1)


def test_shape_errors():
    with pytest.raises(ValueError):
        k1.encoder_attention_blf_packed(torch.zeros(1, 16, 100), 1, 36, 72)
    with pytest.raises(ValueError):
        q = torch.zeros(1, 16, 64)
        k1.encoder_attention_blf(q, q, q, heads=3)


@pytest.mark.parametrize("shape,dv,scale", [((2, 64, 4, 16), 16, None),
                                            ((1, 48, 3, 24), 40, 0.3)])
def test_blhd_plain_matches_pallas(shape, dv, scale):
    """(B, L, H, D) operands; q/k/v are strided column slices of one wider
    slab, as the fused LayerNorm→qkv product hands them to ``sdpa``."""
    b, l, h, d = shape
    slab = _randn(14, (b, l, h * (2 * d + dv)))
    q = slab[..., : h * d].reshape(b, l, h, d)
    k = slab[..., h * d : 2 * h * d].reshape(b, l, h, d)
    v = slab[..., 2 * h * d :].reshape(b, l, h, dv)
    want = jax_blhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale,
                    interpret=True)
    t = torch.from_numpy(slab)
    got = k1.encoder_attention_blhd(
        t[..., : h * d].view(b, l, h, d), t[..., h * d : 2 * h * d].view(b, l, h, d),
        t[..., 2 * h * d :].view(b, l, h, dv), sm_scale=scale,
    )
    assert got.shape == (b, l, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_blhd_supported_is_the_jax_rule():
    for l in (256, 784, 1024, 1608):
        for h, d in ((12, 64), (16, 80), (4, 36), (8, 128)):
            for tdt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
                tq = torch.empty((1, l, h, d), dtype=tdt, device="meta")
                jq = jnp.zeros((1, l, h, d), jdt)
                assert k1.blhd_supported(tq, tq) == jk1.blhd_supported(jq, jq), (l, h, d, tdt)


def test_blhd_wrapper_checks_and_launch_count():
    q = torch.zeros(1, 8, 2, 4)
    before = k1.encoder_attention_blhd.launches
    k1.encoder_attention_blhd(q, q, q)  # CPU: plain version
    assert k1.encoder_attention_blhd.launches == before
    with pytest.raises(ValueError):
        k1.encoder_attention_blhd(q, q[:, :7], q)
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        m = q.to("meta")
        k1.encoder_attention_blhd(m, m, m)


@pytest.mark.parametrize("blhd_env", ["1", None])
@pytest.mark.parametrize("shape,dtype", [
    ((1, 784, 12, 64), "bfloat16"),  # the ViT page: BLHD fits (all 12 heads)
    ((1, 784, 12, 64), "float32"),   # no legal head block fits
    ((1, 1024, 16, 80), "bfloat16"),
    ((1, 256, 4, 36), "bfloat16"),
    ((1, 100, 2, 16), "bfloat16"),   # below the whole-row window: XLA path
])
def test_sdpa_takes_the_blhd_route_where_jax_does(shape, dtype, blhd_env, monkeypatch):
    """Both ``sdpa``s with their kernels replaced by recorders; JAX as it
    dispatches on a TPU."""
    if blhd_env:
        monkeypatch.setenv("MMTPU_ENC_ATTN_BLHD", blhd_env)
    routes = {"jax": [], "port": []}

    def recorder(side, name):
        def call(q, k, v, *args, **kwargs):
            routes[side].append(name)
            return q
        return call

    monkeypatch.setattr(jtr, "_on_tpu_backend", lambda: True)
    monkeypatch.setattr(jk1, "encoder_attention", recorder("jax", "bhld"))
    monkeypatch.setattr(jk1, "encoder_attention_blhd", recorder("jax", "blhd"))
    monkeypatch.setattr(ttr, "encoder_attention", recorder("port", "bhld"))
    monkeypatch.setattr(ttr, "encoder_attention_blhd", recorder("port", "blhd"))
    jq = jnp.zeros(shape, getattr(jnp, dtype))
    jtr.sdpa(jq, jq, jq)
    tq = torch.zeros(shape, dtype=getattr(torch, dtype))
    ttr.sdpa(tq, tq, tq)
    assert routes["port"] == routes["jax"]
    if shape[1] == 784 and dtype == "bfloat16":
        assert routes["jax"] == (["blhd"] if blhd_env else ["bhld"])


@pytest.mark.parametrize("shape,dv,valid_len", [((2, 3, 64, 16), 16, None),
                                                ((1, 4, 48, 24), 40, None),
                                                ((2, 2, 48, 16), 24, 33)])
def test_bhld_plain_matches_pallas(shape, dv, valid_len):
    """``bhld_inputs=True``: (B, H, L, D) operands and output, against JAX
    ``encoder_attention(bhld_inputs=True)``; the port reads permuted views
    of (B, L, H·D) projections, as the proj-BHLD route hands them."""
    b, h, l, d = shape
    q, k = _randn(15, shape), _randn(16, shape)
    v = _randn(17, (b, h, l, dv))
    want = jax_k1(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), valid_len=valid_len,
                  bhld_inputs=True, interpret=True)

    def as_view(x):  # the same values as a (B, H, L, ·) view of a (B, L, H·D) slab
        slab = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))
        return slab.reshape(b, l, -1).view(b, l, h, x.shape[3]).permute(0, 2, 1, 3)

    got = k1.encoder_attention(as_view(q), as_view(k), as_view(v), valid_len=valid_len,
                               bhld_inputs=True)
    assert got.shape == (b, h, l, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bhld_wrapper_checks_and_launch_counts():
    q = torch.zeros(1, 2, 8, 4)
    before = (k1.encoder_attention.launches, k1.encoder_attention.bhld.launches)
    out = k1.encoder_attention(q + 1, q, q + 2, bhld_inputs=True)  # CPU: plain version
    assert (k1.encoder_attention.launches, k1.encoder_attention.bhld.launches) == before
    torch.testing.assert_close(out, torch.full_like(q, 2.0))
    with pytest.raises(ValueError):
        k1.encoder_attention(q, q[:, :, :7], q, bhld_inputs=True)
    with pytest.raises(ValueError):
        k1.encoder_attention(q, q, q, valid_len=9, bhld_inputs=True)
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        m = q.to("meta")
        k1.encoder_attention(m, m, m, bhld_inputs=True)


def test_blhd_probe_script_variants_agree_on_the_cpu():
    """``scripts/torch_enc_attn_blhd_probe.py`` at one crop of the ViT
    shape: every variant's mini block computes the same function (K1's
    plain version in six layouts, the XLA-numerics ``sdpa`` in one), bf16,
    cosine per token ≥ 0.999 against ``blf``, once the packed variant's
    weight is wq|wk|wv packed per head (the script draws its own, as the
    JAX probe does); ``run`` prints its JSON line."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "torch_enc_attn_blhd_probe",
        pathlib.Path(__file__).parent.parent / "scripts" / "torch_enc_attn_blhd_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    x, wq, wk, wv, wo, _ = probe.inputs("vit", "cpu", batch=1)
    args = (x, wq, wk, wv, wo, torch.cat([wq, wk, wv], dim=2).reshape(768, -1))
    want = probe.block("blf", "vit")(*args).float()
    for variant in probe.VARIANTS:
        got = probe.block(variant, "vit")(*args).float()
        assert got.shape == (1, 784, 768), variant
        cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
        assert float(cos.min()) >= 0.999, (variant, float(cos.min()))
    line = probe.run("proj_bhld", "vit", iters=1, device="cpu", batch=1)
    assert line["dims"] == [1, 784, 12, 64, 64] and line["ms"] > 0
    assert line["launches"] == {}  # the CPU takes the plain versions


# --- the launch plan of the bf16 tensor-core kernel ---------------------------


def _operands(*tensors_and_head_strides):
    """(base address, (batch, row, head) strides) of each (tensor, head
    stride) pair of a (B, L, ·) operand, as ``_launch_blf`` hands them."""
    return [(t.data_ptr(), (t.stride(0), t.stride(1), hs)) for t, hs in tensors_and_head_strides]


@pytest.mark.parametrize("d,padded", [(36, 48), (72, 80), (80, 80), (64, 64), (20, 32),
                                      (24, 32), (40, 48), (56, 64), (128, 128), (1, 16)])
def test_plan_pads_head_dims_to_16(d, padded):
    """bf16 holds D and DV in 16-column chunks, zero past the real ones."""
    x = torch.empty(1, 8, 4 * d, dtype=torch.bfloat16)
    plan = k1._plan(torch.bfloat16, 8, d, d, _operands((x, d), (x, d), (x, d)))
    assert (plan.dp, plan.dvp) == (padded, padded)
    f32 = k1._plan(torch.float32, 8, d, d, _operands(*[(x.float(), d)] * 3))
    assert (f32.dp, f32.dvp) == (d, d)  # the CUDA-core form takes D as it is


def test_plan_copy_widths_at_the_page_shapes():
    """16-byte copies for the ViT's slabs, the Mllama (B, L, H, D) views and
    the BHLD views; the PSA slab's k starts 72 bytes into each head (288 B),
    so 8-byte copies for it and 16 for its q and v; the ragged packed
    [q(20)|k(20)|v(24)] has k at 40 bytes, v at 80."""
    bf16 = torch.bfloat16
    vit = torch.empty(2, 784, 768, dtype=bf16)
    assert k1._plan(bf16, 784, 64, 64, _operands(*[(vit, 64)] * 3)).widths == (16, 16, 16)
    mllama = torch.empty(2, 1608, 16, 80, dtype=bf16)
    ops = [(mllama.data_ptr(), (mllama.stride(0), mllama.stride(1), mllama.stride(2)))] * 3
    assert k1._plan(bf16, 1608, 80, 80, ops).widths == (16, 16, 16)
    bhld = vit.view(2, 784, 12, 64).permute(0, 2, 1, 3)
    ops = [(bhld.data_ptr(), (bhld.stride(0), bhld.stride(2), bhld.stride(1)))] * 3
    assert k1._plan(bf16, 784, 64, 64, ops).widths == (16, 16, 16)
    for (heads, kd, hd), widths in (((4, 36, 72), (16, 8, 16)), ((2, 20, 24), (16, 8, 16))):
        per_head = 2 * kd + hd
        qkv = torch.empty(30, 1024, heads * per_head, dtype=bf16)
        q, k, v = qkv[..., :kd], qkv[..., kd : 2 * kd], qkv[..., 2 * kd :]
        assert k.data_ptr() - qkv.data_ptr() == 2 * kd
        plan = k1._plan(bf16, 1024, kd, hd, _operands((q, per_head), (k, per_head),
                                                      (v, per_head)))
        assert plan.widths == widths, (kd, plan)
    odd = torch.empty(1, 8, 3 * 37, dtype=bf16)[..., 1:]  # 2-byte aligned only
    assert k1._plan(bf16, 8, 36, 36, _operands(*[(odd, 37)] * 3)).widths == (2, 2, 2)


def test_plan_shared_memory_and_lengths():
    """bf16 needs no score row: its bytes do not depend on L and fit the
    card's 232,448 per block at D = DV = 128. f32 keeps 16 whole f32 score
    rows, so past L ≈ 3300 it no longer fits and the wrapper refuses."""
    x = torch.empty(1, 8, 128, dtype=torch.bfloat16)
    ops = _operands(*[(x, 128)] * 3)
    plans = [k1._plan(torch.bfloat16, l, 128, 128, ops) for l in (1, 1608, 100_000)]
    assert len({p.smem for p in plans}) == 1 and plans[0].smem <= k1._MAX_SMEM
    assert k1._plan(torch.bfloat16, 784, 64, 64, ops).smem < plans[0].smem
    xf = x.float()
    ops = _operands(*[(xf, 128)] * 3)
    assert k1._plan(torch.float32, 1608, 128, 128, ops).smem <= k1._MAX_SMEM
    assert k1._plan(torch.float32, 4096, 128, 128, ops).smem > k1._MAX_SMEM
    assert k1._plan(torch.float32, 1608, 64, 64, ops).smem < k1._plan(
        torch.float32, 4096, 64, 64, ops).smem


# ---------------------------------------------------------------------------
# K1's gradient (KernelAttention) and the guard of the kernels without one
# ---------------------------------------------------------------------------

# f32 gradients of the same function by two orders of summation (L <= 64
# keys of O(1) terms): 2e-5 absolute
GRAD_ATOL = 2e-5


def _jax_attention_grads(q, k, v, do, heads=None):
    """``jax.grad`` of JAX's XLA attention path (``transformer.sdpa`` off
    the TPU) on (B, L, H, D) operands, or (B, L, H·D) slabs with ``heads``."""
    import jax

    def f(q, k, v):
        if heads is None:
            return jnp.sum(jtr.sdpa(q, k, v) * do)
        b, l, _ = q.shape
        split = [x.reshape(b, l, heads, -1) for x in (q, k, v)]
        return jnp.sum(jtr.sdpa(*split).reshape(b, l, -1) * do)

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("b,l,heads,d,dv", [(2, 16, 2, 32, 32), (1, 40, 3, 16, 24)])
def test_kernel_attention_blf_gradient_equals_jax(b, l, heads, d, dv):
    """``KernelAttention`` in its BLF form (the forward the plain version on
    the CPU) against ``jax.grad`` of JAX's XLA path and against autograd of
    the port's plain version; dv != d covered."""
    rng = np.random.default_rng(l)
    q, k = (rng.normal(size=(b, l, heads * d)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, l, heads * dv)).astype(np.float32)
    do = rng.normal(size=(b, l, heads * dv)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = k1.KernelAttention.apply(tq, tk, tv, "blf", heads)
    out.backward(torch.from_numpy(do))
    want = _jax_attention_grads(q, k, v, do, heads)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL)
    pq, pk, pv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    k1.encoder_attention_blf(pq, pk, pv, heads).backward(torch.from_numpy(do))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), (pq.grad, pk.grad, pv.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=GRAD_ATOL)


def test_kernel_attention_bhld_gradient_equals_jax():
    """The BHLD form on permuted (B, H, L, D) views (the proj-BHLD route)
    against ``jax.grad`` of JAX's XLA path; the gradients come back in the
    views' shapes."""
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 24, 2, 16
    q, k, v, do = (rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(4))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = k1.KernelAttention.apply(*(t.permute(0, 2, 1, 3) for t in (tq, tk, tv)), "bhld", h)
    out.permute(0, 2, 1, 3).backward(torch.from_numpy(do))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), _jax_attention_grads(q, k, v, do)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_ATOL)


def test_attention_backward_takes_the_forward_contract():
    """``attention_backward`` is the derivative of K1's plain version (the
    denominator of the unrounded e): equal to autograd of
    ``_attend_plain`` in f32."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(2, 3, 20, 8)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k1._attend_plain(*leaves, 0.25)
    out.backward(do)
    got = k1.attention_backward(q, k, v, out.detach(), do, 0.25)
    for g, ref in zip(got, (t.grad for t in leaves)):
        torch.testing.assert_close(g, ref, atol=GRAD_ATOL, rtol=0)


def test_jax_cannot_differentiate_its_pallas_k1():
    """Why the port's gradient through K1 is its own tensor code: ``jax.grad``
    of JAX's Pallas K1 (interpret mode) fails to linearize."""
    import jax

    x = jnp.ones((1, 16, 64), jnp.float32)
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda q: jnp.sum(jax_blf(q, x, x, heads=2, interpret=True)))(x)


def test_refuse_grad_guard():
    """The guard every kernel wrapper without a backward calls on its CUDA
    branch: it raises, naming the wrapper, for an input that requires a
    gradient while grad mode is on, and passes under ``no_grad`` and
    ``inference_mode``, for inputs without one and for None."""
    from multimodal_embeddings_tpu_torch.kernels import _build

    w = torch.ones(3, requires_grad=True)
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="int8_matmul"):
        _build.refuse_grad("int8_matmul", x, w)
    _build.refuse_grad("int8_matmul", x, None)
    with torch.no_grad():
        _build.refuse_grad("int8_matmul", x, w)
    with torch.inference_mode():
        _build.refuse_grad("int8_matmul", x, w)
    with pytest.raises(RuntimeError, match="ln_matmul"):
        _build.refuse_grad("ln_matmul", x * w)  # an activation that carries a gradient


@pytest.mark.parametrize("module,wrappers", [
    ("encoder_attention", ["encoder_attention_blf_packed", "encoder_attention",
                           "encoder_attention_blhd"]),
    ("quantization", ["int8_matmul", "stochastic_round_quantize"]),
    ("quantization_int4", ["int4_matmul"]),
    ("flash_attention", ["flash_attention_v2", "flash_attention"]),
    ("conv", ["conv3x3_nchw", "conv3x3_s2_nchw"]),
    ("ln_matmul", ["ln_matmul"]),
    ("ln_stats", ["ln_stats"]),
])
def test_every_wrapper_without_a_backward_is_guarded(module, wrappers):
    """Each kernel wrapper's CUDA branch either carries a gradient (K1's BLF
    and BHLD forms, through ``KernelAttention``) or calls the guard under
    its own name, after its CPU branch returned."""
    import importlib
    import inspect

    mod = importlib.import_module(f"multimodal_embeddings_tpu_torch.kernels.{module}")
    src = inspect.getsource(mod)
    for name in wrappers:
        assert f'refuse_grad("{name}"' in src or f'else "{name}"' in src, name
    if module == "encoder_attention":
        for name in ("encoder_attention_blf", "encoder_attention"):
            assert "KernelAttention.apply" in inspect.getsource(getattr(mod, name))
