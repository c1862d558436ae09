"""K5, the 3×3 conv: its plain PyTorch versions (stride 1 and the stride-2
form) against the JAX Pallas kernels (interpret mode), the GL-CRM kernel
route of the port's detector against the JAX modules'
``pallas_max_channels`` route, same weights, f32, and the bf16 kernel's
launch plan and weight layout, which the CPU computes for the card.

Tolerances: f32 2e-5 absolute on outputs of magnitude up to ~10 (the two
sides sum 9·C products in different orders); bf16 at most 2 bf16 steps at
the output's magnitude (both accumulate in f32 and round once, so only an
output near a rounding boundary may land on the neighbouring value). The
detector's raw head maps: 1e-4, as ``test_torch_detect.py``."""

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels.conv import conv3x3_nchw as jax_conv
from multimodal_embeddings_tpu.kernels.conv import conv3x3_s2_nchw as jax_conv_s2
from multimodal_embeddings_tpu.models import layers as jl
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.kernels import conv as k5
from multimodal_embeddings_tpu_torch.models import layers as tl
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.weights import export_jax_params, load_jax_params

torch.set_num_threads(2)
ATOL = 2e-5


def _operands(seed, n, c, co, h, w):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c, h, w)).astype(np.float32)
    k = (rng.normal(size=(co, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)
    b = rng.normal(scale=0.5, size=(co,)).astype(np.float32)
    return x, k, b


def _bf16_steps(got, want):
    want = want.astype(np.float32)
    _, exp = np.frexp(np.maximum(np.abs(want), 2.0**-126))
    return np.max(np.abs(got.astype(np.float32) - want) / np.ldexp(1.0, exp - 8))


@pytest.mark.parametrize("dilation", [1, 2, 4])
@pytest.mark.parametrize("epilogue", [False, True])
def test_plain_matches_pallas_f32(dilation, epilogue):
    """H = 13 and W = 20: neither a multiple of the TPU's 8-row groups."""
    x, k, b = _operands(dilation, 2, 12, 16, 13, 20)
    bias, act = (b, "silu") if epilogue else (None, "none")
    want = jax_conv(jnp.asarray(x), jnp.asarray(k), None if bias is None else jnp.asarray(bias),
                    act=act, dilation=dilation, interpret=True)
    got = k5.conv3x3_nchw(torch.from_numpy(x), torch.from_numpy(k),
                          None if bias is None else torch.from_numpy(bias),
                          act=act, dilation=dilation)
    assert got.shape == (2, 16, 13, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dilation", [1, 2])
def test_plain_matches_pallas_bf16(dilation):
    """The working dtype: bf16 x and folded weights, f32 bias, bf16 out."""
    x, k, b = _operands(10 + dilation, 2, 16, 8, 9, 16)
    jx, jk = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    want = jax_conv(jx, jk, jnp.asarray(b), act="silu", dilation=dilation, interpret=True)
    tx = torch.from_numpy(x).bfloat16()
    got = k5.conv3x3_nchw(tx, torch.from_numpy(k).bfloat16(), torch.from_numpy(b),
                          act="silu", dilation=dilation)
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 2


def test_edges_zero_padding():
    """Mass only on the borders: every tap that leaves the image reads 0."""
    x = np.zeros((1, 4, 10, 12), np.float32)
    x[:, :, 0, :], x[:, :, -1, :], x[:, :, :, 0], x[:, :, :, -1] = 1.0, 2.0, 3.0, 4.0
    k = np.full((4, 4, 3, 3), 0.5, np.float32)
    for d in (1, 2, 4):
        want = jax_conv(jnp.asarray(x), jnp.asarray(k), dilation=d, interpret=True)
        got = k5.conv3x3_nchw(torch.from_numpy(x), torch.from_numpy(k), dilation=d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrapper_checks_and_launch_count():
    x = torch.zeros(1, 4, 6, 6)
    w = torch.zeros(8, 4, 3, 3)
    before = k5.conv3x3_nchw.launches
    k5.conv3x3_nchw(x, w, torch.zeros(8), act="silu")  # CPU: plain version
    assert k5.conv3x3_nchw.launches == before
    with pytest.raises(ValueError):
        k5.conv3x3_nchw(x, torch.zeros(8, 5, 3, 3))
    with pytest.raises(ValueError):
        k5.conv3x3_nchw(x, w, act="relu")
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        k5.conv3x3_nchw(x.to("meta"), w.to("meta"))


# --- the stride-2 form (conv3x3_s2_nchw) ------------------------------------


@pytest.mark.parametrize("n,c,co,h,w", [(2, 8, 16, 32, 256), (1, 16, 8, 48, 128)])
def test_s2_plain_matches_pallas(n, c, co, h, w):
    """The JAX tests' shapes and epilogue (tests/test_conv_kernel.py::
    TestStride2), and their tolerance, 1e-4."""
    x, k, b = _operands(40 + c, n, c, co, h, w)
    want = jax_conv_s2(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), act="silu",
                       interpret=True)
    got = k5.conv3x3_s2_nchw(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                             act="silu")
    assert got.shape == (n, co, h // 2, w // 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_s2_edges_border_mass():
    """Mass only on the borders: the bottom/right SAME padding (row and
    column H, W read 0) and the top/left rows and columns read once."""
    x = np.zeros((1, 4, 16, 128), np.float32)
    x[:, :, 0, :], x[:, :, -1, :], x[:, :, :, 0], x[:, :, :, -1] = 1.0, 2.0, 3.0, 4.0
    k = np.full((4, 4, 3, 3), 0.5, np.float32)
    want = jax_conv_s2(jnp.asarray(x), jnp.asarray(k), interpret=True)
    got = k5.conv3x3_s2_nchw(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_s2_bf16_casts_the_weight_to_x():
    """bf16 x with f32 weights and bias: both sides cast the weight to bf16
    and keep the bias f32; at most 2 bf16 steps apart."""
    x, k, b = _operands(50, 2, 8, 12, 16, 32)
    want = jax_conv_s2(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
                       act="silu", interpret=True)
    got = k5.conv3x3_s2_nchw(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                             torch.from_numpy(b), act="silu")
    assert got.dtype == torch.bfloat16
    assert _bf16_steps(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 2


def test_s2_is_not_the_detectors_symmetric_padding():
    """Lax SAME pads 0 on top/left and 1 on bottom/right at even H and W;
    the detector's stride-2 ConvBnAct pads 1 on every side, which moves
    every tap by one pixel."""
    x, k, _ = _operands(51, 1, 4, 4, 8, 8)
    got = k5.conv3x3_s2_nchw(torch.from_numpy(x), torch.from_numpy(k))
    symmetric = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(k),
                                           stride=2, padding=1)
    assert got.shape == symmetric.shape
    assert (got - symmetric).abs().max() > 0.1


def test_s2_wrapper_checks_and_launch_count():
    x = torch.zeros(1, 4, 6, 8)
    w = torch.zeros(8, 4, 3, 3)
    before = (k5.conv3x3_nchw.launches, k5.conv3x3_s2_nchw.launches)
    k5.conv3x3_s2_nchw(x, w, torch.zeros(8), act="silu")  # CPU: plain version
    assert (k5.conv3x3_nchw.launches, k5.conv3x3_s2_nchw.launches) == before
    for odd in (torch.zeros(1, 4, 7, 8), torch.zeros(1, 4, 6, 9)):
        with pytest.raises(ValueError):
            k5.conv3x3_s2_nchw(odd, w)
    with pytest.raises(ValueError):
        k5.conv3x3_s2_nchw(x, torch.zeros(8, 5, 3, 3))
    with pytest.raises(ValueError):  # a non-CPU tensor never takes the plain path
        k5.conv3x3_s2_nchw(x.to("meta"), w.to("meta"))


# --- the GL-CRM kernel route against the JAX modules ------------------------


def _randomize_norms(flat, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        if key.endswith(("/var", "/scale")):
            val = rng.uniform(0.5, 1.5, val.shape)
        elif key.endswith(("/mean", "/bias")):
            val = rng.normal(scale=0.2, size=val.shape)
        out[key] = np.asarray(val, np.float32)
    return out


def _compare(jax_module, port_module, shape, seed=0):
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    variables = unbox(jax_module.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    flat = _randomize_norms(flatten_params(variables), seed)
    want = np.asarray(jax_module.apply(unflatten_params(flat), jnp.asarray(x)))
    load_jax_params(port_module, flat)
    launches = k5.conv3x3_nchw.launches
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert k5.conv3x3_nchw.launches == launches  # CPU: the plain version
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL)


@pytest.mark.parametrize("mode", ["stage", "block"])
@pytest.mark.parametrize("dilation", [2, 4])
def test_g2l_crm_kernel_route(mode, dilation):
    compare_args = dict(n=2, dilation=dilation, pallas_max_channels=16, pallas_mode=mode)
    port = tl.G2L_CRM(24, 32, **compare_args)
    assert all(getattr(port, f"m{i}").kernel for i in range(2))
    assert port.stage == (mode == "stage")
    _compare(jl.G2L_CRM(32, **compare_args), port, (2, 12, 12, 24))


def test_crm_bottleneck_kernel_route():
    _compare(jl.CRMBottleneck(16, dilation=2, pallas=True),
             tl.CRMBottleneck(16, 16, dilation=2, kernel=True), (2, 11, 9, 16))


def test_route_threshold_and_mode():
    assert not tl.G2L_CRM(24, 32, pallas_max_channels=15).m0.kernel
    assert tl.G2L_CRM(24, 32, pallas_max_channels=16).m0.kernel
    with pytest.raises(ValueError):
        tl.G2L_CRM(24, 32, pallas_max_channels=16, pallas_mode="nchw")


@pytest.mark.parametrize("mode", ["stage", "block"])
def test_doclayout_yolo_kernel_route_head_maps(mode, monkeypatch):
    """Variant n with ``pallas_convs=64`` routes all three GL-CRM stages
    (inner widths 16, 32, 64; dilations 2, 2, 4) through K5; 96 px."""
    monkeypatch.setenv("MMTPU_PSA_BLF_INTERPRET", "1")
    images = np.random.default_rng(0).uniform(size=(2, 96, 96, 3)).astype(np.float32)
    cfg = DetectorConfig(image_size=96, variant="n", pallas_convs=64, pallas_mode=mode)
    det = LayoutDetector(cfg, dtype=torch.float32, device="cpu")
    assert len(det.model.kernel_bias_names()) == 2 * (1 + 2 + 2)
    flat = _randomize_norms(export_jax_params(det.model))
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True, pallas_convs=64,
                                 pallas_mode=mode)
    want = jax.jit(jmodel.apply)(unflatten_params(flat), jnp.asarray(images))
    det = LayoutDetector(cfg, dtype=torch.float32, device="cpu", params=flat)
    with torch.no_grad():
        got = det.model(torch.from_numpy(images))
    for (greg, gcls), (wreg, wcls) in zip(got, want):
        np.testing.assert_allclose(greg.numpy(), np.asarray(wreg), atol=1e-4)
        np.testing.assert_allclose(gcls.numpy(), np.asarray(wcls), atol=1e-4)


def test_kernel_biases_stay_f32_in_a_bf16_detector():
    """The JAX ``_FoldedConvBn`` returns an f32 bias for K5; every other
    parameter takes the compute dtype."""
    cfg = DetectorConfig(image_size=64, variant="n", pallas_convs=32)
    flat = _randomize_norms(export_jax_params(
        LayoutDetector(cfg, dtype=torch.float32, device="cpu").model))
    f32 = LayoutDetector(cfg, dtype=torch.float32, device="cpu", params=flat).model
    det = LayoutDetector(cfg, dtype=torch.bfloat16, device="cpu", params=flat)
    names = set(det.model.kernel_bias_names())
    assert len(names) == 2 * (1 + 2)  # c2f_2 and c2f_3; c2f_4's 64 > 32
    ref = dict(f32.named_parameters())
    for name, p in det.model.named_parameters():
        if name in names:
            assert p.dtype == torch.float32 and torch.equal(p, ref[name])
        else:
            assert p.dtype == torch.bfloat16


# --- the bf16 kernel's launch plan (K5 on the card) --------------------------

_MAX_SMEM = 232448


def _plan_of(n, c, h, w, cout, stride=1, dilation=1, ptr=0, pixel=None):
    """The plan of a channels-last x whose pixels are ``pixel`` elements
    apart (C, or 2C for the channel half of a wider tensor)."""
    pixel = pixel or c
    oh, ow = (h, w) if stride == 1 else (h // 2, w // 2)
    return k5._plan(n, c, h, w, cout, oh, ow, stride, dilation, ptr % 16,
                    (h * w * pixel, w * pixel, pixel))


# (N, C, H, W, Cout, stride, dilation, pixel stride, base) -> path, tile
# rows, cluster, groups, chunks, stages
PLAN_CASES = {
    "c2f_2 cv1 slice": ((30, 48, 256, 256, 48, 1, 2, 96, 96), ("tma", 16, 1, 1, 1, 4)),
    "c2f_2 cv2": ((30, 48, 256, 256, 48, 1, 1, 48, 0), ("tma", 16, 1, 1, 1, 4)),
    "c2f_3 cv1 slice": ((30, 96, 128, 128, 96, 1, 2, 192, 192), ("tma", 8, 2, 1, 1, 3)),
    "c2f_3 cv2": ((30, 96, 128, 128, 96, 1, 1, 96, 0), ("tma", 16, 2, 1, 1, 2)),
    "s2 stem": ((30, 3, 1024, 1024, 48, 2, 1, 3, 0), ("cp.async", 16, 1, 1, 1, 4)),
    "s2 48->96": ((30, 48, 512, 512, 96, 2, 1, 48, 0), ("tma", 8, 2, 1, 1, 3)),
    "s2 96->192": ((30, 96, 256, 256, 192, 2, 1, 96, 0), ("tma", 8, 4, 1, 2, 2)),
    "ragged H, W": ((2, 48, 37, 21, 48, 1, 2, 96, 96), ("tma", 16, 1, 1, 1, 4)),
    "H = W = 1": ((1, 48, 1, 1, 48, 1, 2, 96, 96), ("tma", 16, 1, 1, 1, 4)),
    "cout 100": ((2, 48, 19, 23, 100, 1, 1, 96, 96), ("tma", 16, 3, 1, 1, 4)),
    "cout 440": ((1, 48, 18, 20, 440, 1, 2, 96, 96), ("tma", 16, 5, 2, 1, 4)),
    "C 192": ((2, 192, 20, 36, 48, 1, 2, 192, 0), ("tma", 16, 1, 1, 3, 2)),
    "d 24": ((1, 48, 60, 52, 48, 1, 24, 96, 96), ("cp.async", 16, 1, 1, 1, 4)),
    "C 20": ((2, 20, 13, 17, 20, 1, 1, 20, 0), ("cp.async", 16, 1, 1, 1, 4)),
    "base 2 B off": ((2, 48, 21, 19, 96, 1, 2, 48, 2), ("cp.async", 16, 2, 1, 1, 4)),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_forms(name):
    """The form `_plan` chooses at the page shapes, the stride-2 shapes and
    the chip check's edge cases; every plan fits the card's 227 KB."""
    (n, c, h, w, cout, stride, d, pixel, base), want = PLAN_CASES[name]
    plan = _plan_of(n, c, h, w, cout, stride, d, base, pixel)
    got = (plan.path, plan.tile[0], plan.cluster, plan.groups, plan.nchunks, plan.stages)
    assert got == want, plan
    assert plan.tile[1] == 16 and plan.smem <= _MAX_SMEM
    assert plan.groups * plan.cluster * 48 >= cout and plan.cluster <= 8
    assert plan.nchunks * plan.pc >= c and plan.pc % 16 == 0
    assert plan.grid[0] % plan.cluster == 0 and plan.grid[1] == plan.groups
    assert plan.grid[0] // plan.cluster <= 132 // plan.cluster
    assert (plan.width == 0) == (plan.path == "tma")
    assert plan.phase == (d if name == "d 24" else 1)


@pytest.mark.parametrize("c,pixel,base,width", [
    (48, 96, 96, 0),    # the CSP's channel half: 96-byte base, 192-byte pixels
    (96, 192, 192, 0),
    (3, 3, 0, 2),       # the stem: 6-byte pixels
    (20, 20, 0, 8),     # 40-byte pixels
    (20, 40, 0, 16),    # 2C not a multiple of 16, the strides are
    (48, 48, 2, 2),     # a base 2 bytes off alignment
    (48, 48, 8, 8),
])
def test_plan_halo_path(c, pixel, base, width):
    """TMA exactly where the base, 2C and the strides are multiples of 16
    bytes; else cp.async with the widest copy the base and strides allow."""
    plan = _plan_of(2, c, 20, 24, 48, ptr=base, pixel=pixel)
    assert plan.path == ("tma" if width == 0 else "cp.async") and plan.width == width


def test_plan_ints_and_shared_bytes():
    """The ints the C entry point takes, and the shared bytes the source's
    layout computes: resident weights, 4 stages of the halo's 32- and
    16-channel boxes (64 and 32 bytes a pixel, each box 1024-aligned; a
    warpgroup's epilogue rows reuse its stage), the barriers and biases."""
    plan = _plan_of(30, 48, 256, 256, 48, dilation=2, ptr=96, pixel=96)
    assert plan.ints() == [0, 4, 1, 1, 1, 1, 48, 4, plan.smem, 132]
    halo = 20 * 20  # (16 - 1) + 2·2 + 1 pixels square
    weights = 48 * 448 * 2  # 9·48 = 432 deep, padded to 448
    boxes = halo * 64 + 13 * 1024  # 400 · 32 = 12,800 bytes rounded up to 13 KB
    assert plan.smem == 1024 + weights + 4 * boxes + 8 * 13 + 4 * 48
    assert k5._atoms(48) == [32, 16] and k5._atoms(96) == [64, 32] and k5._atoms(112) == [64, 32, 16]


def test_plan_reads_the_card_residency():
    """The persistent grid is as many clusters as the card holds at once,
    at most one per tile; a cluster size the card cannot hold at all makes
    the plan split Cout into more groups."""
    def resident(mr, smem, q):
        return 120 if q <= 4 else 0

    plan = k5._plan(1, 48, 18, 20, 440, 18, 20, 1, 2, 0, (18 * 20 * 48, 20 * 48, 48), resident)
    assert (plan.cluster, plan.groups) == (4, 3)
    # 4 tiles (18 x 20 pixels in tiles of 16 x 16): 4 clusters of 4 per group
    assert plan.grid == (4 * 4, 3)
    small = _plan_of(1, 48, 8, 8, 48)
    assert small.grid == (1, 1)


@pytest.mark.parametrize("cout,c,nchunks", [(48, 48, 1), (100, 20, 1), (48, 192, 3)])
def test_weight_layout(cout, c, nchunks):
    """``_weights`` puts w[o, c, ky, kx] at the wgmma-swizzled place of row
    o mod 48, column tap·pc + c of its chunk, and zeros past C and Cout;
    the packing is kept on the weight until the weight changes."""
    rng = np.random.default_rng(cout + c)
    w = torch.from_numpy(rng.normal(size=(cout, c, 3, 3)).astype(np.float32)).bfloat16()
    plan = _plan_of(2, c, 20, 36, cout, dilation=2)
    assert plan.nchunks == nchunks
    got = k5._weights(w, plan)
    nb, pc, kp = plan.groups * plan.cluster, plan.pc, k5._kp(plan.pc)
    assert got.shape == (nb, nchunks, kp // 64, 48, 64)
    flat = got.reshape(nb, nchunks, -1)
    want = torch.zeros(nb * 48, nchunks * pc, 9, dtype=torch.bfloat16)
    want[:cout, :c] = w.reshape(cout, c, 9)
    for b in range(nb):
        for j in range(nchunks):
            k = torch.arange(9 * pc)
            tap, ch = k // pc, k % pc
            for o in range(48):
                off = (k // 64) * 48 * 64 + o * 64 + (((k % 64) // 8) ^ (o % 8)) * 8 + k % 8
                assert torch.equal(flat[b, j, off], want[b * 48 + o, j * pc + ch, tap])
    assert k5._weights(w, plan) is got
    w.add_(1)
    assert k5._weights(w, plan) is not got


def test_weight_layout_of_an_inference_tensor():
    """A weight made under ``torch.inference_mode()`` has no version counter:
    ``_weights`` still lays it out as ``_pack`` does, and after an in-place
    change inside inference mode it returns the new layout, not a stale one."""
    rng = np.random.default_rng(48)
    with torch.inference_mode():
        w = torch.from_numpy(rng.normal(size=(48, 48, 3, 3)).astype(np.float32)).bfloat16()
    assert w.is_inference()
    plan = _plan_of(2, 48, 20, 36, 48, dilation=2)
    nb, kp = plan.groups * plan.cluster, k5._kp(plan.pc)

    def packed(t):
        return k5._pack(t, nb, kp, plan.nchunks, plan.pc, 48, 48)

    assert torch.equal(k5._weights(w, plan), packed(w))
    with torch.inference_mode():
        w.mul_(-2)
        got = k5._weights(w, plan)
    assert torch.equal(got, packed(w))
    assert not torch.equal(got, packed(w / -2))


@pytest.mark.parametrize("dilation", [1, 2])
def test_bf16_x_casts_an_f32_weight_as_jax_does(dilation):
    """bf16 x with an f32 weight and SiLU: the stride-1 conv computes with
    the weight cast to bf16, as JAX's ``w_flat.astype(x.dtype)`` does."""
    x, k, b = _operands(20 + dilation, 1, 16, 8, 16, 16)
    want = jax_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b),
                    act="silu", dilation=dilation, interpret=True)
    got = k5.conv3x3_nchw(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                          torch.from_numpy(b), act="silu", dilation=dilation)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_non_cuda_device_raises_without_counting():
    """A tensor on neither the CPU nor a CUDA device raises before any
    launch, in both wrappers, and neither counter moves."""
    x = torch.zeros(1, 48, 8, 8, device="meta").contiguous(memory_format=torch.channels_last)
    w = torch.zeros(48, 48, 3, 3, device="meta")
    before = (k5.conv3x3_nchw.launches, k5.conv3x3_s2_nchw.launches)
    for call in (lambda: k5.conv3x3_nchw(x, w, act="silu", dilation=2),
                 lambda: k5.conv3x3_s2_nchw(x, w, act="silu")):
        with pytest.raises(ValueError, match="cpu or cuda"):
            call()
    assert (k5.conv3x3_nchw.launches, k5.conv3x3_s2_nchw.launches) == before
