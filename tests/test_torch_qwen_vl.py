"""The Qwen2.5-VL model: the port's modules against the JAX package's, in
f32 on the CPU, the same weights through the bridge.

JAX runs these modules on the CPU as its own tests do: attention takes the
XLA path (the port takes it too at these lengths; K4 at L >= 2048 is held
against JAX ``sdpa`` in ``test_torch_flash_attention.py``), int8
projections dequantize, and int4
projections run either the JAX CPU fallback (dequantize first, x not rounded
to bf16) or the Pallas kernel in interpret mode (x rounded to bf16, as K3
and its plain version do). Tolerances are absolute, f32, and stated per
test; greedy tokens must be equal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax.linen import unbox

import jax.numpy as jnp

from multimodal_embeddings_tpu.kernels import quantization_int4 as jq4
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models.weights import flatten_params
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models.weights import build_qwen, load_jax_params

torch.set_num_threads(2)

# a 12x10-patch page: 8x8-patch windows pad it to 16x16, the merged grid is 6x5
IMG_HW = (168, 140)
N_PAD = 30
MAX_NEW = 8


def _configs(quantize=False, fullatt=(1,)):
    """The tiny config of both packages, with block 1 of the vision tower
    attending over the whole grid."""
    def cut(cfg):
        return dataclasses.replace(
            cfg, quantize=quantize,
            vision=dataclasses.replace(cfg.vision, fullatt_block_indexes=fullatt),
        )
    return cut(jq.QwenVLConfig.tiny()), cut(tq.QwenVLConfig.tiny())


def _randomize(flat, seed):
    """Random values for the leaves init leaves trivial: quantized storage
    and scales (|w| ~ 0.02), norm scales, biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        if key.endswith("kernel_q"):
            val = rng.integers(-127, 128, size=val.shape).astype(np.int8)
        elif key.endswith("kernel_q4"):
            val = rng.integers(0, 256, size=val.shape).astype(np.uint8)
        elif key.endswith("kernel_scale"):
            top = 7 if key.replace("kernel_scale", "kernel_q4") in flat else 127
            val = (rng.uniform(0.5, 1.5, size=val.shape) * 0.02 / top).astype(np.float32)
        elif key.endswith(("/scale", "/bias")):
            val = (np.asarray(val) + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
        out[key] = np.asarray(val)
    return out


def _prompt(b=2):
    ids = np.full((b, N_PAD + 5), 1, np.int32)
    rng = np.random.default_rng(4)
    ids[:, 1:3] = rng.integers(6, 500, size=(b, 2))
    ids[:, 3 : 3 + N_PAD] = 5  # image_pad_id of the tiny config
    ids[:, 3 + N_PAD :] = rng.integers(6, 500, size=(b, 2))
    imgs = rng.normal(size=(b, *IMG_HW, 3)).astype(np.float32)
    return ids, imgs


def _pair(quantize=False, seed=0):
    jcfg, tcfg = _configs(quantize)
    jmodel = jq.QwenVLModel(jcfg)
    ids, imgs = _prompt(1)
    flat = _randomize(flatten_params(unbox(
        jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(ids), jnp.asarray(imgs)))), seed)
    port = build_qwen(tcfg, torch.float32, "cpu", params=flat)
    return jmodel, {"params": _unflat(flat)}, port


def _unflat(flat):
    from multimodal_embeddings_tpu.models.weights import unflatten_params

    return unflatten_params({k[len("params/"):]: v for k, v in flat.items()})


def _interpret_int4_apply(x, qt, use_kernel=None):
    lead = x.shape[:-1]
    y = jq4.int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale, interpret=True)
    return y.reshape(*lead, qt.packed.shape[-1])


@pytest.fixture(scope="module")
def fp_pair():
    return _pair(False)


# ---------------------------------------------------------------------------
# configs and the functions of the module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "qwen25_vl_3b", "qwen25_vl_7b", "qwen25_vl_32b",
                                  "qwen25_vl_7b_int8", "qwen25_vl_3b_int8", "qwen25_vl_3b_int4",
                                  "qwen25_vl_32b_int8", "qwen25_vl_32b_int4"])
def test_configs_equal_jax(name):
    assert dataclasses.asdict(getattr(tq.QwenVLConfig, name)()) == dataclasses.asdict(
        getattr(jq.QwenVLConfig, name)())


@pytest.mark.parametrize("gh,gw,d", [(4, 4, 16), (80, 62, 80), (3, 7, 8)])
def test_vision_rope_2d_equal(gh, gw, d):
    jc, js = jq.vision_rope_2d(gh, gw, d)
    tc, ts = tq.vision_rope_2d(gh, gw, d)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_mrope_tables_and_batched_rope_equal():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 3000, size=(3, 2, 9)).astype(np.int32)
    for d, sec in ((16, (2, 3, 3)), (128, (16, 24, 24))):
        jc, js = jq.mrope_tables(jnp.asarray(pos), d, 1e6, sec)
        tc, ts = tq.mrope_tables(torch.from_numpy(pos), d, 1e6, sec)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        x = rng.normal(size=(2, 9, 3, d)).astype(np.float32)
        want = jq.apply_rope_batched(jnp.asarray(x), jc, js)
        got = tq.apply_rope_batched(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                                    torch.from_numpy(np.array(js)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tq.mrope_tables(torch.from_numpy(pos), 16, 1e6, (2, 3, 4))


@pytest.mark.parametrize("grid", [(6, 5), (1, 4), None])
def test_mrope_position_ids_equal(grid):
    ids = np.full((3, 40), 7, np.int32)
    n = grid[0] * grid[1] if grid else 0
    ids[0, 4 : 4 + n] = 5
    ids[1, :n] = 5  # image first
    # row 2 carries no image: plain positions
    jp, jd = jq.qwen_mrope_position_ids(jnp.asarray(ids), 5, grid)
    tp, td = tq.qwen_mrope_position_ids(torch.from_numpy(ids), 5, grid)
    assert tp.dtype == torch.int32 and td.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("gh,gw,win", [(12, 10, 8), (8, 8, 8), (5, 3, 2)])
def test_window_attention_equal(gh, gw, win):
    rng = np.random.default_rng(gh * gw)
    q, k, v = (rng.normal(size=(2, gh * gw, 2, 8)).astype(np.float32) for _ in range(3))
    want = jq._window_attention(*(jnp.asarray(a) for a in (q, k, v)), gh, gw, win)
    got = tq.window_attention(*(torch.from_numpy(a) for a in (q, k, v)), gh, gw, win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_vision_tower_on_a_padded_grid_equal():
    """12x10 patches: window attention with padded windows in block 0 and
    full attention in block 1. f32, 2e-5 (two blocks of f32 round-off on
    activations of magnitude ~1)."""
    jcfg, tcfg = _configs()
    jtower = jq.QwenVisionTower(jcfg.vision, 64)
    imgs = np.random.default_rng(1).normal(size=(2, *IMG_HW, 3)).astype(np.float32)
    flat = _randomize(flatten_params(unbox(jtower.init(jax.random.PRNGKey(1),
                                                       jnp.asarray(imgs)))), 1)
    want = jtower.apply({"params": _unflat(flat)}, jnp.asarray(imgs))
    port = load_jax_params(tq.QwenVisionTower(tcfg.vision, 64, torch.float32).float(), flat)
    with torch.no_grad():
        got = port(torch.from_numpy(imgs))
    assert got.shape == (2, 30, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_prefill_logits_caches_and_delta_equal(fp_pair):
    """f32 logits 1e-4 (two decoder layers over the vision tower's output),
    the bf16 caches to one bf16 step of their magnitude, delta exact."""
    jmodel, variables, port = fp_pair
    ids, imgs = _prompt()
    logits, caches, delta = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(imgs),
                                         cache_len=64)
    with torch.no_grad():
        tl, tc, td = port(torch.from_numpy(ids).long(), torch.from_numpy(imgs), cache_len=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), atol=1e-4)
    np.testing.assert_array_equal(td.numpy(), np.asarray(delta))
    assert len(tc) == len(caches)
    for (tk, tv), (jk, jv) in zip(tc, caches):
        assert tk.dtype == torch.bfloat16 and tk.shape == jk.shape == (2, 64, 2, 16)
        for a, b in ((tk, jk), (tv, jv)):
            b = np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(a.float().numpy(), b, rtol=2**-7, atol=1e-6)
    with torch.no_grad():
        last, _, _ = port(torch.from_numpy(ids).long(), torch.from_numpy(imgs), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), tl[:, -1].numpy(), atol=1e-5)


def test_decode_step_equal(fp_pair):
    """One cached step from the prefill's caches: logits 1e-4, the new cache
    slot to one bf16 step."""
    jmodel, variables, port = fp_pair
    ids, imgs = _prompt()
    _, caches, delta = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(imgs), cache_len=64)
    tok = np.asarray([[17], [230]], np.int32)
    pos = ids.shape[1]
    want, new = jmodel.apply(variables, jnp.asarray(tok), caches, pos, delta,
                             method=jmodel.decode_step)
    tcaches = [(torch.from_numpy(np.array(k.astype(jnp.float32))).bfloat16(),
                torch.from_numpy(np.array(v.astype(jnp.float32))).bfloat16()) for k, v in caches]
    with torch.no_grad():
        got, tnew = port.decode_step(torch.from_numpy(tok), tcaches, pos,
                                     torch.from_numpy(np.array(delta)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    for (tk, _), (jk, _) in zip(tnew, new):
        np.testing.assert_allclose(tk[:, pos].float().numpy(),
                                   np.asarray(jk[:, pos].astype(jnp.float32)),
                                   rtol=2**-7, atol=1e-6)


def _jax_generate(jmodel, variables, ids, imgs, early_stop, force_steps=None, prefill_chunk=0):
    prefill, decode = jq.build_generate_fns(jmodel, ids.shape[1], MAX_NEW,
                                            early_stop=early_stop, prefill_chunk=prefill_chunk)
    last, caches, delta = prefill(variables, jnp.asarray(ids), jnp.asarray(imgs))
    if force_steps is None:
        return np.asarray(decode(variables, last, caches, delta))
    return np.asarray(decode(variables, last, caches, delta, jnp.asarray(force_steps)))


def _port_generate(port, ids, imgs, early_stop, force_steps=None, prefill_chunk=0):
    prefill, decode = tq.build_generate_fns(port, ids.shape[1], MAX_NEW,
                                            early_stop=early_stop, prefill_chunk=prefill_chunk)
    last, caches, delta = prefill(torch.from_numpy(ids).long(), torch.from_numpy(imgs))
    fs = None if force_steps is None else torch.from_numpy(np.asarray(force_steps))
    return decode(last, caches, delta, fs).numpy()


@pytest.mark.parametrize("quantize", [False, True, "int4"])
def test_greedy_tokens_equal_jax(quantize, monkeypatch):
    """Greedy tokens at 8 new tokens: the fixed loop, the early-exit loop,
    the early-exit loop with EOS forced at ragged steps, and a prefill in
    chunks of one page, all equal to JAX's. int4 runs the JAX Pallas kernel
    in interpret mode (same rounding of x as K3)."""
    if quantize == "int4":
        monkeypatch.setattr(jquant, "int4_apply", _interpret_int4_apply)
    jmodel, variables, port = _pair(quantize, seed=2)
    ids, imgs = _prompt()
    want = _jax_generate(jmodel, variables, ids, imgs, early_stop=False)
    assert want.shape == (2, MAX_NEW) and len(np.unique(want)) > 4
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, False), want)
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, True), want)
    force = np.asarray([3, 6], np.int32)
    want_forced = _jax_generate(jmodel, variables, ids, imgs, True, force)
    assert (want_forced[0, 3:] == jmodel.config.eos_id).all()
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, True, force), want_forced)
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, False, force), want_forced)
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, False, prefill_chunk=1), want)
    got = tq.greedy_generate(port, ids, imgs, max_new_tokens=MAX_NEW, prefill_chunk=1)
    np.testing.assert_array_equal(got, jq.greedy_generate(jmodel, variables, ids, imgs,
                                                          max_new_tokens=MAX_NEW,
                                                          prefill_chunk=1))


def test_early_stop_on_a_real_eos():
    """EOS declared as the third emitted token: both loop forms pad with EOS
    after it and agree; the early loop leaves before max_new_tokens."""
    jmodel, variables, port = _pair(False, seed=3)
    ids, imgs = _prompt()
    fixed = _port_generate(port, ids, imgs, False)
    eos = int(fixed[0, 2])
    port.config = dataclasses.replace(port.config, eos_id=eos)
    jmodel2 = jq.QwenVLModel(dataclasses.replace(jmodel.config, eos_id=eos))
    want = _jax_generate(jmodel2, variables, ids, imgs, False)
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, False), want)
    np.testing.assert_array_equal(_port_generate(port, ids, imgs, True), want)
    assert (want[0, 2:] == eos).all()


def test_int4_logits_against_the_jax_cpu_fallback():
    """int4 against JAX's CPU fallback, which does not round x to bf16: the
    logits differ by the bf16 rounding of every projection's input, 2^-9 of
    each product, compounded over two layers; 2e-2 absolute on logits of
    magnitude ~1."""
    jmodel, variables, port = _pair("int4", seed=5)
    ids, imgs = _prompt()
    want, _, _ = jmodel.apply(variables, jnp.asarray(ids), jnp.asarray(imgs))
    with torch.no_grad():
        got, _, _ = port(torch.from_numpy(ids).long(), torch.from_numpy(imgs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2)
    assert np.abs(got.numpy() - np.asarray(want)).max() > 0


def test_32b_int4_parameter_bytes():
    """The flagship's storage on the meta device: decoder and lm_head packed
    int4 with f32 group scales, the rest float; it fits one 80 GB card with
    room for the KV cache and activations."""
    from multimodal_embeddings_tpu_torch.models.quantized import param_bytes

    with torch.device("meta"):
        model = tq.QwenVLModel(tq.QwenVLConfig.qwen25_vl_32b_int4(), torch.bfloat16)
    from multimodal_embeddings_tpu_torch.models.quantized import materialize

    materialize(model, "meta", torch.bfloat16)
    nbytes = param_bytes(model)
    assert 19e9 < nbytes < 21e9, nbytes
    blk = model.layer0
    assert blk.q.kernel_q4.shape == (2560, 5120) and blk.q.kernel_scale.shape == (40, 5120)
    assert blk.mlp.down.kernel_scale.shape == (216, 5120)
    assert model.lm_head.kernel_q4.shape == (2560, 152064)
