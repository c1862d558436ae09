"""Pipeline parallelism in the port (``parallel/pipeline.py``,
``models/qwen_pp.py``) against the JAX package's, every case of JAX's
``tests/test_pipeline_parallel.py`` mirrored.

The multi-stage cases run in ONE spawn of 4 gloo ranks for the module (a
module-scoped fixture; the ranks import torch and the port only), their
weights JAX inits bridged by ``load_jax_params``; the JAX references run
here on the 8-device virtual CPU mesh. Tolerances: a pipelined stack
against JAX's sequential stack within 1e-4 absolute (f32, up to 8 layers,
the ISSUE's bound for the dryrun), against the port's own sequential stack
within 1e-5 (the same arithmetic, batch-size-dependent BLAS blocking);
greedy tokens EQUAL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import unbox

from multimodal_embeddings_tpu.kernels import quantization_int4 as jq4
from multimodal_embeddings_tpu.models import quantized as jquant
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models.qwen_pp import pp_greedy_generate as jax_pp_generate
from multimodal_embeddings_tpu.models.transformer import LlamaBlock as JaxLlamaBlock
from multimodal_embeddings_tpu.models.weights import flatten_params
from multimodal_embeddings_tpu.parallel.pipeline import make_pp_mesh as jax_pp_mesh
from multimodal_embeddings_tpu_torch.core.mesh import launch
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models.qwen_pp import pp_greedy_generate
from multimodal_embeddings_tpu_torch.models.transformer import LlamaBlock
from multimodal_embeddings_tpu_torch.models.weights import build_qwen, load_jax_params
from multimodal_embeddings_tpu_torch.parallel import dryrun
from multimodal_embeddings_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipeline_apply,
    stack_layer_params,
)

torch.set_num_threads(2)

JAX_ATOL = 1e-4
SELF_ATOL = 1e-5
BLOCK = dict(width=64, num_heads=4, num_kv_heads=2, head_dim=16, mlp_hidden=128)
APPLY_CASES = [(4, 4, 8), (2, 8, 8), (4, 2, 8), (4, 4, 4)]  # (stages, microbatches, batch)
MAX_NEW = 4


def _llama_stack(n_layers, seed=0):
    """JAX LlamaBlock params (flat, one dict a layer) and the JAX block."""
    block = JaxLlamaBlock(num_heads=4, num_kv_heads=2, head_dim=16, mlp_hidden=128,
                          max_len=32, dtype=jnp.float32)
    x0 = jnp.zeros((1, 8, 64), jnp.float32)
    keys = jax.random.split(jax.random.key(seed), n_layers)
    params = [unbox(block.init(k, x0))["params"] for k in keys]
    return block, params, [flatten_params({"params": p}) for p in params]


def _jax_sequential(block, params, x):
    h = jnp.asarray(x)
    for p in params:
        h = block.apply({"params": p}, h)
    return np.asarray(h)


def _port_sequential(flats, x):
    h = torch.from_numpy(x)
    with torch.inference_mode():
        for flat in flats:
            layer = LlamaBlock(**BLOCK)
            load_jax_params(layer, flat)
            h = layer(h)
    return h.numpy()


def _inv_freq(cfg):
    return 1.0 / (cfg.rope_theta
                  ** (jnp.arange(0, cfg.head_dim, 2, dtype=jnp.float32) / cfg.head_dim))


def _interpret_int4_apply(x, qt, use_kernel=None):
    lead = x.shape[:-1]
    y = jq4.int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale, interpret=True)
    return y.reshape(*lead, qt.packed.shape[-1])


def _qwen_variables(config, prompt, images=None, seed=3):
    model = jq.QwenVLModel(dataclasses.replace(config, quantize=False), dtype=jnp.float32)
    args = (jnp.asarray(prompt),) if images is None else (jnp.asarray(prompt),
                                                          jnp.asarray(images))
    return unbox(model.init(jax.random.key(seed), *args))


def _quantized(config, variables, prompt, images):
    from multimodal_embeddings_tpu.models.quantized import quantize_dense_tree

    qmodel = jq.QwenVLModel(config, dtype=jnp.float32)
    target = jax.eval_shape(lambda: qmodel.init(jax.random.key(3), jnp.asarray(prompt),
                                                jnp.asarray(images)))
    return {"params": quantize_dense_tree(variables["params"], unbox(target)["params"])}


@pytest.fixture(scope="module")
def cases(devices8):
    """The JAX references, and the port's results from one 4-rank spawn."""
    refs, port = {}, []
    rng = np.random.default_rng(0)
    block, params, flats = _llama_stack(8)
    for s, m, b in APPLY_CASES:
        x = rng.normal(size=(b, 8, 64)).astype(np.float32)
        layers = flats if b == 8 else flats[:4]
        refs[("apply", s, m, b)] = (_jax_sequential(block, params[: len(layers)], x),
                                    _port_sequential(layers, x))
        port.append(("pipeline_case", dict(kind="apply", n_stages=s, block_args=BLOCK,
                                           layers=layers, x=x, microbatches=m)))

    # the Qwen decoder's prefill over 4 stages (8 QwenBlocks, 1-D rotary)
    cfg = jq.QwenVLConfig.tiny().text
    qblock = jq.QwenBlock(cfg, dtype=jnp.float32)
    length = 8
    inv = _inv_freq(cfg)
    freqs = jnp.outer(jnp.arange(length, dtype=jnp.float32), inv)[None]
    cos, sin = jnp.cos(freqs), jnp.sin(freqs)
    x0 = jnp.zeros((1, length, cfg.hidden), jnp.float32)
    qparams = [unbox(qblock.init(k, x0, cos, sin))["params"]
               for k in jax.random.split(jax.random.key(7), 8)]
    x = np.random.default_rng(5).normal(size=(8, length, cfg.hidden)).astype(np.float32)
    ref = jnp.asarray(x)
    for p in qparams:
        ref, _ = qblock.apply({"params": p}, ref, cos, sin)
    refs["qwen_prefill"] = np.asarray(ref)
    tcfg = tq.QwenVLConfig.tiny().text
    port.append(("pipeline_case", dict(
        kind="qwen_prefill", n_stages=4, text_config=tcfg,
        layers=[flatten_params({"params": p}) for p in qparams], x=x,
        cos=np.asarray(cos), sin=np.asarray(sin), microbatches=4)))

    # cached decode: 4 QwenBlocks over 2 stages, 3 steps
    b, maxlen = 2, 8

    def tables(pos):
        f = (jnp.full((b, 1), float(pos)) * inv[None]).reshape(b, 1, -1)
        return jnp.cos(f), jnp.sin(f)

    cos0, sin0 = tables(0)
    zero = (jnp.zeros((b, maxlen, cfg.kv_heads, cfg.head_dim), jnp.float32),) * 2
    dparams = [unbox(qblock.init(k, jnp.zeros((b, 1, cfg.hidden)), cos0, sin0, cache=zero,
                                 position=0))["params"]
               for k in jax.random.split(jax.random.key(11), 4)]
    rng = np.random.default_rng(9)
    caches = [zero] * 4
    hs, tabs, outs = [], [], []
    for pos in range(3):
        c, s_ = tables(pos)
        h = rng.normal(size=(b, 1, cfg.hidden)).astype(np.float32)
        ref = jnp.asarray(h)
        new = []
        for p, cache in zip(dparams, caches):
            ref, c2 = qblock.apply({"params": p}, ref, c, s_, cache=cache, position=pos)
            new.append(c2)
        caches = new
        hs.append(h)
        tabs.append((np.asarray(c), np.asarray(s_)))
        outs.append(np.asarray(ref))
    refs["decode"] = (outs, [(np.asarray(k), np.asarray(v)) for k, v in caches])
    port.append(("pipeline_case", dict(
        kind="decode", n_stages=2, text_config=tcfg,
        layers=[flatten_params({"params": p}) for p in dparams], batch=b, max_len=maxlen,
        hs=hs, tables=tabs)))

    # pp_greedy_generate: text-only, multimodal, int8, int4 over 2 stages
    config = jq.QwenVLConfig.tiny()
    prompt = np.random.default_rng(21).integers(10, config.text.vocab_size, (2, 6)).astype(
        np.int32)
    unit = config.vision.patch_size * config.vision.merge_size
    rng = np.random.default_rng(31)
    images = rng.random((1, 2 * unit, 2 * unit, 3)).astype(np.float32)
    mm_prompt = np.concatenate([rng.integers(10, config.text.vocab_size, (1, 3)),
                                np.full((1, 4), config.image_pad_id),
                                rng.integers(10, config.text.vocab_size, (1, 3))],
                               axis=1).astype(np.int32)
    mesh = jax_pp_mesh(2, devices8)
    # every case's weights hold the vision tower (an init with an image),
    # which the port's model builds whatever the prompt
    variables = _qwen_variables(config, mm_prompt, images)
    generate = {
        "text": (config, variables, prompt, None),
        "multimodal": (config, variables, mm_prompt, images),
    }
    for quantize in (True, "int4"):
        qcfg = dataclasses.replace(config, quantize=quantize)
        generate[str(quantize)] = (qcfg, _quantized(qcfg, variables, mm_prompt, images),
                                   prompt, None)
    mp = pytest.MonkeyPatch()
    # int4: the JAX Pallas kernel in interpret mode rounds x to bf16, as K3's
    # plain version does (the JAX CPU fallback does not)
    mp.setattr(jquant, "int4_apply", _interpret_int4_apply)
    mp.setattr(jq4, "int4_apply", _interpret_int4_apply)
    for name, (qcfg, variables, p, imgs) in generate.items():
        # JAX's pipelined generate retraces its ring at every position (~30 s
        # a case here), so it runs for the text case; JAX's own tests lock its
        # single-device greedy tokens to it, which stand for it in the others
        # (its int4 cannot run the interpret-mode kernel inside its shard_map
        # at all: Pallas asks for the output's varying axes)
        want = None if name != "text" else jax_pp_generate(
            qcfg, variables, p, mesh=mesh, n_stages=2, max_new_tokens=MAX_NEW, images=imgs)
        single = np.asarray(jq.greedy_generate(jq.QwenVLModel(qcfg, dtype=jnp.float32),
                                               variables, p, images=imgs,
                                               max_new_tokens=MAX_NEW))
        refs[("generate", name)] = (single if want is None else want, single)
        tcfg_gen = dataclasses.replace(tq.QwenVLConfig.tiny(), quantize=quantize_of(name))
        port.append(("pipeline_case", dict(
            kind="generate", n_stages=2, config=tcfg_gen,
            params=flatten_params(variables), prompt=p, images=imgs,
            max_new_tokens=MAX_NEW)))
    mp.undo()
    results = launch(dryrun.run_cases, 4, port, device="cpu", timeout=300)
    return refs, results


def quantize_of(name):
    return {"text": False, "multimodal": False, "True": True, "int4": "int4"}[name]


@pytest.mark.parametrize("i", range(len(APPLY_CASES)))
def test_pipeline_matches_sequential(cases, i):
    """S ∈ {2, 4}, M ∈ {2, 4, 8} (and microbatches of one row): the
    pipelined stack on every rank of the stage mesh equals the sequential
    one; the ranks outside a 2-stage mesh return nothing."""
    refs, results = cases
    s, m, b = APPLY_CASES[i]
    want_jax, want_port = refs[("apply", s, m, b)]
    for rank, per_rank in enumerate(results):
        got = per_rank[i]
        if rank >= s:
            assert got is None
            continue
        np.testing.assert_allclose(got["out"], want_jax, atol=JAX_ATOL)
        np.testing.assert_allclose(got["out"], want_port, atol=SELF_ATOL)


def test_pipeline_single_stage_degenerate():
    """S = 1 is a plain loop: no process group needed."""
    _, _, flats = _llama_stack(4)
    x = np.random.default_rng(1).normal(size=(4, 8, 64)).astype(np.float32)
    layers = []
    for flat in flats:
        layer = LlamaBlock(**BLOCK)
        load_jax_params(layer, flat)
        layers.append(layer)
    with torch.inference_mode():
        out = pipeline_apply(lambda layer, h: layer(h), stack_layer_params(layers, 1),
                             torch.from_numpy(x), mesh=make_pp_mesh(1), num_microbatches=2)
    np.testing.assert_array_equal(out.numpy(), _port_sequential(flats, x))


def test_stack_layer_params_validation():
    with pytest.raises(ValueError, match="not divisible by 3 stages"):
        stack_layer_params(list(range(4)), 3)
    assert stack_layer_params(list(range(4)), 2) == [[0, 1], [2, 3]]


def test_batch_divisibility_validation():
    with pytest.raises(ValueError, match="not divisible by microbatches 3"):
        pipeline_apply(lambda layer, h: h, [[None]], torch.zeros(5, 8, 64),
                       mesh=make_pp_mesh(1), num_microbatches=3)
    with pytest.raises(ValueError, match="need 2 devices"):
        make_pp_mesh(2)


def test_qwen_pp_prefill_matches_sequential(cases):
    refs, results = cases
    got = results[0][len(APPLY_CASES)]["out"]
    np.testing.assert_allclose(got, refs["qwen_prefill"], atol=JAX_ATOL)


def test_pipeline_decode_step_with_kv_caches(cases):
    """Three cached decode steps of 4 QwenBlocks over 2 stages: outputs on
    every stage rank, and each stage's caches (its 2 layers), equal JAX's
    sequential stack."""
    refs, results = cases
    outs, caches = refs["decode"]
    i = len(APPLY_CASES) + 1
    for rank in (0, 1):
        got = results[rank][i]
        assert got["stage"] == rank
        for a, b in zip(got["outs"], outs):
            np.testing.assert_allclose(a, b, atol=JAX_ATOL)
        for (k, v), (wk, wv) in zip(got["caches"], caches[2 * rank : 2 * rank + 2]):
            np.testing.assert_allclose(k, wk, atol=JAX_ATOL)
            np.testing.assert_allclose(v, wv, atol=JAX_ATOL)
    assert results[2][i] is None and results[3][i] is None


@pytest.mark.parametrize("j,name", enumerate(["text", "multimodal", "True", "int4"]))
def test_pp_greedy_generate_equal_jax(cases, j, name):
    """``pp_greedy_generate`` over 2 stages, text-only, multimodal (the vision
    tower before the ring, its tokens in the image-pad slots), int8 and int4:
    tokens EQUAL to JAX's (pipelined for the text case, which equals its
    single-device greedy tokens; single-device for the others), on both
    stage ranks."""
    refs, results = cases
    want, single = refs[("generate", name)]
    np.testing.assert_array_equal(want, single)
    i = len(APPLY_CASES) + 2 + j
    for rank in (0, 1):
        np.testing.assert_array_equal(results[rank][i]["tokens"], want)


def test_pp_greedy_generate_one_stage_equals_greedy_generate():
    """With one stage (no process group), the port's ``pp_greedy_generate``
    gives ``greedy_generate``'s tokens on the same model (the chip phase's
    check, here on the CPU); a model or a JAX flat dict."""
    config = tq.QwenVLConfig.tiny()
    model = build_qwen(config, torch.float32, "cpu", seed=3)
    prompt = np.random.default_rng(21).integers(10, config.text.vocab_size, (2, 6))
    want = tq.greedy_generate(model, prompt, max_new_tokens=6)
    got = pp_greedy_generate(config, model, prompt, mesh=make_pp_mesh(1), n_stages=1,
                             max_new_tokens=6)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2
    with pytest.raises(ValueError, match="exceed max_len"):
        pp_greedy_generate(config, model, prompt, mesh=make_pp_mesh(1), n_stages=1,
                           max_new_tokens=config.text.max_len)
