"""Golden-activation traces: the port against the JAX package.

1. The probes are bit-equal to JAX's; the statistics, probes and
   comparison are verbatim copies (sources equal).
2. Per family at tiny size (detector variant n with GL-CRM at 64 px, mmE5
   tiny, Qwen tiny), both packages on one bridged f32 tree with random
   norm parameters: ``compare_traces(jax_trace, port_trace)`` is ``ok`` at
   rtol 1e-3 / atol 1e-5 with ``output_ok``, at least the stated number of
   layers compared, every port layer present in the JAX trace and in JAX's
   order, and the JAX-only layers named: the detector's raw ``<unit>/conv``
   outputs (the port folds each BatchNorm into its conv, whose output is
   recorded as ``<unit>/bn``), none for mmE5 and Qwen.
3. With one weight perturbed in both, both packages name the same
   ``first_divergent`` against their own unperturbed trace.
4. Each package's ``load_trace`` reads the other's JSON; the traced
   forward's output equals the untraced one's, statistic for statistic.
5. The naming rules (``#i`` for repeated calls, ``@j`` for leaves in
   ``jax.tree.leaves`` order, the root left out) against
   ``trace_flax_module`` on a toy module.
"""

import dataclasses
import inspect
import json
from types import SimpleNamespace

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.analysis import activations as ja
from multimodal_embeddings_tpu.analysis import doc_parser as jdoc
from multimodal_embeddings_tpu.config import DetectorConfig as JDetectorConfig
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models.weights import flatten_params, unflatten_params
from multimodal_embeddings_tpu_torch.analysis import activations as ta
from multimodal_embeddings_tpu_torch.analysis import doc_parser as tdoc
from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.layers import ConvBnAct
from multimodal_embeddings_tpu_torch.models.transformer import Dense
from multimodal_embeddings_tpu_torch.models.weights import (
    build_qwen,
    export_jax_params,
    load_jax_params,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 1e-5  # f32 on both sides, one bridged tree
# layers compared per family (port layers; the JAX traces hold 293, 97, 48)
MIN_LAYERS = {"detector": 211, "mme5": 97, "qwen": 48}
# one kernel per family, bumped by 0.5 in both packages
PERTURBED = {"detector": "params/backbone/c2f_3/m0/cv1/conv/kernel",
             "mme5": "params/vision_model/local0/mlp/fc1/kernel",
             "qwen": "params/vision/qkv_1/kernel"}


def _randomized(flat, seed=0):
    """Random BatchNorm statistics and norm/bias offsets, so no layer is an
    identity of its init."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in flat.items():
        val = np.asarray(val)
        if val.dtype == np.float32:
            if key.endswith(("bn/var", "bn/scale")):
                val = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key.endswith(("/mean", "/scale", "/bias")):
                val = (val + rng.normal(scale=0.1, size=val.shape)).astype(np.float32)
        out[key] = val
    return out


def _detector(flat):
    cfg = DetectorConfig(image_size=64, variant="n")
    port = LayoutDetector(cfg, dtype=torch.float32, device="cpu", params=flat)
    jdet = SimpleNamespace(model=jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True),
                           variables=unflatten_params(flat),
                           config=JDetectorConfig(image_size=64, variant="n"))
    return ja.detector_trace(jdet), ta.detector_trace(port), port


def _mme5(flat):
    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                              model_config=tm.MllamaConfig.tiny(), device="cpu", params=flat)
    jemb = SimpleNamespace(model=jm.MmE5Embedder(jm.MllamaConfig.tiny()),
                           variables=unflatten_params(flat),
                           model_config=jm.MllamaConfig.tiny(), text_len=port.text_len)
    return ja.mme5_trace(jemb), ta.mme5_trace(port), port


def _qwen(flat):
    port = build_qwen(tq.QwenVLConfig.tiny(), torch.float32, "cpu", params=flat)
    jtrace = ja.qwen_trace(jq.QwenVLModel(jq.QwenVLConfig.tiny()), unflatten_params(flat),
                           image_size=56)
    return jtrace, ta.qwen_trace(port, image_size=56), port


def _seed_flat(family):
    if family == "detector":
        model = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                               device="cpu", seed=1).model
    elif family == "mme5":
        model = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"),
                                   model_config=tm.MllamaConfig.tiny(), device="cpu",
                                   seed=1).model
    else:
        model = build_qwen(tq.QwenVLConfig.tiny(), torch.float32, "cpu", seed=1)
    return _randomized(export_jax_params(model))


BUILD = {"detector": _detector, "mme5": _mme5, "qwen": _qwen}


@pytest.fixture(scope="module", params=sorted(BUILD))
def traces(request):
    family = request.param
    flat = _seed_flat(family)
    jtrace, ptrace, port = BUILD[family](flat)
    return family, flat, jtrace, ptrace, port


def test_probes_bit_equal():
    for got, want in [(ta.detector_probe(32, seed=3), ja.detector_probe(32, seed=3)),
                      *zip(ta.mme5_probe(28, 16, 256, tiles=2, seed=1),
                           ja.mme5_probe(28, 16, 256, tiles=2, seed=1)),
                      *zip(ta.qwen_probe(56, 20, 512, 5, seed=2),
                           ja.qwen_probe(56, 20, 512, 5, seed=2))]:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tdoc.IMAGE_MEAN == jdoc.IMAGE_MEAN and tdoc.IMAGE_STD == jdoc.IMAGE_STD


@pytest.mark.parametrize("name", ["tensor_stats", "detector_probe", "mme5_probe", "qwen_probe",
                                  "_close", "compare_traces", "save_trace", "load_trace"])
def test_sources_equal(name):
    want = inspect.getsource(getattr(ja, name)).replace(
        "multimodal_embeddings_tpu.", "multimodal_embeddings_tpu_torch.")
    assert inspect.getsource(getattr(ta, name)) == want
    assert ta._HEAD_N == ja._HEAD_N


def test_trace_matches_jax(traces):
    family, _, jtrace, ptrace, port = traces
    report = ja.compare_traces(jtrace, ptrace, rtol=RTOL, atol=ATOL)
    assert report["ok"] and report["output_ok"] is True, report["first_divergent"]
    assert report["layers_compared"] >= MIN_LAYERS[family]
    port_only = sorted(set(ptrace["layers"]) - set(jtrace["layers"]))
    assert not port_only
    common = [k for k in jtrace["layers"] if k in ptrace["layers"]]
    assert list(ptrace["layers"]) == common  # the port dumps in JAX's order
    jax_only = set(jtrace["layers"]) - set(ptrace["layers"])
    if family == "detector":
        units = {n.replace(".", "/") for n, m in port.model.named_modules()
                 if isinstance(m, ConvBnAct)}
        assert jax_only == {f"{u}/conv" for u in units}
        assert len(jax_only) == 82
        assert {"backbone/stem/conv", "backbone/psa/attn/qkv/conv", "head/cls0_dw1/conv",
                "neck/bu_c2fcib_5/m0/dw3/conv"} <= jax_only
        assert "backbone/stem/bn" in ptrace["layers"]
    else:
        assert jax_only == set()
    # the reverse comparison is as good, and the dump is JSON as JAX writes it
    assert ta.compare_traces(ptrace, jtrace, rtol=RTOL, atol=ATOL)["layers_ok"] == len(common)
    assert json.loads(json.dumps(ptrace)) == ptrace


def test_perturbed_weight_same_first_divergent(traces):
    family, flat, jtrace, ptrace, _ = traces
    bumped = dict(flat)
    bumped[PERTURBED[family]] = flat[PERTURBED[family]] + np.float32(0.5)
    jbad, pbad, _ = BUILD[family](bumped)
    jrep = ja.compare_traces(jtrace, jbad, rtol=RTOL, atol=ATOL)
    prep = ta.compare_traces(ptrace, pbad, rtol=RTOL, atol=ATOL)
    assert not jrep["ok"] and not prep["ok"]
    assert prep["first_divergent"] == jrep["first_divergent"] is not None
    jdiv = {r["layer"] for r in jrep["results"] if not r["ok"]}
    pdiv = {r["layer"] for r in prep["results"] if not r["ok"]}
    assert pdiv <= jdiv and len(pdiv) > 1


def test_load_trace_reads_the_other_packages_json(traces, tmp_path):
    _, _, jtrace, ptrace, _ = traces
    ja.save_trace(jtrace, str(tmp_path / "jax.json"))
    ta.save_trace(ptrace, str(tmp_path / "port.json"))
    assert ta.load_trace(str(tmp_path / "jax.json")) == json.loads(json.dumps(jtrace))
    assert ja.load_trace(str(tmp_path / "port.json")) == ptrace
    assert (tmp_path / "port.json").read_text().endswith("}\n")


def test_traced_output_equals_untraced(traces):
    family, _, _, ptrace, port = traces
    module = port.model if family != "qwen" else port
    if family == "detector":
        args = (torch.from_numpy(ta.detector_probe(64)),)
    elif family == "mme5":
        cfg = port.model_config
        args = [torch.from_numpy(a) for a in ta.mme5_probe(cfg.vision.image_size, port.text_len,
                                                          cfg.text.vocab_size)]
        args[0], args[3] = args[0].long(), args[3].long()
    else:
        cfg = port.config
        tokens, images = ta.qwen_probe(56, 20, cfg.text.vocab_size, cfg.image_pad_id)
        args = (torch.from_numpy(tokens).long(), torch.from_numpy(images))
    with torch.inference_mode():
        out = module(*args)
    first = ta._leaves(out)[0]
    assert ta.device_tensor_stats(first) == ptrace["output"]
    assert not any(m._forward_hooks for m in module.modules())  # the hooks are gone


def test_device_stats_equal_tensor_stats():
    """The device reduction in float64 gives ``tensor_stats``' record (numpy,
    on the host) to float64 rounding, for f32, bf16, int and empty tensors."""
    rng = np.random.default_rng(0)
    for x in (torch.from_numpy(rng.normal(size=(3, 5, 7)).astype(np.float32)),
              torch.from_numpy(rng.normal(size=(40,)).astype(np.float32)).bfloat16(),
              torch.arange(5, dtype=torch.int32), torch.zeros(0, 3), torch.ones(2, 2) > 0):
        got, want = ta.device_tensor_stats(x), ta.tensor_stats(x.float().numpy())
        assert got["shape"] == want["shape"] and len(got["head"]) == len(want["head"])
        for key in ("mean", "std", "min", "max", "absmean"):
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=1e-15)
        np.testing.assert_array_equal(got["head"], want["head"])


class _JaxToy(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        d = fnn.DenseGeneral((2, 3), name="d")
        a, b = d(x), d(2 * x)
        h = fnn.Dense(4, name="h")(a.reshape(*a.shape[:-2], 6))
        return {"b": b, "a": h}, fnn.relu(h)


class _PortToy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.d = Dense(5, 6, kernel_shape=(5, 2, 3), bias_shape=(2, 3))
        self.h = Dense(6, 4)

    def forward(self, x):
        a, b = self.d(x), self.d(2 * x)
        h = self.h(a)
        return {"b": b.reshape(*b.shape[:-1], 2, 3), "a": h}, torch.relu(h)


def test_naming_rules_equal_trace_flax_module():
    x = np.random.default_rng(1).normal(size=(2, 5)).astype(np.float32)
    variables = _JaxToy().init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = ja.trace_flax_module(_JaxToy(), variables, (jnp.asarray(x),))
    port = _PortToy()
    load_jax_params(port, flatten_params(variables))
    got = ta.trace_module(port, (torch.from_numpy(x),))
    assert list(got["layers"]) == list(want["layers"]) == ["d#0", "d#1", "h"]
    assert ja.compare_traces(want, got, rtol=1e-6, atol=1e-7)["ok"]
    assert got["layers"]["d#0"]["shape"] == [2, 2, 3]  # DenseGeneral's output axes
    assert got["output"]["shape"] == want["output"]["shape"] == [2, 4]  # dict leaves sorted
    tapped = ta.trace_module(port, (torch.from_numpy(x),), taps="^h$")
    assert list(tapped["layers"]) == ["h"] and tapped["output"] == got["output"]


def test_quantized_dense_outputs_in_jax_axes():
    """An int8 text stack's q/k/v record JAX's (B, L, H, D) like the float
    ones (the quantized sites carry the float kernel's shape)."""
    cfg = dataclasses.replace(tm.MllamaConfig.tiny(), quantize="int8-mixed")
    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"), model_config=cfg,
                              device="cpu", seed=2)
    trace = ta.mme5_trace(port)
    t = cfg.text
    assert trace["layers"]["text_model/layer0/attn/q"]["shape"] == [1, port.text_len, t.heads,
                                                                    t.head_dim]
    assert trace["layers"]["text_model/layer0/attn/o"]["shape"] == [1, port.text_len, t.hidden]
