"""The published-checkpoint key maps and the torch state-dict loader: the
port against the JAX package.

1. ``models/hf_port.py`` is a verbatim copy: the sources are equal, and the
   three maps give JAX's answer (``None`` for a skipped key included) on
   every key the JAX test's generators produce, for the tiny, 2b and 11b
   mmE5 configs, the tiny Qwen config and the whole DocLayout tree.
2. ``adapt_torch_tensor`` gives JAX's answer on every case of JAX's
   ``TestTorchTensorAdaptation``.
3. One synthetic state dict under the published key names, per family at
   tiny size (ultralytics names for the detector), loaded by JAX's
   ``load_torch_state_dict`` and by the port's: the port's parameters
   (``export_jax_params``) equal JAX's on every mapped leaf (a ``ConvBnAct``
   unit compared folded, within 1e-6), and the forwards agree in f32
   (detector head maps within 1e-4, mmE5 embeddings and Qwen logits within
   1e-4).
4. A size mismatch raises in both; a ``ConvBnAct`` unit mapped in part
   raises in the port (which holds the BatchNorm folded into the conv).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_embeddings_tpu.models import hf_port as jhf
from multimodal_embeddings_tpu.models import mme5 as jm
from multimodal_embeddings_tpu.models import qwen_vl as jq
from multimodal_embeddings_tpu.models import weights as jw
from multimodal_embeddings_tpu.models import yolo as jyolo
from multimodal_embeddings_tpu.models.weights import unflatten_params
from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.models import hf_port as thf
from multimodal_embeddings_tpu_torch.models import mme5 as tm
from multimodal_embeddings_tpu_torch.models import qwen_vl as tq
from multimodal_embeddings_tpu_torch.models import weights as tw
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.layers import ConvBnAct
from test_hf_port import inverse_doclayout_key, synthetic_mllama_keys

torch.set_num_threads(2)

MME5_CONFIGS = {"tiny": "tiny", "2b": "mme5_2b", "11b": "mme5_11b"}


@pytest.mark.parametrize("name", ["make_mme5_key_map", "_mme5_key_map", "qwen25_vl_key_map",
                                  "_conv_bn", "doclayout_key_map", "_with_collection",
                                  "_head_key"])
def test_key_map_sources_equal(name):
    assert inspect.getsource(getattr(thf, name)) == inspect.getsource(getattr(jhf, name))


@pytest.mark.parametrize("name", ["torch_conv_to_flax", "adapt_torch_tensor",
                                  "_looks_like_linear"])
def test_adapt_sources_equal(name):
    assert inspect.getsource(getattr(tw, name)) == inspect.getsource(getattr(jw, name))
    assert tw._LINEAR_HINTS == jw._LINEAR_HINTS
    assert thf._YOLO_INDEX_TO_MODULE == jhf._YOLO_INDEX_TO_MODULE


def _unknown_mme5_keys():
    return ["language_model.lm_head.weight", "something.else",
            "vision_model.transformer.layers.0.unknown.weight",
            "vision_model.transformer.layers.0.gate_attn",
            "vision_model.global_transformer.layers.0.self_attn.qk_norm.weight"]


@pytest.mark.parametrize("size", sorted(MME5_CONFIGS))
def test_mme5_map_answers_as_jax(size):
    jcfg = getattr(jm.MllamaConfig, MME5_CONFIGS[size])()
    tcfg = getattr(tm.MllamaConfig, MME5_CONFIGS[size])()
    keys = synthetic_mllama_keys(jcfg) + _unknown_mme5_keys()
    assert keys == synthetic_mllama_keys(tcfg) + _unknown_mme5_keys()
    jmap, tmap = jhf.make_mme5_key_map(jcfg), thf.make_mme5_key_map(tcfg)
    answers = [tmap(k) for k in keys]
    assert answers == [jmap(k) for k in keys]
    assert answers.count(None) == len(_unknown_mme5_keys())


def _qwen_keys(config):
    """Every key of a Qwen2_5_VLForConditionalGeneration state dict, and
    some the map skips."""
    keys = ["model.embed_tokens.weight", "model.norm.weight", "lm_head.weight",
            "visual.patch_embed.proj.weight", "visual.merger.ln_q.weight",
            "visual.merger.mlp.0.weight", "visual.merger.mlp.0.bias",
            "visual.merger.mlp.2.weight", "visual.merger.mlp.2.bias",
            "model.rotary_emb.inv_freq", "visual.rotary_pos_emb.inv_freq"]
    for i in range(config.text.layers):
        keys += [f"model.layers.{i}.self_attn.{p}_proj.{leaf}"
                 for p in "qkv" for leaf in ("weight", "bias")]
        keys += [f"model.layers.{i}.self_attn.o_proj.weight",
                 f"model.layers.{i}.input_layernorm.weight",
                 f"model.layers.{i}.post_attention_layernorm.weight"]
        keys += [f"model.layers.{i}.mlp.{p}_proj.weight" for p in ("gate", "up", "down")]
    for i in range(config.vision.layers):
        for part in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2"):
            keys += [f"visual.blocks.{i}.{part}.weight", f"visual.blocks.{i}.{part}.bias"]
        keys.append(f"visual.blocks.{i}.mlp.gate_proj.weight")
    return keys


def test_qwen_map_answers_as_jax():
    keys = _qwen_keys(tq.QwenVLConfig.tiny())
    answers = [thf.qwen25_vl_key_map(k) for k in keys]
    assert answers == [jhf.qwen25_vl_key_map(k) for k in keys]
    assert answers.count(None) == 3 + tq.QwenVLConfig.tiny().vision.layers


def _det_flat(glcrm=True, seed=3):
    """A tiny detector's parameters in the JAX layout, BatchNorm random."""
    cfg = DetectorConfig(image_size=64, variant="n", glcrm=glcrm)
    flat = tw.export_jax_params(
        LayoutDetector(cfg, dtype=torch.float32, device="cpu", seed=seed).model)
    rng = np.random.default_rng(seed)
    for key, val in flat.items():
        if key.endswith(("bn/var", "bn/scale")):
            flat[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
        elif key.endswith(("bn/mean", "bn/bias")):
            flat[key] = rng.normal(scale=0.2, size=val.shape).astype(np.float32)
    return flat


_DET_DISTRACTORS = ["model.0.bn.num_batches_tracked", "model.23.cv2.0.0.conv.weight",
                    "model.11.unknown", "model.23.one2one_cv3.0.3.weight", "model.23.dfl.conv.weight",
                    "model.model.2.cv1.conv.weight", "other.0.conv.weight"]


@pytest.mark.parametrize("glcrm", [False, True])
def test_doclayout_map_answers_as_jax(glcrm):
    keys = [inverse_doclayout_key(k) for k in _det_flat(glcrm)] + _DET_DISTRACTORS
    answers = [thf.doclayout_key_map(k) for k in keys]
    assert answers == [jhf.doclayout_key_map(k) for k in keys]
    assert answers.count(None) == 6


# -- adapt_torch_tensor: JAX's TestTorchTensorAdaptation cases ----------------

def _adapt_cases():
    rng = np.random.default_rng(0)
    return {
        "linear_2d_transposed": (rng.normal(size=(12, 8)).astype(np.float32), (8, 12),
                                 "model.layers.0.mlp.gate_proj.weight"),
        "square_linear": (rng.normal(size=(6, 6)).astype(np.float32), (6, 6),
                          "visual.merger.mlp.0.weight"),
        "embedding_direct": (rng.normal(size=(100, 16)).astype(np.float32), (100, 16),
                             "model.embed_tokens.weight"),
        "densegeneral_3d": (np.arange(64, dtype=np.float32).reshape(8, 8), (8, 4, 2),
                            "self_attn.q_proj.weight"),
        "oproj_3d": (np.arange(64, dtype=np.float32).reshape(8, 8), (4, 2, 8),
                     "self_attn.o_proj.weight"),
        "conv_hwio": (rng.normal(size=(16, 3, 7, 7)).astype(np.float32), (7, 7, 3, 16),
                      "patch_embed.weight"),
        "conv3d_summed": (rng.normal(size=(16, 3, 2, 4, 4)).astype(np.float32), (4, 4, 3, 16),
                          "visual.patch_embed.proj.weight"),
        "bias_1d": (rng.normal(size=(12,)).astype(np.float32), (3, 4), "attn.qkv.bias"),
    }


@pytest.mark.parametrize("case", sorted(_adapt_cases()))
def test_adapt_torch_tensor_equals_jax(case):
    arr, shape, key = _adapt_cases()[case]
    got, want = tw.adapt_torch_tensor(arr, shape, key), jw.adapt_torch_tensor(arr, shape, key)
    assert got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arr,shape", [(np.zeros((4, 5), np.float32), (4, 6)),
                                       (np.zeros((8, 3, 3, 3), np.float32), (3, 3, 3, 4))])
def test_adapt_size_mismatch_raises_in_both(arr, shape):
    for adapt in (tw.adapt_torch_tensor, jw.adapt_torch_tensor):
        with pytest.raises(ValueError):
            adapt(arr, shape, "x.weight")


# -- one synthetic state dict into both packages ------------------------------

def _ultralytics_state(flat):
    """The ultralytics state dict of a JAX-layout detector tree (JAX test's
    inverse map), plus entries the map must skip."""
    state = {}
    for fkey, arr in flat.items():
        tarr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr
        state[inverse_doclayout_key(fkey)] = torch.from_numpy(np.ascontiguousarray(tarr))
    state["model.0.bn.num_batches_tracked"] = torch.zeros(1)
    state["model.23.cv2.0.0.conv.weight"] = torch.zeros(1, 1, 1, 1)
    return state


_UNIT_LEAVES = (("params", "conv/kernel"), ("params", "bn/scale"), ("params", "bn/bias"),
                ("batch_stats", "bn/mean"), ("batch_stats", "bn/var"))


def _leaf_equal_detector(port_flat, jax_flat):
    """Every leaf equal; a ConvBnAct unit compared folded (the port's export
    carries an identity BatchNorm around the folded weight)."""
    units = sorted(k[len("params/"):-len("/conv/kernel")] for k in jax_flat
                   if k.endswith("/conv/kernel"))
    unit_keys = set()
    for unit in units:
        keys = [f"{c}/{unit}/{leaf}" for c, leaf in _UNIT_LEAVES]
        unit_keys.update(keys)
        w, b = tw.fold_conv_bn(*(np.asarray(jax_flat[k]) for k in keys))
        pw, pb = tw.fold_conv_bn(*(port_flat[k] for k in keys))
        np.testing.assert_allclose(pw, w, rtol=1e-6, atol=1e-6, err_msg=unit)
        np.testing.assert_allclose(pb, b, rtol=1e-6, atol=1e-6, err_msg=unit)
    rest = sorted(set(jax_flat) - unit_keys)
    assert len(rest) > 10  # the GL-CRM gates and the head's output convs
    for key in rest:
        np.testing.assert_array_equal(port_flat[key], np.asarray(jax_flat[key]), err_msg=key)


def test_ultralytics_state_dict_loads_as_in_jax(tmp_path):
    flat = _det_flat(glcrm=True)
    path = str(tmp_path / "docstructbench.pt")
    torch.save(_ultralytics_state(flat), path)
    zeros = unflatten_params({k: np.zeros_like(v) for k, v in flat.items()})
    jflat = jw.flatten_params(jw.load_torch_state_dict(path, zeros, jhf.doclayout_key_map))
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu", seed=11)
    assert tw.load_torch_state_dict(path, det.model, thf.doclayout_key_map) is det.model
    _leaf_equal_detector(tw.export_jax_params(det.model), jflat)
    x = np.random.default_rng(2).uniform(size=(1, 64, 64, 3)).astype(np.float32)
    jmodel = jyolo.DocLayoutYOLO(num_classes=10, variant="n", glcrm=True)
    want = jax.jit(lambda v, im: jmodel.apply(v, im, train=False))(
        unflatten_params(jflat), jnp.asarray(x))
    with torch.no_grad():
        got = det.model(torch.from_numpy(x))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _hf_state(keys, key_map, port_model, flat, conv3d=()):
    """Random torch tensors under ``keys`` in the published layouts: a
    Linear ``(out, in)`` of the port's ``Dense``, a conv OIHW (a Conv3d with
    a temporal axis of 2 for ``conv3d`` keys), anything else the JAX leaf's
    shape."""
    rng = np.random.default_rng(9)
    modules = dict(port_model.named_modules())
    state = {}
    for key in keys:
        target = key_map(key)
        if target is None:
            continue
        shape = flat[target].shape
        path = target.split("/", 1)[1].rsplit("/", 1)[0].replace("/", ".")
        if len(shape) == 4:
            shape = (shape[3], shape[2], *shape[:2])
            if key in conv3d:
                shape = (*shape[:2], 2, *shape[2:])
        elif target.endswith("/kernel"):
            shape = tuple(modules[path].weight.shape[::-1])
        arr = rng.normal(scale=0.05, size=shape)
        if key.endswith(("norm.weight", "layernorm.weight", "_norm.weight", "norm1.weight",
                         "norm2.weight", "layernorm_pre.weight", "layernorm_post.weight")):
            arr = 1 + arr
        state[key] = torch.from_numpy(arr.astype(np.float32))
    state["unmapped.extra.weight"] = torch.zeros(3)
    return state


def test_mme5_state_dict_loads_as_in_jax(tmp_path):
    cfg = tm.MllamaConfig.tiny()
    port = MultimodalEmbedder(EmbedderConfig(family="mme5", dtype="float32"), model_config=cfg,
                              device="cpu", seed=1)
    flat = tw.export_jax_params(port.model)
    key_map = thf.make_mme5_key_map(cfg)
    state = _hf_state(synthetic_mllama_keys(cfg), key_map, port.model, flat)
    path = str(tmp_path / "mme5.pt")
    torch.save(state, path)
    jvars = jw.load_torch_state_dict(path, unflatten_params(flat),
                                     jhf.make_mme5_key_map(jm.MllamaConfig.tiny()))
    jflat = jw.flatten_params(jvars)
    tw.load_torch_state_dict(path, port.model, key_map)
    got = tw.export_jax_params(port.model)
    mapped = {key_map(k) for k in state} - {None}
    assert mapped == set(flat)  # the synthetic keys reach every leaf
    for key in mapped:
        np.testing.assert_array_equal(got[key], np.asarray(jflat[key]), err_msg=key)
    rng = np.random.default_rng(3)
    crops = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    ids = rng.integers(1, 256, size=(2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    want = jm.MmE5Embedder(jm.MllamaConfig.tiny()).apply(
        jvars, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(crops))
    with torch.no_grad():
        out = port.model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                         torch.from_numpy(crops))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4)


def test_qwen_state_dict_loads_as_in_jax(tmp_path):
    cfg = tq.QwenVLConfig.tiny()
    model = tw.build_qwen(cfg, torch.float32, "cpu", seed=1)
    flat = tw.export_jax_params(model)
    state = _hf_state(_qwen_keys(cfg), thf.qwen25_vl_key_map, model, flat,
                      conv3d=("visual.patch_embed.proj.weight",))
    path = str(tmp_path / "qwen.pt")
    torch.save(state, path)
    jvars = jw.load_torch_state_dict(path, unflatten_params(flat), jhf.qwen25_vl_key_map)
    jflat = jw.flatten_params(jvars)
    tw.load_torch_state_dict(path, model, thf.qwen25_vl_key_map)
    got = tw.export_jax_params(model)
    mapped = {thf.qwen25_vl_key_map(k) for k in state} - {None}
    # the map has no rule for the vision tower's last LayerNorm (HF's
    # visual.merger.ln_q): both packages keep the model's own values there
    assert set(flat) - mapped == {"params/vision/final_ln/scale", "params/vision/final_ln/bias"}
    for key in set(flat) - mapped:
        np.testing.assert_array_equal(got[key], np.asarray(jflat[key]), err_msg=key)
    for key in mapped:
        np.testing.assert_array_equal(got[key], np.asarray(jflat[key]), err_msg=key)
    rng = np.random.default_rng(4)
    ids = rng.integers(6, 200, size=(1, 12)).astype(np.int32)
    ids[0, 3:7] = cfg.image_pad_id
    imgs = rng.normal(size=(1, 56, 56, 3)).astype(np.float32)
    want = jq.QwenVLModel(jq.QwenVLConfig.tiny()).apply(jvars, jnp.asarray(ids), jnp.asarray(imgs))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long(), torch.from_numpy(imgs))[0]
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax.tree.leaves(want)[0]), atol=1e-4)


def test_state_dict_size_mismatch_raises_in_both(tmp_path):
    cfg = tq.QwenVLConfig.tiny()
    model = tw.build_qwen(cfg, torch.float32, "cpu", seed=1)
    flat = tw.export_jax_params(model)
    path = str(tmp_path / "bad.pt")
    torch.save({"lm_head.weight": torch.zeros(3, 5)}, path)
    with pytest.raises(ValueError, match="size mismatch"):
        jw.load_torch_state_dict(path, unflatten_params(flat), jhf.qwen25_vl_key_map)
    with pytest.raises(ValueError, match="size mismatch"):
        tw.load_torch_state_dict(path, model, thf.qwen25_vl_key_map)
    torch.save({"model.layers.0.self_attn.q_proj.weight": torch.zeros(1)}, path)
    with pytest.raises(KeyError):  # mapped onto a key the model lacks
        tw.load_torch_state_dict(path, torch.nn.Module(), thf.qwen25_vl_key_map)


@pytest.mark.parametrize("leaves", [["conv.weight"], ["bn.weight", "bn.bias"],
                                    ["conv.weight", "bn.weight", "bn.bias", "bn.running_mean"]])
def test_partial_conv_bn_unit_raises_in_the_port(tmp_path, leaves):
    """JAX keeps its init for the unmapped leaves of a unit; the port holds
    conv and BatchNorm folded, so it refuses a unit mapped in part."""
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu")
    flat = tw.export_jax_params(det.model)
    state = {}
    for leaf in leaves:
        fkey = jhf.doclayout_key_map(f"model.0.{leaf}")
        arr = flat[fkey]
        state[f"model.0.{leaf}"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr))
    path = str(tmp_path / "partial.pt")
    torch.save(state, path)
    jw.load_torch_state_dict(path, unflatten_params(flat), jhf.doclayout_key_map)
    with pytest.raises(ValueError, match="backbone/stem"):
        tw.load_torch_state_dict(path, det.model, thf.doclayout_key_map)
    assert isinstance(det.model.backbone.stem, ConvBnAct)


def test_whole_conv_bn_units_and_the_rest_untouched(tmp_path):
    """A state dict mapping only whole units (the stem) replaces them and
    leaves every other parameter as it was."""
    det = LayoutDetector(DetectorConfig(image_size=64, variant="n"), dtype=torch.float32,
                         device="cpu", seed=2)
    before = {k: v.clone() for k, v in det.model.state_dict().items()}
    flat = _det_flat(seed=5)
    state = {k: v for k, v in _ultralytics_state(flat).items() if k.startswith("model.0.")}
    path = str(tmp_path / "stem.pt")
    torch.save(state, path)
    tw.load_torch_state_dict(path, det.model, thf.doclayout_key_map)
    after = det.model.state_dict()
    for key in before:
        same = torch.equal(before[key], after[key])
        assert same == (not key.startswith("backbone.stem.")), key
