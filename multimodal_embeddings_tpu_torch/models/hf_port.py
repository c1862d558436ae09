"""HuggingFace and ultralytics checkpoint key maps, for the port.

A copy of ``multimodal_embeddings_tpu/models/hf_port.py`` (the functions
verbatim; ``tests/test_torch_hf_port.py`` holds the two sources equal and
the answers equal on every generated key). Maps torch state-dict keys of the
published checkpoints onto the flat JAX keys of this framework's parameter
trees, which the port's modules share by path, for use with
``models/weights.py::load_torch_state_dict`` (which shape-validates every
mapped tensor, so an incompatible layout fails loudly).

Covered:

* ``make_mme5_key_map`` — ``intfloat/mmE5-mllama-11b-instruct``
  (MllamaForConditionalGeneration): the Llama text stack, the vision
  stack's patch/class embeddings, the aspect-ratio-gated tile embeddings,
  local+global layers, and the multi-modal projector;
* ``qwen25_vl_key_map`` — ``Qwen/Qwen2.5-VL-*-Instruct``;
* ``doclayout_key_map`` — ultralytics YOLOv10 / DocLayout-YOLO
  (DocStructBench), GL-CRM blocks included.

No checkpoint ships with the repository, so these maps are exercised by
synthetic state dicts under the real key names.
"""

from __future__ import annotations

import re
from typing import Optional


def make_mme5_key_map(config):
    """Factory: MllamaForConditionalGeneration keys → MmE5Embedder flat
    keys. Needs the config because cross-attention decoder layers share the
    HF norm key shape with self-attention layers but live under a
    different module name here."""

    cross_layers = set(config.text.cross_attn_layers)

    def key_map(torch_key: str) -> Optional[str]:
        return _mme5_key_map(torch_key, cross_layers)

    return key_map


def _mme5_key_map(torch_key: str, cross_layers) -> Optional[str]:
    k = torch_key
    # --- text model (language_model.model.*) -------------------------------
    m = re.match(r"language_model\.model\.embed_tokens\.weight", k)
    if m:
        return "params/text_model/tok_embed/embedding"
    m = re.match(r"language_model\.model\.norm\.weight", k)
    if m:
        return "params/text_model/final_norm/scale"
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)\.weight",
        k,
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        name = "attn_norm" if which == "input_layernorm" else "mlp_norm"
        block = f"cross{layer}" if layer in cross_layers else f"layer{layer}"
        return f"params/text_model/{block}/{name}/scale"
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight", k
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        return f"params/text_model/layer{layer}/attn/{which}/kernel"
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight", k
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        block = f"cross{layer}" if layer in cross_layers else f"layer{layer}"
        return f"params/text_model/{block}/mlp/{which}/kernel"
    # --- cross-attention layers --------------------------------------------
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.cross_attn\.(q|k|v|o)_proj\.weight", k
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        return f"params/text_model/cross{layer}/cross_attn/{which}/kernel"
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.cross_attn\.(q|k)_norm\.weight", k
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        return f"params/text_model/cross{layer}/cross_attn/{which}_norm/scale"
    m = re.match(
        r"language_model\.model\.layers\.(\d+)\.cross_attn_attn_gate", k
    )
    if m:
        return f"params/text_model/cross{int(m.group(1))}/attn_gate"
    m = re.match(r"language_model\.model\.layers\.(\d+)\.cross_attn_mlp_gate", k)
    if m:
        return f"params/text_model/cross{int(m.group(1))}/mlp_gate"
    # --- multi-modal projector ---------------------------------------------
    if k == "multi_modal_projector.weight":
        return "params/vision_model/multi_modal_projector/kernel"
    if k == "multi_modal_projector.bias":
        return "params/vision_model/multi_modal_projector/bias"
    # --- vision model -------------------------------------------------------
    if k == "vision_model.patch_embedding.weight":
        return "params/vision_model/patch_embed/kernel"
    if k == "vision_model.class_embedding":
        return "params/vision_model/class_embedding"
    m = re.match(
        r"vision_model\.(pre|post)_tile_positional_embedding\.(embedding\.weight|gate)",
        k,
    )
    if m:
        which, leaf = m.group(1), m.group(2)
        leaf = "embedding" if leaf.startswith("embedding") else "gate"
        return f"params/vision_model/{which}_tile_pos_embed/{leaf}"
    m = re.match(
        r"vision_model\.gated_positional_embedding\."
        r"(embedding|tile_embedding\.weight|gate)",
        k,
    )
    if m:
        leaf = {"embedding": "embedding", "tile_embedding.weight": "tile_embedding",
                "gate": "gate"}[m.group(1)]
        return f"params/vision_model/gated_pos_embed/{leaf}"
    if k == "vision_model.layernorm_pre.weight":
        return "params/vision_model/pre_ln/scale"
    if k == "vision_model.layernorm_pre.bias":
        return "params/vision_model/pre_ln/bias"
    if k == "vision_model.layernorm_post.weight":
        return "params/vision_model/post_ln/scale"
    if k == "vision_model.layernorm_post.bias":
        return "params/vision_model/post_ln/bias"
    m = re.match(
        r"vision_model\.(transformer|global_transformer)\.layers\.(\d+)\.(.+)", k
    )
    if m:
        tower, layer, rest = m.group(1), int(m.group(2)), m.group(3)
        prefix = (
            f"params/vision_model/local{layer}"
            if tower == "transformer"
            else f"params/vision_model/global{layer}"
        )
        sub = {
            "input_layernorm.weight": "ln1/scale",
            "input_layernorm.bias": "ln1/bias",
            "post_attention_layernorm.weight": "ln2/scale",
            "post_attention_layernorm.bias": "ln2/bias",
            "self_attn.q_proj.weight": "attn/q/kernel",
            "self_attn.k_proj.weight": "attn/k/kernel",
            "self_attn.v_proj.weight": "attn/v/kernel",
            "self_attn.o_proj.weight": "attn/o/kernel",
            "mlp.fc1.weight": "mlp/fc1/kernel",
            "mlp.fc1.bias": "mlp/fc1/bias",
            "mlp.fc2.weight": "mlp/fc2/kernel",
            "mlp.fc2.bias": "mlp/fc2/bias",
        }.get(rest)
        if sub is not None:
            return f"{prefix}/{sub}"
        if tower == "global_transformer" and rest in ("gate_attn", "gate_ffn"):
            return f"params/vision_model/global{layer}/{rest}"
        return None
    return None


def qwen25_vl_key_map(torch_key: str) -> Optional[str]:
    """Map Qwen2_5_VLForConditionalGeneration keys → QwenVLModel flat keys."""
    k = torch_key
    if k == "model.embed_tokens.weight":
        return "params/tok_embed/embedding"
    if k == "model.norm.weight":
        return "params/final_norm/scale"
    if k == "lm_head.weight":
        return "params/lm_head/kernel"
    m = re.match(
        r"model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)\.weight", k
    )
    if m:
        layer, which = int(m.group(1)), m.group(2)
        name = "attn_norm" if which == "input_layernorm" else "mlp_norm"
        return f"params/layer{layer}/{name}/scale"
    m = re.match(r"model\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.(weight|bias)", k)
    if m:
        layer, which, kind = int(m.group(1)), m.group(2), m.group(3)
        suffix = "kernel" if kind == "weight" else "bias"
        return f"params/layer{layer}/{which}/{suffix}"
    m = re.match(r"model\.layers\.(\d+)\.self_attn\.o_proj\.weight", k)
    if m:
        return f"params/layer{int(m.group(1))}/o/kernel"
    m = re.match(r"model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight", k)
    if m:
        layer, which = int(m.group(1)), m.group(2)
        return f"params/layer{layer}/mlp/{which}/kernel"
    # vision tower
    if k == "visual.patch_embed.proj.weight":
        return "params/vision/patch_embed/kernel"
    m = re.match(r"visual\.merger\.mlp\.(0|2)\.(weight|bias)", k)
    if m:
        which = "merger_fc1" if m.group(1) == "0" else "merger_fc2"
        suffix = "kernel" if m.group(2) == "weight" else "bias"
        return f"params/vision/{which}/{suffix}"
    m = re.match(r"visual\.blocks\.(\d+)\.(.+)", k)
    if m:
        layer, rest = int(m.group(1)), m.group(2)
        sub = {
            "norm1.weight": f"ln1_{layer}/scale",
            "norm1.bias": f"ln1_{layer}/bias",
            "norm2.weight": f"ln2_{layer}/scale",
            "norm2.bias": f"ln2_{layer}/bias",
            "attn.qkv.weight": f"qkv_{layer}/kernel",
            "attn.qkv.bias": f"qkv_{layer}/bias",
            "attn.proj.weight": f"proj_{layer}/kernel",
            "attn.proj.bias": f"proj_{layer}/bias",
            "mlp.fc1.weight": f"mlp_{layer}/fc1/kernel",
            "mlp.fc1.bias": f"mlp_{layer}/fc1/bias",
            "mlp.fc2.weight": f"mlp_{layer}/fc2/kernel",
            "mlp.fc2.bias": f"mlp_{layer}/fc2/bias",
        }.get(rest)
        if sub is not None:
            return f"params/vision/{sub}"
    return None


# ---------------------------------------------------------------------------
# Ultralytics YOLOv10 (DocStructBench) layout
# ---------------------------------------------------------------------------

# backbone/neck module index → our module path, for the standard v10 yaml
# ordering (upsample/concat layers 11,12,14,15,18,21 have no parameters)
_YOLO_INDEX_TO_MODULE = {
    0: "backbone/stem",
    1: "backbone/down2",
    2: "backbone/c2f_2",
    3: "backbone/down3",
    4: "backbone/c2f_3",
    5: "backbone/down4",
    6: "backbone/c2f_4",
    7: "backbone/down5",
    8: "backbone/c2fcib_5",
    9: "backbone/sppf",
    10: "backbone/psa",
    13: "neck/td_c2f_4",
    16: "neck/td_c2f_3",
    17: "neck/bu_down_3",
    19: "neck/bu_c2fcib_4",
    20: "neck/bu_down_4",
    22: "neck/bu_c2fcib_5",
    23: "head",
}


def _conv_bn(sub: str, rest: str):
    """ultralytics Conv(.conv/.bn) → our ConvBnAct(conv/bn) leaves."""
    leaf = {
        "conv.weight": ("params", "conv/kernel"),
        "bn.weight": ("params", "bn/scale"),
        "bn.bias": ("params", "bn/bias"),
        "bn.running_mean": ("batch_stats", "bn/mean"),
        "bn.running_var": ("batch_stats", "bn/var"),
    }.get(rest)
    if leaf is None:
        return None
    collection, tail = leaf
    return f"{collection}/{sub}/{tail}"


def doclayout_key_map(torch_key: str):
    """Map ultralytics ``model.N.<...>`` keys of a YOLOv10-family /
    DocLayout-YOLO checkpoint onto our DocLayoutYOLO tree.

    Covers base v10 modules plus DocLayout-YOLO's GL-CRM backbone blocks
    (``layers.G2L_CRM``: same cv1/cv2/m.N scaffold; inner blocks carry
    cv1 (dilated) / cv2 (local) / gate (1x1 conv with bias)). Structurally
    validated by a full synthetic inverse-state-dict round trip in
    ``tests/test_hf_port.py`` — no DocStructBench checkpoint ships in this
    environment, so the upstream leaf naming for the CRM gate is
    provisional; a real port reports any unmapped keys loudly.
    ``num_batches_tracked`` and EMA bookkeeping are skipped.
    """
    k = torch_key
    if k.startswith("model.model."):
        k = k[len("model."):]
    m = re.match(r"model\.(\d+)\.(.+)", k)
    if m is None:
        return None
    idx, rest = int(m.group(1)), m.group(2)
    module = _YOLO_INDEX_TO_MODULE.get(idx)
    if module is None or rest.endswith("num_batches_tracked"):
        return None

    if module == "head":
        return _head_key(rest)

    prefix = f"{module}"

    # bare Conv modules (stem, down2/3): keys are conv.*/bn.* directly
    if rest.startswith(("conv.", "bn.")):
        return _with_collection(_conv_bn(prefix, rest))

    # plain Conv / SCDown / SPPF / C2f submodule routing
    m2 = re.match(r"(cv1|cv2)\.(.+)", rest)
    if m2:
        return _with_collection(_conv_bn(f"{prefix}/{m2.group(1)}", m2.group(2)))
    # C2f inner blocks: m.N.(...)
    m2 = re.match(r"m\.(\d+)\.(.+)", rest)
    if m2:
        inner, tail = int(m2.group(1)), m2.group(2)
        # Bottleneck: cv1/cv2; CIB: cv1.<0..4> sequential
        m3 = re.match(r"cv1\.(\d)\.(.+)", tail)
        if m3:
            seq, leaf = int(m3.group(1)), m3.group(2)
            cib_name = {0: "dw1", 1: "pw1", 2: "dw2", 3: "pw2", 4: "dw3"}[seq]
            return _with_collection(
                _conv_bn(f"{prefix}/m{inner}/{cib_name}", leaf)
            )
        m3 = re.match(r"(cv1|cv2)\.(.+)", tail)
        if m3:
            return _with_collection(
                _conv_bn(f"{prefix}/m{inner}/{m3.group(1)}", m3.group(2))
            )
        # GL-CRM controllable gate: bare 1x1 Conv2d (with bias, no BN)
        m3 = re.match(r"gate\.(weight|bias)", tail)
        if m3:
            leaf = "kernel" if m3.group(1) == "weight" else "bias"
            return f"params/{prefix}/m{inner}/gate/{leaf}"
        return None
    # PSA: attn.qkv/attn.proj/attn.pe, ffn.0/ffn.1
    m2 = re.match(r"attn\.(qkv|proj|pe)\.(.+)", rest)
    if m2:
        return _with_collection(
            _conv_bn(f"{prefix}/attn/{m2.group(1)}", m2.group(2))
        )
    m2 = re.match(r"ffn\.(\d)\.(.+)", rest)
    if m2:
        name = "ffn1" if m2.group(1) == "0" else "ffn2"
        return _with_collection(_conv_bn(f"{prefix}/{name}", m2.group(2)))
    return None


def _with_collection(mapped):
    if mapped is None:
        return None
    collection, tail = mapped.split("/", 1)
    return f"{collection}/{tail}"


def _head_key(rest: str):
    """v10Detect: one2one_cv2/one2one_cv3 (the NMS-free inference branch we
    instantiate) per level; the one-to-many training branch is skipped."""
    m = re.match(r"one2one_cv([23])\.(\d)\.(.+)", rest)
    if m is None:
        return None
    branch, level, tail = m.group(1), int(m.group(2)), m.group(3)
    if branch == "2":  # regression: Conv, Conv, Conv2d
        m2 = re.match(r"(\d)\.(.+)", tail)
        if m2 is None:
            return None
        seq, leaf = int(m2.group(1)), m2.group(2)
        if seq in (0, 1):
            return _with_collection(
                _conv_bn(f"head/reg{level}_cv{seq + 1}", leaf)
            )
        if seq == 2 and leaf == "weight":
            return f"params/head/reg{level}_out/kernel"
        if seq == 2 and leaf == "bias":
            return f"params/head/reg{level}_out/bias"
        return None
    # classification: Sequential(Sequential(DW,PW), Sequential(DW,PW), Conv2d)
    m2 = re.match(r"(\d)\.(\d)\.(.+)", tail)
    if m2:
        outer, inner, leaf = int(m2.group(1)), int(m2.group(2)), m2.group(3)
        name = {(0, 0): "dw1", (0, 1): "pw1", (1, 0): "dw2", (1, 1): "pw2"}.get(
            (outer, inner)
        )
        if name is None:
            return None
        return _with_collection(_conv_bn(f"head/cls{level}_{name}", leaf))
    m2 = re.match(r"2\.(.+)", tail)
    if m2:
        leaf = m2.group(1)
        if leaf == "weight":
            return f"params/head/cls{level}_out/kernel"
        if leaf == "bias":
            return f"params/head/cls{level}_out/bias"
    return None
