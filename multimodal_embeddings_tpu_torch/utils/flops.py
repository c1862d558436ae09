"""Analytic FLOP counting for the serving models, in the port.

Port of ``multimodal_embeddings_tpu/utils/flops.py``. The config-driven
counters (``encoder_block_flops``, ``mllama_vision_flops``,
``mllama_text_flops``, ``mllama_embed_flops``) are verbatim copies
(``tests/test_torch_flops.py`` holds the sources and the counts equal): they
derive the matmul/attention FLOPs from the model configs directly,
independent of which kernel executes them.
``headline_flops_per_page`` counts the port's detector and ViT forwards
with ``torch.utils.flop_counter.FlopCounterMode`` over the plain routes on
the CPU (JAX walks the traced jaxpr with its Pallas dispatch forced off;
those jaxpr walkers have no port).

Convention: 1 multiply-add = 2 FLOPs; elementwise/normalization work is
omitted (sub-1% at these shapes). Counts are per FORWARD (inference).
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING

import torch
from torch.utils.flop_counter import FlopCounterMode

if TYPE_CHECKING:  # pragma: no cover
    from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig


def _pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def encoder_block_flops(seq: int, width: int, mlp_ratio: float = 4.0) -> float:
    """One ViT encoder block (qkv + scores + weighted-V + proj + 2 MLP
    matmuls) at sequence length ``seq`` and model width ``width``."""
    qkv = 2 * seq * width * (3 * width)
    attn = 2 * 2 * seq * seq * width  # QK^T and P·V
    proj = 2 * seq * width * width
    mlp = 2 * 2 * seq * width * int(mlp_ratio * width)
    return float(qkv + attn + proj + mlp)


def mllama_vision_flops(cfg: "MllamaConfig", tiles: int = 1) -> float:
    """Mllama vision tower + projector, one image of ``tiles`` tiles.

    Mirrors ``models/mme5.py::MllamaVisionEncoder``: patch conv, local +
    global transformer over the flattened padded tile sequence, and the
    multi-modal projector over the channel-concatenated features.
    """
    v = cfg.vision
    patches = (v.image_size // v.patch_size) ** 2
    seq = patches + 1  # class token
    padded = _pad_to_multiple(seq, 8)
    length = tiles * padded
    patch_conv = 2 * tiles * patches * (v.patch_size**2 * 3) * v.width
    blocks = (v.layers + v.global_layers) * encoder_block_flops(
        length, v.width, v.mlp_ratio
    )
    feat_dim = v.width * (1 + len(v.intermediate_layers))
    projector = 2 * tiles * seq * feat_dim * cfg.text.hidden
    return float(patch_conv + blocks + projector)


def mllama_text_flops(
    cfg: "MllamaConfig", text_len: int, vision_len: int
) -> float:
    """Mllama text stack for one sequence of ``text_len`` tokens with
    cross-attention over ``vision_len`` vision tokens (no LM head — the
    embedder pools hidden states, ``embedder.py:17-34``)."""
    t = cfg.text
    q_dim = t.heads * t.head_dim
    kv_dim = t.kv_heads * t.head_dim
    m = text_len
    self_layers = t.layers - len(t.cross_attn_layers)
    per_self = (
        2 * m * t.hidden * (q_dim + 2 * kv_dim)  # qkv
        + 2 * 2 * m * m * q_dim  # scores + weighted V (GQA repeats K/V)
        + 2 * m * q_dim * t.hidden  # out proj
        + 3 * 2 * m * t.hidden * t.mlp_hidden  # SwiGLU gate/up/down
    )
    per_cross = (
        2 * m * t.hidden * q_dim  # q
        + 2 * vision_len * t.hidden * 2 * kv_dim  # k, v over vision tokens
        + 2 * 2 * m * vision_len * q_dim  # scores + weighted V
        + 2 * m * q_dim * t.hidden
        + 3 * 2 * m * t.hidden * t.mlp_hidden
    )
    return float(
        self_layers * per_self + len(cfg.text.cross_attn_layers) * per_cross
    )


def _cpu_forward_flops(module: torch.nn.Module, method: str, shape) -> float:
    """Matmul/conv FLOPs of ``module.<method>(zeros(shape))``, run on an f32
    copy of ``module`` on the CPU, where every kernel wrapper takes its
    plain PyTorch version."""
    cpu = copy.deepcopy(module).to("cpu", torch.float32).eval()
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        getattr(cpu, method)(torch.zeros(shape, dtype=torch.float32))
    return float(counter.get_total_flops())


def headline_flops_per_page(
    detector, embedder, n_views: int, n_regions: int
) -> dict:
    """Analytic per-page matmul/conv FLOPs of the HEADLINE pipeline
    (detect ``n_views`` letterboxed views + embed ``n_regions`` crops),
    counted from the model forwards over the plain routes on the CPU: one
    view and one crop, times ``n_views`` and ``n_regions`` (both forwards
    are linear in the batch)."""
    size = detector.config.image_size
    detect = n_views * _cpu_forward_flops(detector.model, "forward", (1, size, size, 3))
    vcfg = embedder.model_config.vision
    embed = n_regions * _cpu_forward_flops(
        embedder.model, "encode_image", (1, vcfg.image_size, vcfg.image_size, 3)
    )
    return {
        "detect_flops_per_page": detect,
        "embed_flops_per_page": embed,
        "total_flops_per_page": detect + embed,
    }


def mllama_embed_flops(
    cfg: "MllamaConfig", text_len: int, tiles: int = 1
) -> dict:
    """Per-CROP analytic FLOPs of the mmE5 embedding forward, split by
    stack (the decoupled serving path runs them as separate programs)."""
    v = cfg.vision
    seq = (v.image_size // v.patch_size) ** 2 + 1
    vision = mllama_vision_flops(cfg, tiles)
    text = mllama_text_flops(cfg, text_len, tiles * seq)
    return {
        "vision_flops_per_crop": vision,
        "text_flops_per_crop": text,
        "total_flops_per_crop": vision + text,
    }
