"""Golden-activation traces for first-contact checkpoint validation, in
the port.

Port of ``multimodal_embeddings_tpu/analysis/activations.py``: the same
deterministic probes (numpy ``default_rng``), the same per-layer statistics
and the same JSON, so a dump of the port on the card and a dump of the JAX
package on its own device compare with ``compare_traces`` (the statistics,
probes and comparison are verbatim copies; ``tests/test_torch_activations.py``
holds the sources and the traces equal). The first run against a real
checkpoint is one command on each side —

* the port:  ``python -m multimodal_embeddings_tpu_torch.cli.parity
  acts-dump --family mme5 --checkpoint <ported.npz> --out ours.json``
* HF reference side: ``python scripts/hf_activation_dump.py --model
  intfloat/mmE5-mllama-11b-instruct --out theirs.json`` (forward hooks,
  same probe recipe, same JSON schema)
* verdict: ``... parity acts-compare theirs.json ours.json`` reports the
  first diverging layer in dump order instead of a bare end-to-end cosine.

``trace_module`` takes the place of JAX's ``trace_flax_module``: forward
hooks on every submodule give JAX's trace key for key. A layer is named by
its ``named_modules()`` path with ``/`` for ``.``, which is the flax scope
path (the weight bridge already holds the port's paths to JAX's scopes);
``#i`` marks the i-th call of a module called more than once, ``@j`` the
j-th tensor leaf of an output (``jax.tree.leaves`` order: dict leaves by
sorted key); the root module is left out and its first output leaf is
``"output"``. One name differs from the module path: the conv of a
``ConvBnAct`` holds its BatchNorm folded in, so its output is JAX's
BatchNorm output and is recorded as ``<unit>/bn``; JAX's raw ``<unit>/conv``
output has no counterpart in the port. Layers are dumped in ``sorted()`` order of their paths, as
JAX dumps them (alphabetical, not execution order), so ``compare_traces``
names the same ``first_divergent`` on both. A conv's feature map, NCHW in
the port, is recorded NHWC as JAX has it. The statistics are reduced on the
tensor's own device in float64 (a dense layer's output split into the
JAX kernel's output axes first), and only the five moments and the first
``_HEAD_N`` values reach the host, once, at the end of the forward: the
hooks copy no activation off the card and launch no kernel of the port.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from multimodal_embeddings_tpu_torch.models.layers import ConvBnAct

__all__ = [
    "tensor_stats",
    "trace_module",
    "device_tensor_stats",
    "detector_probe",
    "mme5_probe",
    "qwen_probe",
    "detector_trace",
    "mme5_trace",
    "qwen_trace",
    "compare_traces",
]

_HEAD_N = 8


def tensor_stats(x) -> Dict[str, Any]:
    """Summary statistics for one activation tensor.

    Cross-framework comparison cannot be bit-exact (different op
    ordering, bf16 vs fp16 accumulation), so the dump records shape plus
    moments and the first ``_HEAD_N`` flattened values; ``compare_traces``
    applies a relative tolerance.
    """
    arr = np.asarray(x, dtype=np.float64)
    flat = arr.reshape(-1)
    return {
        "shape": list(arr.shape),
        "mean": float(flat.mean()) if flat.size else 0.0,
        "std": float(flat.std()) if flat.size else 0.0,
        "min": float(flat.min()) if flat.size else 0.0,
        "max": float(flat.max()) if flat.size else 0.0,
        "absmean": float(np.abs(flat).mean()) if flat.size else 0.0,
        "head": [float(v) for v in flat[:_HEAD_N]],
    }


def _leaves(value) -> List[torch.Tensor]:
    """The tensor leaves of a module output in ``jax.tree.leaves`` order:
    tuples and lists in order, dicts by sorted key; anything else (None,
    Python scalars) holds none."""
    if torch.is_tensor(value):
        return [value]
    if isinstance(value, dict):
        return [leaf for key in sorted(value) for leaf in _leaves(value[key])]
    if isinstance(value, (list, tuple)):
        return [leaf for item in value for leaf in _leaves(item)]
    return []


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _dense_out_dims(kernel_shape, out_features: int) -> tuple:
    """The output axes of a flax ``DenseGeneral`` whose kernel is
    ``kernel_shape``: its longest trailing axes that hold ``out_features``."""
    for k in range(len(kernel_shape)):
        if math.prod(kernel_shape[k:]) == out_features:
            return tuple(kernel_shape[k:])
    raise ValueError(f"kernel {kernel_shape} does not give {out_features} outputs")


def _jax_layout(sub: nn.Module, nhwc: bool):
    """How a submodule's output leaves are laid out as JAX has them: conv
    maps NCHW → NHWC; a dense layer's flattened output axes split into the
    JAX kernel's (``(B, L, H·D)`` → ``(B, L, H, D)``)."""
    kernel_shape = getattr(sub, "kernel_shape", None)
    if kernel_shape is not None:
        return lambda x: x.reshape(*x.shape[:-1], *_dense_out_dims(kernel_shape, x.shape[-1]))
    if nhwc or isinstance(sub, nn.Conv2d):
        return _nhwc
    return None


def _device_stats(x: torch.Tensor) -> torch.Tensor:
    """mean, std, min, max, absmean and the first ``_HEAD_N`` flattened
    values of ``x``, as one float64 vector on ``x``'s device."""
    flat = x.detach().to(torch.float64).reshape(-1)
    if flat.numel() == 0:
        return torch.zeros(5, dtype=torch.float64, device=x.device)
    moments = torch.stack([flat.mean(), flat.std(correction=0), flat.min(), flat.max(),
                           flat.abs().mean()])
    return torch.cat([moments, flat[:_HEAD_N]])


def _stats_record(shape, values: np.ndarray) -> Dict[str, Any]:
    """``tensor_stats``' record from ``_device_stats``' values."""
    return {
        "shape": list(shape),
        "mean": float(values[0]),
        "std": float(values[1]),
        "min": float(values[2]),
        "max": float(values[3]),
        "absmean": float(values[4]),
        "head": [float(v) for v in values[5:]],
    }


def device_tensor_stats(x: torch.Tensor) -> Dict[str, Any]:
    """``tensor_stats``' record of ``x``, reduced on its own device as
    ``trace_module`` reduces every layer (so a traced output and the same
    tensor from an untraced forward give equal records exactly when their
    statistics agree bit for bit)."""
    return _stats_record(x.shape, _device_stats(x).cpu().numpy())


def trace_module(
    module: nn.Module,
    args,
    kwargs: Optional[dict] = None,
    taps: Optional[str] = None,
    nhwc: bool = False,
) -> Dict[str, Any]:
    """Run ``module(*args, **kwargs)`` recording every submodule output ->
    stats dict (JAX's ``trace_flax_module`` record, key for key).

    ``taps`` optionally restricts the dump to paths matching the regex
    (applied to the slash-joined module path). Outputs are recorded in
    JAX's layout: every ``nn.Conv2d`` output NHWC, and with ``nhwc`` every
    4-D output of a submodule (the detector, which runs NCHW inside an NHWC
    forward); a dense layer's output with the JAX kernel's output axes. The conv of a
    ``ConvBnAct`` is recorded as the unit's ``bn``.
    """
    pattern = re.compile(taps) if taps else None
    calls: Dict[str, List[List[tuple]]] = {}
    handles = []

    def hook_for(path: str, layout):
        def hook(_module, _inputs, output):
            leaves = _leaves(output)
            if layout is not None:
                leaves = [layout(x) for x in leaves]
            calls.setdefault(path, []).append(
                [(tuple(x.shape), _device_stats(x)) for x in leaves])

        return hook

    folded = {f"{name}.conv" for name, sub in module.named_modules()
              if isinstance(sub, ConvBnAct)}
    for name, sub in module.named_modules():
        path = name.replace(".", "/")
        if name in folded:  # conv + folded BatchNorm = JAX's bn output
            path = path[: -len("conv")] + "bn"
        if not path or (pattern and not pattern.search(path)):
            continue
        handles.append(sub.register_forward_hook(hook_for(path, _jax_layout(sub, nhwc))))
    with torch.inference_mode():
        out = module(*args, **(kwargs or {}))
    for handle in handles:
        handle.remove()

    entries = []  # (name, shape, statistics on the device) in dump order
    for path in sorted(calls):
        values = calls[path]
        for idx, leaves in enumerate(values):
            key = path if len(values) == 1 else f"{path}#{idx}"
            for leaf_i, (shape, stats) in enumerate(leaves):
                entries.append((key if leaf_i == 0 else f"{key}@{leaf_i}", shape, stats))
    out_leaves = _leaves(out)
    if out_leaves:
        entries.append(("", tuple(out_leaves[0].shape), _device_stats(out_leaves[0])))
    if not entries:
        return {"layers": {}}
    # one copy to the host for the whole dump
    sizes = [stats.numel() for _, _, stats in entries]
    host = np.split(torch.cat([stats for _, _, stats in entries]).cpu().numpy(),
                    np.cumsum(sizes)[:-1])
    records = [(name, _stats_record(shape, values))
               for (name, shape, _), values in zip(entries, host)]
    result: Dict[str, Any] = {"layers": {name: rec for name, rec in records if name}}
    if out_leaves:
        result["output"] = records[-1][1]
    return result


# -- probes ------------------------------------------------------------------


def detector_probe(image_size: int, seed: int = 0) -> np.ndarray:
    """(1, S, S, 3) float32 in [0, 1) — feed the model forward directly
    (the detector's serving path divides uint8 pages by 255 first; the
    probe is already normalized, matching the torch side's input)."""
    rng = np.random.default_rng(seed)
    return rng.random((1, image_size, image_size, 3), dtype=np.float32)


def mme5_probe(
    image_size: int,
    text_len: int,
    vocab: int,
    tiles: int = 1,
    seed: int = 0,
):
    """(token_ids, attention_mask, images, aspect_ratio_ids, tile_mask).

    Token ids are drawn below ``min(vocab, 32000)`` so the same probe is
    valid for reduced test vocabularies and the real 128k one.
    """
    rng = np.random.default_rng(seed)
    tokens = rng.integers(
        1, min(vocab, 32000), size=(1, text_len), dtype=np.int32
    )
    mask = np.ones((1, text_len), np.int32)
    images = rng.random(
        (1, tiles, image_size, image_size, 3), dtype=np.float32
    )
    aspect = np.ones((1,), np.int32)
    tile_mask = np.ones((1, tiles), np.int32)
    return tokens, mask, images, aspect, tile_mask


def qwen_probe(
    image_size: int,
    text_len: int,
    vocab: int,
    image_pad_id: int,
    merged_unit: int = 28,
    seed: int = 0,
):
    """(token_ids, images) for a QwenVL prefill forward.

    Token ids are drawn below ``min(vocab, 32000)`` (excluding the pad id)
    with one contiguous image-pad span spliced at position 4 — the shape
    ``embed_multimodal`` + ``get_rope_index`` handle (qwen_vl.py). Images
    are CLIP-normalized from a [0,1) draw, matching the parse path
    (``doc_parser.preprocess_page``) and the torch-side dump
    (``scripts/hf_activation_dump.py --loader qwen``)."""
    rng = np.random.default_rng(seed)
    n_img = (image_size // merged_unit) ** 2
    assert text_len >= n_img + 8, (text_len, n_img)
    tokens = rng.integers(
        1, min(vocab, 32000), size=(1, text_len), dtype=np.int32
    )
    tokens[tokens == image_pad_id] += 1
    tokens[0, 4 : 4 + n_img] = image_pad_id
    raw = rng.random((1, image_size, image_size, 3), dtype=np.float32)
    from multimodal_embeddings_tpu_torch.analysis.doc_parser import (
        IMAGE_MEAN,
        IMAGE_STD,
    )

    images = (raw - np.asarray(IMAGE_MEAN, np.float32)) / np.asarray(
        IMAGE_STD, np.float32
    )
    return tokens, images


def _model_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def detector_trace(detector, seed: int = 0, taps: Optional[str] = None):
    """Golden-activation dump for a ``LayoutDetector``."""
    probe = detector_probe(detector.config.image_size, seed=seed)
    trace = trace_module(
        detector.model,
        (torch.from_numpy(probe).to(detector.device),),
        taps=taps,
        nhwc=True,
    )
    trace["probe"] = {
        "recipe": f"default_rng({seed}).random((1,{detector.config.image_size},"
        f"{detector.config.image_size},3), float32)",
        "family": "detector",
        "variant": detector.config.variant,
    }
    return trace


def mme5_trace(embedder, seed: int = 0, taps: Optional[str] = None):
    """Golden-activation dump for a mmE5 ``MultimodalEmbedder``."""
    cfg = embedder.model_config
    args = mme5_probe(
        cfg.vision.image_size,
        embedder.text_len,
        cfg.text.vocab_size,
        seed=seed,
    )
    device = _model_device(embedder.model)
    tokens, mask, images, aspect, tile_mask = (torch.from_numpy(a).to(device) for a in args)
    trace = trace_module(
        embedder.model, (tokens.long(), mask, images, aspect.long(), tile_mask), taps=taps
    )
    trace["probe"] = {
        "recipe": f"default_rng({seed}): integers(1, min(vocab,32000), "
        f"(1,{embedder.text_len})) tokens; random((1,1,"
        f"{cfg.vision.image_size},{cfg.vision.image_size},3)) tiles",
        "family": "mme5",
    }
    return trace


def qwen_trace(
    model,
    image_size: int = 56,
    text_len: Optional[int] = None,
    seed: int = 0,
    taps: Optional[str] = None,
):
    """Golden-activation dump for a ``QwenVLModel`` prefill forward (the
    parse surface — first-contact validation of the qwen25_vl port map,
    ``models/hf_port.py::qwen25_vl_key_map``). JAX's takes the parameter
    tree as a second argument; the port's model holds its parameters."""
    cfg = model.config
    unit = cfg.vision.patch_size * cfg.vision.merge_size
    image_size = max(unit, (image_size // unit) * unit)
    n_img = (image_size // unit) ** 2
    if text_len is None:
        text_len = min(cfg.text.max_len, n_img + 16)
    tokens, images = qwen_probe(
        image_size,
        text_len,
        cfg.text.vocab_size,
        cfg.image_pad_id,
        merged_unit=unit,
        seed=seed,
    )
    device = _model_device(model)
    trace = trace_module(
        model,
        (torch.from_numpy(tokens).long().to(device), torch.from_numpy(images).to(device)),
        taps=taps,
    )
    trace["probe"] = {
        "recipe": f"default_rng({seed}): integers(1, min(vocab,32000), "
        f"(1,{text_len})) tokens with {n_img} image pads at 4; "
        f"random((1,{image_size},{image_size},3)) CLIP-normalized",
        "family": "qwen",
    }
    return trace


# -- comparison ---------------------------------------------------------------


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    return abs(a - b) <= atol + rtol * max(abs(a), abs(b))


def compare_traces(
    reference: Dict[str, Any],
    candidate: Dict[str, Any],
    rtol: float = 1e-2,
    atol: float = 1e-4,
    name_map: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """Layer-by-layer comparison of two activation dumps.

    ``name_map`` maps reference layer names to candidate layer names
    (needed when the reference dump comes from the torch side, whose
    module paths differ); unmapped reference layers that have no
    same-name candidate are reported as ``unmatched`` rather than failed.
    Returns per-layer verdicts plus ``first_divergent`` — the earliest
    (dump-order) matched layer whose statistics disagree, which for a
    topologically-ordered dump pinpoints the module that introduced the
    divergence.
    """
    ref_layers = reference.get("layers", {})
    cand_layers = candidate.get("layers", {})
    results: List[Dict[str, Any]] = []
    unmatched: List[str] = []
    first_divergent = None
    for name, ref_stats in ref_layers.items():
        cand_name = (name_map or {}).get(name, name)
        cand_stats = cand_layers.get(cand_name)
        if cand_stats is None:
            unmatched.append(name)
            continue
        fields = ("mean", "std", "min", "max", "absmean")
        bad = [
            f
            for f in fields
            if not _close(ref_stats[f], cand_stats[f], rtol, atol)
        ]
        head_ok = all(
            _close(a, b, rtol, atol)
            for a, b in zip(ref_stats.get("head", []), cand_stats.get("head", []))
        )
        shape_ok = list(ref_stats["shape"]) == list(cand_stats["shape"])
        ok = shape_ok and not bad and head_ok
        entry = {
            "layer": name,
            "candidate_layer": cand_name,
            "ok": ok,
            "shape_ok": shape_ok,
            "bad_fields": bad,
            "head_ok": head_ok,
        }
        results.append(entry)
        if not ok and first_divergent is None:
            first_divergent = name
    matched = [r for r in results if r["ok"]]
    summary = {
        "layers_compared": len(results),
        "layers_ok": len(matched),
        "unmatched_reference_layers": unmatched,
        "first_divergent": first_divergent,
        "ok": first_divergent is None and bool(results),
        "results": results,
    }
    out_ref, out_cand = reference.get("output"), candidate.get("output")
    if out_ref and out_cand:
        summary["output_ok"] = (
            list(out_ref["shape"]) == list(out_cand["shape"])
            and all(
                _close(out_ref[f], out_cand[f], rtol, atol)
                for f in ("mean", "std", "min", "max", "absmean")
            )
        )
    return summary


def save_trace(trace: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f, indent=2)
        f.write("\n")


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
