"""Parameters of the port: seeded random init, and the bridge from the JAX
package's parameters.

The bridge reads the flat ``"/"``-joined numpy dict of the JAX package's
``models/weights.py::flatten_params`` — also the key set of its ``.npz``
checkpoints — and fills a port module whose submodule path matches the JAX
scope path:

* conv kernels HWIO → OIHW;
* ``ConvBnAct``: conv kernel and BatchNorm (``scale``/``bias`` params,
  ``mean``/``var`` batch stats) folded into one weight and bias, eps 1e-3
  (the formula of ``layers.py::_FoldedConvBn``);
* ``DenseGeneral`` ``(C, H, D)`` → ``(C, H·D)``; out projection
  ``(H, D, C)`` → ``(H·D, C)`` (each port ``Dense`` keeps the JAX
  kernel's shape);
* ``Dense``, LayerNorm, RMSNorm, ``pos_embed``, gates, tile tables,
  ``Embed/embedding``, biases (in the JAX bias's shape: ``(3, H, D)`` for the
  Qwen vision tower's fused qkv, ``(H, D)`` for a decoder q/k/v), the int8
  ``kernel_q``/``kernel_scale`` and the packed int4 uint8
  ``kernel_q4``/``kernel_scale`` leaves of a quantized tree as they are (a
  parameter the bridge has no rule for is read under its own path);
* a float ``kernel`` where the port module holds an ``Int8Dense`` or
  ``Int4Dense``: quantized on the module's device at load
  (``models/quantized.py::quantize_dense_tree``), as the JAX engine
  converts a float checkpoint for a quantized model.

Every port parameter must be filled and every JAX key under the prefix
used, with matching shapes, or the load raises. ``export_jax_params`` is the
inverse, with BatchNorm exported as an identity around the folded conv.

``build_mme5`` and ``build_qwen`` make the mmE5 and Qwen2.5-VL models
straight on their device: parameters are materialized there in their
storage types (``models/quantized.py``) and filled from a JAX tree or with
seeded synthetic values, so the 11B and 32B trees never pass through the
host.

Checkpoints: ``load_checkpoint`` reads the JAX package's ``.npz`` and
``.safetensors`` files (keys the ``"/"``-joined flax paths; the
``.safetensors`` reader is this module's own, so no ``safetensors`` package
is needed); ``save_checkpoint`` and ``save_checkpoint_safetensors`` write
them from a port module. A file's tensors that the model lacks are logged
and dropped before the bridge; a tensor the model needs and the file lacks
raises. ``load_torch_state_dict`` ports a published torch state dict
through a key map (``models/hf_port.py``), with the layout rules of
``adapt_torch_tensor`` (copies of the JAX package's).
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.layers import BN_EPS, ConvBnAct
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig, MmE5Embedder
from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig, QwenVLModel
from multimodal_embeddings_tpu_torch.models.quantized import (
    Int4Dense,
    Int8Dense,
    materialize,
    quantize_dense_tree,
    synthetic_int8_init,
)
from multimodal_embeddings_tpu_torch.models.transformer import Dense, FastLayerNorm

Flat = Dict[str, np.ndarray]

logger = get_logger("weights")


def load_npz(path: str) -> Flat:
    """A JAX-package ``.npz`` checkpoint as a flat numpy dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# safetensors dtype codes and their little-endian numpy types: every type
# ``safetensors.numpy.save_file`` writes for a JAX parameter tree. BF16 is
# read as its 16 bits and widened to f32 exactly (numpy has no bfloat16).
_ST_TYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}
_ST_CODES = {np.dtype(t): c for c, t in _ST_TYPES.items() if c != "BF16"}


def load_safetensors(path: str) -> Flat:
    """A ``.safetensors`` file as a flat numpy dict: an 8-byte little-endian
    header length, a JSON header (name → dtype, shape, data offsets), then
    the tensors' raw bytes. Raises on a dtype outside ``_ST_TYPES``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    flat: Flat = {}
    for key, entry in header.items():
        if key == "__metadata__":
            continue
        code = entry["dtype"]
        if code not in _ST_TYPES:
            raise ValueError(f"{path}: tensor {key} has dtype {code}, which the reader "
                             f"does not take ({sorted(_ST_TYPES)})")
        begin, end = entry["data_offsets"]
        arr = np.array(data[begin:end].view(np.dtype(_ST_TYPES[code])))
        if code == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        flat[key] = arr.astype(arr.dtype.newbyteorder("=")).reshape(entry["shape"])
    return flat


def save_safetensors(flat: Flat, path: str) -> None:
    """Write a flat numpy dict as ``.safetensors`` (keys in sorted order, the
    header padded with spaces to 8 bytes, as the format asks)."""
    header, offset, arrays = {}, 0, []
    for key in sorted(flat):
        arr = np.asarray(flat[key])
        if arr.dtype not in _ST_CODES:
            raise ValueError(f"tensor {key}: dtype {arr.dtype} has no safetensors code")
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[key] = {"dtype": _ST_CODES[arr.dtype], "shape": list(arr.shape),
                       "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        arrays.append(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in arrays:
            f.write(raw)


def load_checkpoint(path: str) -> Flat:
    """A JAX-package checkpoint, ``.safetensors`` or ``.npz``, as a flat
    numpy dict (JAX's ``save_checkpoint`` and ``save_checkpoint_safetensors``
    key sets)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_npz(path)


def _hwio_to_oihw(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def fold_conv_bn(kernel, scale, bias, mean, var, eps: float = BN_EPS):
    """HWIO conv kernel + BatchNorm → (OIHW weight, bias), f32."""
    g = scale.astype(np.float32) / np.sqrt(var.astype(np.float32) + np.float32(eps))
    w = kernel.astype(np.float32) * g  # broadcast over the out axis (last)
    b = bias.astype(np.float32) - mean.astype(np.float32) * g
    return _hwio_to_oihw(w), b


class _Reader:
    """Hands out JAX tensors by path and records which were taken."""

    def __init__(self, flat: Flat, prefix: str):
        self.flat = flat
        self.prefix = prefix
        self.used = set()

    def __call__(self, collection: str, path: str) -> np.ndarray:
        key = "/".join(filter(None, [collection, self.prefix, path]))
        if key not in self.flat:
            raise KeyError(f"JAX parameters lack {key}")
        self.used.add(key)
        return np.asarray(self.flat[key])

    def unused(self):
        heads = [f"{c}/{self.prefix}" if self.prefix else c for c in ("params", "batch_stats")]
        return sorted(
            k for k in self.flat
            if k not in self.used and any(k.startswith(h + "/") for h in heads)
        )


def _join(*parts: str) -> str:
    return "/".join(p for p in parts if p)


def _set(param: torch.Tensor, value: np.ndarray, name: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch at {name}: port {tuple(param.shape)} vs "
            f"converted JAX {tuple(value.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.tensor(value))


def _load_conv_bn(m: ConvBnAct, path: str, read: _Reader) -> None:
    w, b = fold_conv_bn(
        read("params", _join(path, "conv/kernel")),
        read("params", _join(path, "bn/scale")),
        read("params", _join(path, "bn/bias")),
        read("batch_stats", _join(path, "bn/mean")),
        read("batch_stats", _join(path, "bn/var")),
    )
    _set(m.conv.weight, w, path)
    _set(m.conv.bias, b, path)


def _load_conv(m: nn.Conv2d, path: str, read: _Reader) -> None:
    _set(m.weight, _hwio_to_oihw(read("params", _join(path, "kernel"))), path)
    if m.bias is not None:
        _set(m.bias, read("params", _join(path, "bias")), path)


def _load_dense(m: Dense, path: str, read: _Reader) -> None:
    k = read("params", _join(path, "kernel"))
    if tuple(k.shape) != m.kernel_shape:
        raise ValueError(
            f"shape mismatch at {path}: port {m.kernel_shape} vs JAX {tuple(k.shape)}"
        )
    _set(m.weight, k.reshape(m.weight.shape), path)
    if m.bias is not None:
        _set(m.bias, read("params", _join(path, "bias")), path)


def _load_ln(m: FastLayerNorm, path: str, read: _Reader) -> None:
    _set(m.scale, read("params", _join(path, "scale")), path)
    _set(m.bias, read("params", _join(path, "bias")), path)


_LOADERS: Dict[type, Callable] = {
    ConvBnAct: _load_conv_bn,
    nn.Conv2d: _load_conv,
    Dense: _load_dense,
    FastLayerNorm: _load_ln,
}


def _walk(module: nn.Module, path: str, visit) -> None:
    """Call ``visit(module, path)`` on every module the bridge converts as a
    unit, and on other modules' own parameters (``pos_embed``)."""
    if type(module) in _LOADERS:
        visit(module, path)
        return
    for name, p in module.named_parameters(recurse=False):
        visit(p, _join(path, name))
    for name, child in module.named_children():
        _walk(child, _join(path, name), visit)


def load_jax_params(module: nn.Module, flat: Flat, prefix: str = "") -> nn.Module:
    """Fill ``module`` from JAX ``flatten_params`` output whose scope for
    this module is ``prefix`` (``""`` for the detector and the engines'
    models). Float kernels at quantized sites are quantized first, on the
    module's device. Returns ``module``."""
    read = _Reader(quantize_dense_tree(flat, module, prefix), prefix)

    def visit(obj, path):
        if isinstance(obj, nn.Parameter):
            _set(obj, read("params", path), path)
        else:
            _LOADERS[type(obj)](obj, path, read)

    _walk(module, "", visit)
    unused = read.unused()
    if unused:
        raise ValueError(f"{len(unused)} JAX parameters unused, e.g. {unused[:5]}")
    return module


def export_jax_params(module: nn.Module, prefix: str = "") -> Flat:
    """The port's parameters as a JAX ``flatten_params`` dict (numpy: f32
    floats, int8 and uint8 as they are). Folded convs export with an identity BatchNorm
    (mean 0, var 1, scale ``sqrt(1 + eps)``), so ``load_jax_params`` of the
    result reproduces the module exactly."""
    flat: Flat = {}

    def put(collection, path, value):
        key = "/".join(filter(None, [collection, prefix, path]))
        value = value.detach().cpu()
        flat[key] = (value.float() if value.is_floating_point() else value).numpy()

    def visit(obj, path):
        if isinstance(obj, nn.Parameter):
            put("params", path, obj)
        elif isinstance(obj, ConvBnAct):
            c = obj.conv.out_channels
            flat_w = _oihw_to_hwio(obj.conv.weight.detach().float().cpu().numpy())
            put("params", _join(path, "conv/kernel"), torch.from_numpy(flat_w))
            # scale = sqrt(var + eps) in f32 makes the folded gain exactly 1
            s = np.sqrt(np.float32(1.0) + np.float32(BN_EPS))
            put("params", _join(path, "bn/scale"), torch.full((c,), float(s)))
            put("params", _join(path, "bn/bias"), obj.conv.bias)
            put("batch_stats", _join(path, "bn/mean"), torch.zeros(c))
            put("batch_stats", _join(path, "bn/var"), torch.ones(c))
        elif isinstance(obj, nn.Conv2d):
            put("params", _join(path, "kernel"),
                torch.from_numpy(_oihw_to_hwio(obj.weight.detach().float().cpu().numpy())))
            if obj.bias is not None:
                put("params", _join(path, "bias"), obj.bias)
        elif isinstance(obj, Dense):
            put("params", _join(path, "kernel"), obj.weight.reshape(obj.kernel_shape))
            if obj.bias is not None:
                put("params", _join(path, "bias"), obj.bias)
        else:  # FastLayerNorm
            put("params", _join(path, "scale"), obj.scale)
            put("params", _join(path, "bias"), obj.bias)

    _walk(module, "", visit)
    return flat


def jax_param_keys(module: nn.Module, prefix: str = "") -> set:
    """The keys ``load_jax_params`` reads for ``module`` (the key set of
    ``export_jax_params``), without touching a value; at an ``Int8Dense`` or
    ``Int4Dense`` site a float ``kernel`` is taken too (quantized at load)."""
    keys = set()

    def key(collection, path):
        return "/".join(filter(None, [collection, prefix, path]))

    def visit(obj, path):
        if isinstance(obj, nn.Parameter):
            keys.add(key("params", path))
        elif isinstance(obj, ConvBnAct):
            keys.update(key("params", _join(path, leaf))
                        for leaf in ("conv/kernel", "bn/scale", "bn/bias"))
            keys.update(key("batch_stats", _join(path, leaf)) for leaf in ("bn/mean", "bn/var"))
        elif isinstance(obj, FastLayerNorm):
            keys.update(key("params", _join(path, leaf)) for leaf in ("scale", "bias"))
        else:  # nn.Conv2d, Dense
            keys.add(key("params", _join(path, "kernel")))
            if obj.bias is not None:
                keys.add(key("params", _join(path, "bias")))

    _walk(module, "", visit)
    for name, site in module.named_modules():
        if isinstance(site, (Int8Dense, Int4Dense)):
            keys.add(key("params", _join(name.replace(".", "/"), "kernel")))
    return keys


def checkpoint_for(module: nn.Module, flat: Flat, prefix: str = "") -> Flat:
    """``flat`` without the tensors ``module`` lacks, each logged as unused
    (JAX's ``load_checkpoint`` rule); a tensor the module needs and ``flat``
    lacks is left for the bridge to raise on."""
    wanted = jax_param_keys(module, prefix)
    extra = sorted(set(flat) - wanted)
    if extra:
        logger.warning("checkpoint has %d unused tensors, e.g. %s", len(extra), extra[:5])
    return {k: v for k, v in flat.items() if k in wanted}


def save_checkpoint(module: nn.Module, path: str) -> None:
    """Save ``module`` as a flat JAX-keyed ``.npz`` (``export_jax_params``)."""
    flat = export_jax_params(module)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)
    logger.info("saved %d tensors to %s", len(flat), path)


def save_checkpoint_safetensors(module: nn.Module, path: str) -> None:
    """Save ``module`` as a flat JAX-keyed ``.safetensors``."""
    flat = export_jax_params(module)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_safetensors(flat, path)
    logger.info("saved %d tensors to %s", len(flat), path)


def torch_conv_to_flax(weight: np.ndarray) -> np.ndarray:
    """torch OIHW conv kernel → flax HWIO."""
    return np.transpose(weight, (2, 3, 1, 0))


def adapt_torch_tensor(arr: np.ndarray, target_shape, tkey: str = "?"):
    """Convert a torch tensor layout to the flax target layout.

    * 4-D → conv OIHW → HWIO;
    * 2-D whose shape equals the target → direct (embeddings, already-
      (in,out) matrices are never produced by torch Linear, so a square
      direct match is only taken for non-'.weight'-of-Linear tensors —
      callers route Linears here with ``force_linear=True`` via key
      naming);
    * 2-D torch Linear ``(out, in)`` → transpose then reshape to the
      target (covers Dense ``(in, out)``, DenseGeneral ``(in, H, D)`` and
      output projections ``(H, D, out)``);
    * 1-D bias → reshape to the target.
    """
    target_shape = tuple(target_shape)
    if arr.ndim == 5 and len(target_shape) == 4:
        # Qwen2.5-VL patch embed is a Conv3d (O, I, T, H, W); image inputs
        # repeat the frame across T, so summing the temporal axis gives the
        # mathematically exact 2-D kernel
        arr = arr.sum(axis=2)
    if arr.ndim == 4:
        arr = torch_conv_to_flax(arr)
        if arr.shape != target_shape:
            raise ValueError(f"conv shape mismatch {tkey}: {arr.shape} vs {target_shape}")
        return arr
    if arr.ndim == 2:
        if int(np.prod(arr.shape)) != int(np.prod(target_shape)):
            raise ValueError(f"size mismatch {tkey}: {arr.shape} vs {target_shape}")
        transposed = arr.T
        # torch Linear stores (out, in); flax Dense-style kernels start
        # with the input dim, so the transpose-reshape is correct whenever
        # the target's leading dims consume the torch 'in' axis. Embedding
        # tables are (vocab, dim) on both sides → direct when equal AND the
        # reshape path would scramble rows; disambiguate by exact match
        # first except for square matrices, where Linear semantics win
        # only if the key says 'proj'/'lm_head'/explicit linear.
        if arr.shape == target_shape and not _looks_like_linear(tkey):
            return arr
        return np.ascontiguousarray(transposed).reshape(target_shape)
    if arr.ndim <= 1:
        return arr.reshape(target_shape)
    if arr.shape == target_shape:
        return arr
    raise ValueError(f"unsupported layout {tkey}: {arr.shape} vs {target_shape}")


_LINEAR_HINTS = ("proj", "lm_head", "fc1", "fc2", "merger", "qkv", "gate_proj",
                 "up_proj", "down_proj", ".q.", ".k.", ".v.", ".o.")


def _looks_like_linear(tkey: str) -> bool:
    return any(h in tkey for h in _LINEAR_HINTS)


def _check_conv_bn_units(module: nn.Module, prefix: str, mapped: set) -> None:
    """Raise where a state dict maps part of a ``ConvBnAct`` unit: the port
    holds the conv and its BatchNorm folded into one weight and bias, so the
    unmapped leaves have no init values to keep (JAX keeps its init)."""

    def visit(obj, path):
        if not isinstance(obj, ConvBnAct):
            return
        leaves = {"/".join(filter(None, [c, prefix, path, leaf])) for c, leaf in (
            ("params", "conv/kernel"), ("params", "bn/scale"), ("params", "bn/bias"),
            ("batch_stats", "bn/mean"), ("batch_stats", "bn/var"))}
        hit = leaves & mapped
        if hit and hit != leaves:
            raise ValueError(
                f"the state dict maps {sorted(hit)} but not {sorted(leaves - hit)}: the "
                f"port folds the BatchNorm of {path} into its conv, so a ConvBnAct "
                "unit loads whole or not at all")

    _walk(module, "", visit)


def load_torch_state_dict(
    path: str,
    module: nn.Module,
    key_map: Callable[[str], Optional[str]],
    prefix: str = "",
) -> nn.Module:
    """Port a torch checkpoint (e.g. the DocStructBench ``.pt``) into
    ``module``, whose scope in the flat JAX keys is ``prefix``.

    ``key_map`` maps each torch key to a flat flax key (or None to skip).
    The module's own parameters (``export_jax_params``) are the start; each
    mapped tensor replaces its key, adapted by ``adapt_torch_tensor`` and
    shape-checked against the model; the result goes through the bridge
    (``load_jax_params``). A mapped key the model lacks raises ``KeyError``;
    a ``ConvBnAct`` unit mapped in part raises ``ValueError``. Returns
    ``module``.
    """
    state = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "model" in state and hasattr(state["model"], "state_dict"):
        state = state["model"].state_dict()

    flat_target = export_jax_params(module, prefix)
    out = dict(flat_target)
    mapped = set()
    for tkey, tval in state.items():
        fkey = key_map(tkey)
        if fkey is None:
            continue
        if fkey not in flat_target:
            raise KeyError(f"mapped key {fkey} (from {tkey}) not in model")
        arr = tval.detach().to(torch.float32).numpy()
        out[fkey] = adapt_torch_tensor(arr, flat_target[fkey].shape, tkey)
        mapped.add(fkey)
    _check_conv_bn_units(module, prefix, mapped)
    load_jax_params(module, out, prefix)
    logger.info("ported %d/%d tensors from torch checkpoint", len(mapped), len(flat_target))
    return module


def init_random(module: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic random parameters from ``torch.Generator(seed)``, in
    the JAX package's init distributions (not its values): convs
    LeCun-normal with zero bias (folded BatchNorm at its init stats), Dense
    and attention ``N(0, 0.02)``, LayerNorm ones/zeros, ``pos_embed``
    ``N(0, 0.02)``. Runs on the CPU in f32, so every device and dtype
    starts from the same values. (The mmE5 model draws on its own device
    instead: ``build_mme5``.)"""
    gen = torch.Generator().manual_seed(seed)

    def normal(t: torch.Tensor, std: float) -> None:
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=gen) * std)

    def lecun(conv: nn.Conv2d, gain: float = 1.0) -> None:
        fan_in = conv.weight[0].numel()
        normal(conv.weight, gain / math.sqrt(fan_in))
        nn.init.zeros_(conv.bias)

    def visit(obj, path):
        if isinstance(obj, nn.Parameter):
            normal(obj, 0.02)
        elif isinstance(obj, ConvBnAct):
            lecun(obj.conv, 1.0 / math.sqrt(1.0 + BN_EPS))
        elif isinstance(obj, nn.Conv2d):
            lecun(obj)
        elif isinstance(obj, Dense):
            normal(obj.weight, 0.02)
            if obj.bias is not None:
                nn.init.zeros_(obj.bias)
        else:  # FastLayerNorm
            nn.init.ones_(obj.scale)
            nn.init.zeros_(obj.bias)

    module.float()
    _walk(module, "", visit)
    return module


def load_params(
    module: nn.Module, seed: int, params: Optional[Flat], weights_path: Optional[str],
) -> nn.Module:
    """The parameter source of the engines: a JAX flat dict, else a JAX
    ``.npz`` or ``.safetensors`` checkpoint (tensors the module lacks
    dropped), else seeded random values."""
    if params is None and weights_path:
        params = checkpoint_for(module, load_checkpoint(weights_path))
    if params is None:
        return init_random(module, seed)
    return load_jax_params(module.float(), params)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Asking for CUDA where there is no
    CUDA device raises: an engine never lands on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def _build(factory, dtype, device, seed, params, weights_path) -> nn.Module:
    with torch.device("meta"):
        model = factory()
    materialize(model, device, dtype)
    if params is None and weights_path:
        params = checkpoint_for(model, load_checkpoint(weights_path))
    if params is None:
        synthetic_int8_init(model, seed)
    else:
        load_jax_params(model, params)
    return model.eval()


def build_mme5(
    config: MllamaConfig, dtype: torch.dtype, device, seed: int = 0,
    params: Optional[Flat] = None, weights_path: Optional[str] = None,
) -> MmE5Embedder:
    """The mmE5 model on ``device``, computing in ``dtype``, its parameters
    from a JAX flat dict, else a JAX ``.npz``/``.safetensors`` checkpoint, else
    ``synthetic_int8_init(seed)`` drawn on ``device``."""
    return _build(lambda: MmE5Embedder(config, dtype), dtype, device, seed, params,
                  weights_path)


def build_qwen(
    config: QwenVLConfig, dtype: torch.dtype, device, seed: int = 0,
    params: Optional[Flat] = None, weights_path: Optional[str] = None,
) -> QwenVLModel:
    """The Qwen2.5-VL model on ``device`` (the card unless asked for the
    CPU), computing in ``dtype``, its parameters from a JAX flat dict, else
    a JAX ``.npz``/``.safetensors`` checkpoint, else ``synthetic_int8_init(seed)`` drawn on
    ``device`` (every float matrix N(0, 0.02), 1-D leaves 0.02, int8 and
    packed int4 storage uniform)."""
    return _build(lambda: QwenVLModel(config, dtype), dtype, resolve_device(device), seed,
                  params, weights_path)
