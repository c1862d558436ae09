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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_embeddings_tpu_torch.models.layers import BN_EPS, ConvBnAct
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig, MmE5Embedder
from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig, QwenVLModel
from multimodal_embeddings_tpu_torch.models.quantized import (
    materialize,
    quantize_dense_tree,
    synthetic_int8_init,
)
from multimodal_embeddings_tpu_torch.models.transformer import Dense, FastLayerNorm

Flat = Dict[str, np.ndarray]


def load_npz(path: str) -> Flat:
    """A JAX-package ``.npz`` checkpoint as a flat numpy dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


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
    ``.npz`` checkpoint, else seeded random values."""
    if params is None and weights_path:
        params = load_npz(weights_path)
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
        params = load_npz(weights_path)
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
    from a JAX flat dict, else a JAX ``.npz`` checkpoint, else
    ``synthetic_int8_init(seed)`` drawn on ``device``."""
    return _build(lambda: MmE5Embedder(config, dtype), dtype, device, seed, params,
                  weights_path)


def build_qwen(
    config: QwenVLConfig, dtype: torch.dtype, device, seed: int = 0,
    params: Optional[Flat] = None, weights_path: Optional[str] = None,
) -> QwenVLModel:
    """The Qwen2.5-VL model on ``device`` (the card unless asked for the
    CPU), computing in ``dtype``, its parameters from a JAX flat dict, else
    a JAX ``.npz`` checkpoint, else ``synthetic_int8_init(seed)`` drawn on
    ``device`` (every float matrix N(0, 0.02), 1-D leaves 0.02, int8 and
    packed int4 storage uniform)."""
    return _build(lambda: QwenVLModel(config, dtype), dtype, resolve_device(device), seed,
                  params, weights_path)
