"""Weight-only int8 serving layers, parameter storage and synthetic weights.

Port of ``multimodal_embeddings_tpu/models/quantized.py``:

* ``Int8Dense``: the drop-in of ``Int8DenseGeneral``, an ``(in, out)``
  int8 ``kernel_q`` with a ``(1, out)`` f32 ``kernel_scale`` and an
  optional bias, applied through K2 (``kernels/quantization.py``) in the
  compute dtype;
* ``Int4Dense``: the drop-in of ``Int4DenseGeneral``, an ``(in/2, out)``
  uint8 ``kernel_q4`` of packed nibbles with ``(n_groups, out)`` f32 group
  scales and an optional bias, applied through K3
  (``kernels/quantization_int4.py``); ``quant_dense_cls`` maps a
  ``quantize`` flag to the drop-in. Biases keep the JAX module's
  features-shaped bias (``(heads, head_dim)`` for a q/k/v projection);
* ``storage_dtype``: what each parameter is stored as — int8 stays int8,
  ``kernel_scale`` and every 1-D parameter (norm scales, biases, gates,
  ``class_embedding``) stay f32, every other float tensor takes the
  compute dtype (the JAX modules cast those kernels to it at use);
* ``synthetic_int8_init``: seeded random weights drawn on the target
  device, in their storage types, with ``synthetic_int8_init``'s
  distributions (int8 uniform in [−127, 127], packed int4 bytes uniform in
  [0, 255], floats N(0, 0.02) rounded to bf16 when a tensor holds more than
  1e6 values, 1-D leaves 0.02) — the 11B and 32B trees never exist on the
  host;
* ``quantize_dense_tree``: a float parameter tree (the weight bridge's
  flat dict) converted into a quantized module's storage, each float
  ``kernel`` at an ``Int8Dense`` or ``Int4Dense`` site quantized in f32 on
  the device given, one leaf at a time, with round half to even as in JAX:
  a float checkpoint loads into a quantized model without a float twin on
  the device;
* ``param_bytes``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from multimodal_embeddings_tpu_torch.kernels.quantization import (
    QTensor,
    int8_apply,
    quantize_tensor,
)
from multimodal_embeddings_tpu_torch.kernels.quantization_int4 import (
    Q4Tensor,
    int4_apply,
    int4_group_size,
    quantize_tensor_int4,
)


class Int8Dense(nn.Module):
    """``x @ (kernel_q · kernel_scale) (+ bias)`` with x cast to ``dtype``;
    the output is in ``dtype``."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = False, dtype=None,
        bias_shape=None,
    ):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=torch.int8), requires_grad=False
        )
        self.kernel_scale = nn.Parameter(torch.ones(1, out_features))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (out_features,))) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_apply(x.to(self.dtype or x.dtype), QTensor(self.kernel_q, self.kernel_scale))
        if self.bias is not None:
            y = y + self.bias.reshape(-1).to(y.dtype)
        return y


class Int4Dense(nn.Module):
    """``bf16(x) @ dequant(kernel_q4, kernel_scale) (+ bias)`` with x cast to
    ``dtype``; the output is in ``dtype``."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = False, dtype=None,
        bias_shape=None, group_size: int = 128,
    ):
        super().__init__()
        self.dtype = dtype
        g = int4_group_size(in_features, group_size)
        self.kernel_q4 = nn.Parameter(  # nibbles 8: q = 0
            torch.full((in_features // 2, out_features), 0x88, dtype=torch.uint8),
            requires_grad=False,
        )
        self.kernel_scale = nn.Parameter(torch.ones(in_features // g, out_features))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (out_features,))) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int4_apply(x.to(self.dtype or x.dtype), Q4Tensor(self.kernel_q4, self.kernel_scale))
        if self.bias is not None:
            y = y + self.bias.reshape(-1).to(y.dtype)
        return y


def quant_dense_cls(quantize):
    """``True``/``"int8"`` → ``Int8Dense``; ``"int4"`` → ``Int4Dense``."""
    return Int4Dense if quantize == "int4" else Int8Dense


def quantize_dense_tree(
    src: Dict[str, np.ndarray], target: nn.Module, prefix: str = "", device=None,
) -> Dict[str, np.ndarray]:
    """Convert a float parameter tree into ``target``'s quantized storage.

    ``src`` is the weight bridge's flat dict (``"params/<path>/kernel"`` →
    numpy) of the float model; ``target`` the quantized module, its scope
    in ``src`` under ``prefix``. Wherever ``target`` holds an ``Int8Dense``
    or ``Int4Dense`` and ``src`` a float ``kernel``, the kernel is
    reshaped to ``(in, out)`` and quantized in f32 (per output channel for
    int8, in the target's scale groups for int4), on ``device`` (default
    the target's, the CPU for a ``meta`` module), one leaf at a time; every
    other leaf is carried over."""
    if device is None:
        device = next(target.parameters()).device
        if device.type == "meta":
            device = torch.device("cpu")
    out = dict(src)
    for name, site in target.named_modules():
        if not isinstance(site, (Int8Dense, Int4Dense)):
            continue
        key = "/".join(filter(None, ["params", prefix, name.replace(".", "/"), "kernel"]))
        if key not in src:
            continue
        del out[key]
        w = torch.tensor(np.asarray(src[key], np.float32), device=device)
        if isinstance(site, Int8Dense):
            qt = quantize_tensor(w.reshape(site.kernel_q.shape), contract_axes=(0,))
            leaves = {"kernel_q": qt.q, "kernel_scale": qt.scale}
        else:
            in_f, out_f = 2 * site.kernel_q4.shape[0], site.kernel_q4.shape[1]
            qt = quantize_tensor_int4(
                w.reshape(in_f, out_f), group_size=in_f // site.kernel_scale.shape[0]
            )
            leaves = {"kernel_q4": qt.packed, "kernel_scale": qt.scale}
        for leaf, value in leaves.items():
            out[key[: -len("kernel")] + leaf] = value.cpu().numpy()
    return out


def storage_dtype(name: str, param: torch.Tensor, dtype: torch.dtype) -> torch.dtype:
    """The type parameter ``name`` is stored in for compute dtype ``dtype``."""
    if not param.is_floating_point():
        return param.dtype
    if name == "kernel_scale" or param.dim() <= 1:
        return torch.float32
    return dtype


def _params(module: nn.Module):
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            yield mod, name, p


def materialize(module: nn.Module, device, dtype: torch.dtype) -> nn.Module:
    """Give every parameter (typically built on the ``meta`` device) fresh
    uninitialised storage on ``device`` in its storage type."""
    for mod, name, p in list(_params(module)):
        t = torch.empty(p.shape, dtype=storage_dtype(name, p, dtype), device=device)
        setattr(mod, name, nn.Parameter(t, requires_grad=False))
    return module


@torch.no_grad()
def synthetic_int8_init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill a materialized module with seeded random values on its own
    device (``torch.Generator`` of that device), in ``named_parameters``
    order."""
    device = next(module.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for _, name, p in _params(module):
        if p.dtype == torch.int8:
            p.copy_(torch.randint(-127, 128, p.shape, generator=gen, device=device,
                                  dtype=torch.int8))
        elif p.dtype == torch.uint8:  # packed int4 nibbles
            p.copy_(torch.randint(0, 256, p.shape, generator=gen, device=device,
                                  dtype=torch.uint8))
        elif p.dim() == 1:
            p.fill_(0.02)
        else:
            draw = torch.bfloat16 if p.numel() > 1e6 else torch.float32
            w = torch.randn(p.shape, generator=gen, device=device, dtype=draw)
            p.copy_(w.mul_(0.02).to(draw))
    return module


def param_bytes(module: nn.Module) -> int:
    """Total parameter storage in bytes (int8 and uint8 count 1, bf16 2,
    f32 4)."""
    return sum(p.numel() * p.element_size() for p in module.parameters())
