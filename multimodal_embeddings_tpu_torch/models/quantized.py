"""Weight-only int8 serving layers, parameter storage and synthetic weights.

Port of ``multimodal_embeddings_tpu/models/quantized.py``:

* ``Int8Dense``: the drop-in of ``Int8DenseGeneral``, an ``(in, out)``
  int8 ``kernel_q`` with a ``(1, out)`` f32 ``kernel_scale`` and an
  optional bias, applied through K2 (``kernels/quantization.py``) in the
  compute dtype;
* ``storage_dtype``: what each parameter is stored as — int8 stays int8,
  ``kernel_scale`` and every 1-D parameter (norm scales, biases, gates,
  ``class_embedding``) stay f32, every other float tensor takes the
  compute dtype (the JAX modules cast those kernels to it at use);
* ``synthetic_int8_init``: seeded random weights drawn on the target
  device, in their storage types, with ``synthetic_int8_init``'s
  distributions (int8 uniform in [−127, 127], floats N(0, 0.02) rounded to
  bf16 when a tensor holds more than 1e6 values, 1-D leaves 0.02) — the
  11B tree never exists on the host (the JAX package's f32 twin is 44 GB);
* ``param_bytes``.

The ``int4`` storage (``Int4DenseGeneral``, K3) and ``quantize_dense_tree``
are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_embeddings_tpu_torch.kernels.quantization import QTensor, int8_apply


class Int8Dense(nn.Module):
    """``x @ (kernel_q · kernel_scale) (+ bias)`` with x cast to ``dtype``;
    the output is in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = nn.Parameter(
            torch.zeros(in_features, out_features, dtype=torch.int8), requires_grad=False
        )
        self.kernel_scale = nn.Parameter(torch.ones(1, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_apply(x.to(self.dtype or x.dtype), QTensor(self.kernel_q, self.kernel_scale))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


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
        elif p.dim() == 1:
            p.fill_(0.02)
        else:
            draw = torch.bfloat16 if p.numel() > 1e6 else torch.float32
            w = torch.randn(p.shape, generator=gen, device=device, dtype=draw)
            p.copy_(w.mul_(0.02).to(draw))
    return module


def param_bytes(module: nn.Module) -> int:
    """Total parameter storage in bytes (int8 counts 1, bf16 2, f32 4)."""
    return sum(p.numel() * p.element_size() for p in module.parameters())
