"""Transformer primitives of the ViT tower, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/transformer.py``'s
``FastLayerNorm``, ``Attention`` (its ``_proj_blf`` form), ``GeluMLP`` and
``EncoderBlock``. Dense weights are stored as the JAX package stores them,
``(in, out)``, and applied as ``x @ W`` (``models/weights.py`` converts).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.kernels.encoder_attention import (
    encoder_attention_blf,
)


class Dense(nn.Module):
    """``flax.linen.Dense``: ``x @ weight (+ bias)``, weight ``(in, out)``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.t(), self.bias)


class FastLayerNorm(nn.Module):
    """LayerNorm with the JAX fallback's arithmetic: f32 statistics by the
    one-pass formula ``var = max(mean(x²) − mean², 0)``, eps 1e-6, result
    cast back to the input dtype (not ``F.layer_norm``'s two-pass
    variance)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        y = (xf - mean) * (rstd * self.scale.float()) + self.bias.float()
        return y.to(x.dtype)


class Attention(nn.Module):
    """Unmasked multi-head self-attention: plain ``(B, L, C) @ (C, H·D)``
    projections, the K1 kernel on the ``(B, L, H·D)`` slabs, and
    ``(B, L, H·D) @ (H·D, C)`` out. Every length goes through K1 (the JAX
    package's [256, 1664] window and ``% 16`` gate are TPU VMEM limits)."""

    def __init__(self, width: int, num_heads: int, head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        inner = num_heads * head_dim
        self.q = nn.Parameter(torch.empty(width, inner))
        self.k = nn.Parameter(torch.empty(width, inner))
        self.v = nn.Parameter(torch.empty(width, inner))
        self.o = nn.Parameter(torch.empty(inner, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = x @ self.q
        k = x @ self.k
        v = x @ self.v
        o = encoder_attention_blf(q, k, v, heads=self.num_heads)
        return o @ self.o


class GeluMLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(width, hidden)
        self.fc2 = Dense(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln1 = FastLayerNorm(width)
        self.attn = Attention(width, num_heads, width // num_heads)
        self.ln2 = FastLayerNorm(width)
        self.mlp = GeluMLP(width, int(width * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))
