"""YOLOv10 / DocLayout-YOLO building blocks in PyTorch.

Port of ``multimodal_embeddings_tpu/models/layers.py``: its default
(NHWC/XLA) path, and the GL-CRM stages' route through the 3×3 conv kernel
(K5, ``kernels/conv.py``) that the JAX package's ``pallas_max_channels`` /
``pallas_mode`` select. Modules compute in NCHW tensors, best kept in
``torch.channels_last`` memory: then the PSA block's ``(B, L, C)`` view of
its qkv conv output is free, and K5 reads the stages' tensors in place.
Submodule names are the JAX scope names (``cv1``, ``m0``, ``bn`` folded
into ``conv``...), so ``models/weights.py`` maps parameters by path; the
kernel route has the same parameters.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.kernels.conv import conv3x3_nchw
from multimodal_embeddings_tpu_torch.kernels.encoder_attention import (
    encoder_attention_blf_packed,
)
from multimodal_embeddings_tpu_torch.models.transformer import _opted_out, sdpa

BN_EPS = 1e-3  # nn.BatchNorm(epsilon=1e-3) of the JAX ConvBnAct


def autopad(k: int, d: int = 1) -> int:
    """'same' padding for odd kernels with dilation."""
    return (d * (k - 1) + 1) // 2


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + SiLU with the BatchNorm folded into the conv's
    weight and bias at load (inference only)."""

    def __init__(
        self, c_in: int, c_out: int, kernel_size: int = 1, strides: int = 1,
        groups: int = 1, dilation: int = 1, act: bool = True,
    ):
        super().__init__()
        self.act = act
        self.conv = nn.Conv2d(
            c_in, c_out, kernel_size, strides,
            padding=autopad(kernel_size, dilation), dilation=dilation,
            groups=groups, bias=True,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(
        self, c_in: int, c_out: int, shortcut: bool = True, groups: int = 1,
        kernels: Tuple[int, int] = (3, 3), expansion: float = 0.5,
    ):
        super().__init__()
        hidden = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, hidden, kernels[0])
        self.cv2 = ConvBnAct(hidden, c_out, kernels[1], groups=groups)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CIB(nn.Module):
    """Compact Inverted Block: DW3 → PW-expand → DW3 (7 if long) →
    PW-project → DW3."""

    def __init__(
        self, c_in: int, c_out: int, shortcut: bool = True,
        expansion: float = 0.5, long_kernel: bool = False,
    ):
        super().__init__()
        hidden = 2 * int(c_out * expansion)
        k = 7 if long_kernel else 3
        self.dw1 = ConvBnAct(c_in, c_in, 3, groups=c_in)
        self.pw1 = ConvBnAct(c_in, hidden, 1)
        self.dw2 = ConvBnAct(hidden, hidden, k, groups=hidden)
        self.pw2 = ConvBnAct(hidden, c_out, 1)
        self.dw3 = ConvBnAct(c_out, c_out, 3, groups=c_out)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.dw3(self.pw2(self.dw2(self.pw1(self.dw1(x)))))
        return x + y if self.add else y


class _CSP(nn.Module):
    """C2f scaffold: cv1 splits into two halves, ``n`` chained inner blocks
    each append their output, cv2 fuses the concatenation."""

    def __init__(self, c_in: int, c_out: int, n: int, expansion: float, make_block):
        super().__init__()
        self.c = c = int(c_out * expansion)
        self.n = n
        self.cv1 = ConvBnAct(c_in, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", make_block(c))
        self.cv2 = ConvBnAct((2 + n) * c, c_out, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class C2f(_CSP):
    """CSP bottleneck with two convolutions and ``n`` Bottleneck (or CIB,
    ``use_cib``) inner blocks."""

    def __init__(
        self, c_in: int, c_out: int, n: int = 1, shortcut: bool = False,
        groups: int = 1, expansion: float = 0.5, use_cib: bool = False,
        long_kernel: bool = False,
    ):
        def block(c):
            if use_cib:
                return CIB(c, c, shortcut, expansion=1.0, long_kernel=long_kernel)
            return Bottleneck(c, c, shortcut, groups, (3, 3), expansion=1.0)

        super().__init__(c_in, c_out, n, expansion, block)


def _pw_nchw(x, w_oi, bias, act: bool = False):
    """Pointwise (1×1) conv as a channel product, the JAX ``_pw_nchw``
    numerics: the product in x's dtype, then the bias cast to that dtype and
    added, then SiLU. ``w_oi`` is ``(Cout, C)``."""
    y = torch.matmul(x.permute(0, 2, 3, 1), w_oi.t().to(x.dtype)).permute(0, 3, 1, 2)
    y = y + bias.to(y.dtype).reshape(1, -1, 1, 1)
    return F.silu(y) if act else y


class CRMBottleneck(nn.Module):
    """GL-CRM inner block: dilated 3×3 ("global"), then 3×3 ("local"),
    scaled by a per-pixel sigmoid gate (1×1 conv with bias over the block
    input), plus the residual.

    ``kernel=True`` is the JAX ``_nchw_forward`` / ``_pallas_forward``
    route (inference): the two 3×3s on K5 with their folded f32 biases and
    the SiLU fused, the gate as a channel product."""

    def __init__(
        self, c_in: int, c: int, shortcut: bool = True, dilation: int = 2,
        kernel: bool = False,
    ):
        super().__init__()
        self.dilation = dilation
        self.kernel = kernel
        self.cv1 = ConvBnAct(c_in, c, 3, dilation=dilation)
        self.cv2 = ConvBnAct(c, c, 3)
        self.gate = nn.Conv2d(c_in, c, 1)
        self.add = shortcut and c_in == c

    def forward(self, x):
        if self.kernel:
            y = conv3x3_nchw(x, self.cv1.conv.weight, self.cv1.conv.bias.float(),
                             act="silu", dilation=self.dilation)
            y = conv3x3_nchw(y, self.cv2.conv.weight, self.cv2.conv.bias.float(), act="silu")
            gate = _pw_nchw(x, self.gate.weight[:, :, 0, 0], self.gate.bias)
        else:
            y, gate = self.cv2(self.cv1(x)), self.gate(x)
        y = y * torch.sigmoid(gate)
        return x + y if self.add else y


class G2L_CRM(_CSP):
    """Global-to-local controllable receptive module: the C2f scaffold with
    ``CRMBottleneck`` inner blocks.

    Inner widths ``c ≤ pallas_max_channels`` (0: none) take the K5 route:
    ``pallas_mode="stage"`` runs the whole stage on it (cv1, cv2 and the
    gates as channel products, the JAX ``_stage_nchw``), ``"block"`` only
    the bottlenecks (cv1/cv2 stay library convs). Channels-last tensors
    flow through unchanged: the JAX stage edge's NHWC↔NCHW transposes were
    a TPU layout concern."""

    def __init__(
        self, c_in: int, c_out: int, n: int = 1, dilation: int = 2,
        shortcut: bool = True, expansion: float = 0.5, pallas_max_channels: int = 0,
        pallas_mode: str = "stage",
    ):
        if pallas_mode not in ("stage", "block"):
            raise ValueError(f"pallas_mode must be 'stage' or 'block', not {pallas_mode!r}")
        kernel = 0 < int(c_out * expansion) <= pallas_max_channels
        super().__init__(
            c_in, c_out, n, expansion,
            lambda c: CRMBottleneck(c, c, shortcut, dilation, kernel=kernel),
        )
        self.stage = kernel and pallas_mode == "stage"

    def forward(self, x):
        if not self.stage:
            return super().forward(x)
        c = self.c
        y = _pw_nchw(x, self.cv1.conv.weight[:, :, 0, 0], self.cv1.conv.bias, act=True)
        parts = [y[:, :c], y[:, c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        y = torch.cat(parts, dim=1)
        return _pw_nchw(y, self.cv2.conv.weight[:, :, 0, 0], self.cv2.conv.bias, act=True)


class SCDown(nn.Module):
    """1×1 channel map, then a stride-2 depthwise conv without activation."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, strides: int = 2):
        super().__init__()
        self.cv1 = ConvBnAct(c_in, c_out, 1)
        self.cv2 = ConvBnAct(
            c_out, c_out, kernel_size, strides, groups=c_out, act=False
        )

    def forward(self, x):
        return self.cv2(self.cv1(x))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): three chained 5×5 max-pools, padded
    with −inf."""

    def __init__(self, c_in: int, c_out: int, pool_size: int = 5):
        super().__init__()
        hidden = c_in // 2
        self.pool_size = pool_size
        self.cv1 = ConvBnAct(c_in, hidden, 1)
        self.cv2 = ConvBnAct(4 * hidden, c_out, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(
                F.max_pool2d(pools[-1], self.pool_size, 1, self.pool_size // 2)
            )
        return self.cv2(torch.cat(pools, dim=1))


class PSAAttention(nn.Module):
    """YOLOv10 PSA attention: one 1×1 qkv conv whose channels are packed per
    head as ``[q(kd) | k(kd) | v(hd)]`` (ultralytics order), whole-row
    attention through the packed K1 kernel (``sdpa`` on strided views of
    the slab under ``MMTPU_PSA_BLF=0``, as in JAX), a 3×3 depthwise
    positional branch over V, and a 1×1 projection."""

    def __init__(self, channels: int, attn_ratio: float = 0.5, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        per_head = 2 * self.key_dim + self.head_dim
        self.qkv = ConvBnAct(channels, per_head * num_heads, 1, act=False)
        self.pe = ConvBnAct(channels, channels, 3, groups=channels, act=False)
        self.proj = ConvBnAct(channels, channels, 1, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, kd, hd = self.num_heads, self.key_dim, self.head_dim
        # (B, L, C) channel-minor: a view when qkv is channels_last
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, -1)
        per_head = qkv.reshape(b, h * w, nh, 2 * kd + hd)
        if _opted_out("MMTPU_PSA_BLF"):
            out = sdpa(per_head[..., :kd], per_head[..., kd : 2 * kd], per_head[..., 2 * kd :])
        else:
            out = encoder_attention_blf_packed(qkv, nh, kd, hd)
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = per_head[..., 2 * kd :].reshape(b, h, w, nh * hd).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class PSA(nn.Module):
    """Partial self-attention: attend over half the channels, pass the rest
    through."""

    def __init__(self, c_in: int, c_out: int, expansion: float = 0.5):
        super().__init__()
        self.c = c = int(c_out * expansion)
        self.cv1 = ConvBnAct(c_in, 2 * c, 1)
        self.attn = PSAAttention(c, num_heads=max(1, c // 64))
        self.ffn1 = ConvBnAct(c, 2 * c, 1)
        self.ffn2 = ConvBnAct(2 * c, c, 1, act=False)
        self.cv2 = ConvBnAct(2 * c, c_out, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, bpart = y[:, : self.c], y[:, self.c :]
        bpart = bpart + self.attn(bpart)
        bpart = bpart + self.ffn2(self.ffn1(bpart))
        return self.cv2(torch.cat([a, bpart], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× upsample (PAN top-down path)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
