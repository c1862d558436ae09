"""DocLayout-YOLO detector (YOLOv10 family, GL-CRM backbone) in PyTorch.

Port of ``multimodal_embeddings_tpu/models/yolo.py``: CSP backbone, PAN
neck and the NMS-free v10 one-to-one head with DFL box regression. The
forward takes and returns the JAX package's NHWC layout; inside, the
network runs NCHW in ``channels_last`` memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from multimodal_embeddings_tpu_torch.models.layers import (
    C2f,
    ConvBnAct,
    CRMBottleneck,
    G2L_CRM,
    PSA,
    SCDown,
    SPPF,
    upsample2x,
)


@dataclasses.dataclass(frozen=True)
class YoloScale:
    depth: float
    width: float
    max_channels: int


SCALES: Dict[str, YoloScale] = {
    "n": YoloScale(0.33, 0.25, 1024),
    "s": YoloScale(0.33, 0.50, 1024),
    "m": YoloScale(0.67, 0.75, 768),
    "b": YoloScale(0.67, 1.00, 512),
    "l": YoloScale(1.00, 1.00, 512),
    "x": YoloScale(1.00, 1.25, 512),
}

REG_MAX = 16  # DFL bins per box side
STRIDES = (8, 16, 32)


def _ch(base: int, scale: YoloScale) -> int:
    """Scaled channel count, rounded up to a multiple of 8."""
    c = min(base, scale.max_channels) * scale.width
    return max(8, int(math.ceil(c / 8) * 8))


def _depth(n: int, scale: YoloScale) -> int:
    return max(1, round(n * scale.depth))


class Backbone(nn.Module):
    """CSP backbone; ``glcrm=True`` uses G2L_CRM blocks for the P2/P3/P4
    stages (dilation 2, 2, 4), the DocStructBench architecture, whose inner
    widths up to ``pallas_convs`` run on K5 (``pallas_mode``: "stage" or
    "block")."""

    def __init__(
        self, scale: YoloScale, glcrm: bool = False, pallas_convs: int = 0,
        pallas_mode: str = "stage",
    ):
        super().__init__()
        s = scale

        def csp(c, n, dilation):
            if glcrm:
                return G2L_CRM(c, c, n, dilation=dilation, shortcut=True,
                               pallas_max_channels=pallas_convs, pallas_mode=pallas_mode)
            return C2f(c, c, n, shortcut=True)

        c64, c128, c256 = _ch(64, s), _ch(128, s), _ch(256, s)
        c512, c1024 = _ch(512, s), _ch(1024, s)
        self.stem = ConvBnAct(3, c64, 3, 2)  # P1/2
        self.down2 = ConvBnAct(c64, c128, 3, 2)  # P2/4
        self.c2f_2 = csp(c128, _depth(3, s), 2)
        self.down3 = ConvBnAct(c128, c256, 3, 2)  # P3/8
        self.c2f_3 = csp(c256, _depth(6, s), 2)
        self.down4 = SCDown(c256, c512)  # P4/16
        self.c2f_4 = csp(c512, _depth(6, s), 4)
        self.down5 = SCDown(c512, c1024)  # P5/32
        self.c2fcib_5 = C2f(c1024, c1024, _depth(3, s), shortcut=True, use_cib=True)
        self.sppf = SPPF(c1024, c1024)
        self.psa = PSA(c1024, c1024)

    def forward(self, x):
        x = self.c2f_2(self.down2(self.stem(x)))
        p3 = self.c2f_3(self.down3(x))
        p4 = self.c2f_4(self.down4(p3))
        x = self.c2fcib_5(self.down5(p4))
        p5 = self.psa(self.sppf(x))
        return p3, p4, p5


class PANNeck(nn.Module):
    def __init__(self, scale: YoloScale):
        super().__init__()
        s = scale
        c256, c512, c1024 = _ch(256, s), _ch(512, s), _ch(1024, s)
        d3 = _depth(3, s)
        self.td_c2f_4 = C2f(c1024 + c512, c512, d3)
        self.td_c2f_3 = C2f(c512 + c256, c256, d3)
        self.bu_down_3 = ConvBnAct(c256, c256, 3, 2)
        self.bu_c2fcib_4 = C2f(c256 + c512, c512, d3, shortcut=True, use_cib=True)
        self.bu_down_4 = SCDown(c512, c512)
        self.bu_c2fcib_5 = C2f(c512 + c1024, c1024, d3, shortcut=True, use_cib=True)

    def forward(self, p3, p4, p5):
        n4 = self.td_c2f_4(torch.cat([upsample2x(p5), p4], dim=1))
        n3 = self.td_c2f_3(torch.cat([upsample2x(n4), p3], dim=1))
        m4 = self.bu_c2fcib_4(torch.cat([self.bu_down_3(n3), n4], dim=1))
        m5 = self.bu_c2fcib_5(torch.cat([self.bu_down_4(m4), p5], dim=1))
        return n3, m4, m5


class DetectHead(nn.Module):
    """v10 one-to-one head: per level, DFL regression (4·REG_MAX logits)
    and a depthwise-separable classification branch."""

    def __init__(self, num_classes: int, channels: Tuple[int, ...]):
        super().__init__()
        self.levels = len(channels)
        c2 = max(16, channels[0] // 4, REG_MAX * 4)
        c3 = max(channels[0], min(num_classes, 100))
        for i, ch in enumerate(channels):
            layers = {
                f"reg{i}_cv1": ConvBnAct(ch, c2, 3),
                f"reg{i}_cv2": ConvBnAct(c2, c2, 3),
                f"reg{i}_out": nn.Conv2d(c2, 4 * REG_MAX, 1),
                f"cls{i}_dw1": ConvBnAct(ch, ch, 3, groups=ch),
                f"cls{i}_pw1": ConvBnAct(ch, c3, 1),
                f"cls{i}_dw2": ConvBnAct(c3, c3, 3, groups=c3),
                f"cls{i}_pw2": ConvBnAct(c3, c3, 1),
                f"cls{i}_out": nn.Conv2d(c3, num_classes, 1),
            }
            for name, layer in layers.items():
                self.add_module(name, layer)

    def forward(self, feats) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        outputs = []
        for i, f in enumerate(feats):
            reg, cls = f, f
            for name in ("cv1", "cv2", "out"):
                reg = getattr(self, f"reg{i}_{name}")(reg)
            for name in ("dw1", "pw1", "dw2", "pw2", "out"):
                cls = getattr(self, f"cls{i}_{name}")(cls)
            outputs.append((reg, cls))
        return outputs


class DocLayoutYOLO(nn.Module):
    """Full detector: ``forward(images (B, H, W, 3) in [0, 1])`` returns the
    raw per-level ``(reg, cls)`` maps, NHWC, as the JAX model does; decode
    them with ``yolo_decode.decode_predictions``."""

    def __init__(
        self, num_classes: int = 10, variant: str = "m", glcrm: bool = False,
        pallas_convs: int = 0, pallas_mode: str = "stage",
    ):
        super().__init__()
        scale = SCALES[variant]
        self.backbone = Backbone(scale, glcrm, pallas_convs, pallas_mode)
        self.neck = PANNeck(scale)
        self.head = DetectHead(
            num_classes, (_ch(256, scale), _ch(512, scale), _ch(1024, scale))
        )

    def kernel_bias_names(self) -> List[str]:
        """The folded biases that K5 reads: kept in f32 at any compute
        dtype, as the JAX ``_FoldedConvBn`` returns them."""
        return [
            f"{name}.{conv}.conv.bias"
            for name, m in self.named_modules()
            if isinstance(m, CRMBottleneck) and m.kernel
            for conv in ("cv1", "cv2")
        ]

    def forward(self, images: torch.Tensor):
        dtype = self.backbone.stem.conv.weight.dtype
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        p3, p4, p5 = self.backbone(x)
        levels = self.head(self.neck(p3, p4, p5))
        return [
            (reg.permute(0, 2, 3, 1), cls.permute(0, 2, 3, 1))
            for reg, cls in levels
        ]
