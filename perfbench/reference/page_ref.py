"""The plain reference of the page program: letterboxed views, the
DocLayout-YOLOv10 detector with GL-CRM stages (arXiv:2410.12628), DFL
decode, the per-view and the class-aware cross-view NMS, bilinear crops and
the ViT-B/16 tower (arXiv:2010.11929) with mean pooling.

Plain PyTorch in float32 (TF32 off), no kernel, no cache; it imports nothing
of the program. Module and parameter names follow the program's, so one
state dict drawn by the benchmark loads into both. ``set_precision("fp8")``
rounds the inputs and weights of every convolution, matrix product and
attention product to float8 e4m3 (a scale per tensor): the control that the
correctness limits are set against.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = {"mode": "float32"}


def set_precision(mode: str) -> None:
    if mode not in ("float32", "fp8"):
        raise ValueError(mode)
    _PRECISION["mode"] = mode


def rq(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it enters a product: itself in float32, else rounded to
    float8 e4m3 at a scale per tensor (its largest magnitude at 448)."""
    if _PRECISION["mode"] == "float32":
        return x
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = amax / 448.0
    return ((x / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(rq(x), rq(self.weight), self.bias, self.stride, self.padding,
                        self.dilation, self.groups)


def matmul(a, b):
    return torch.matmul(rq(a), rq(b))


# ----------------------------------------------------------------------------
# detector
# ----------------------------------------------------------------------------

REG_MAX = 16
STRIDES = (8, 16, 32)
SCALES = {"n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
          "b": (0.67, 1.00, 512), "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512)}


def _ch(base, scale):
    c = min(base, scale[2]) * scale[1]
    return max(8, int(math.ceil(c / 8) * 8))


def _depth(n, scale):
    return max(1, round(n * scale[0]))


class ConvBnAct(nn.Module):
    """Conv with the BatchNorm folded into its weight and bias, then SiLU."""

    def __init__(self, c_in, c_out, k=1, s=1, groups=1, dilation=1, act=True):
        super().__init__()
        self.act = act
        self.conv = Conv2d(c_in, c_out, k, s, padding=(dilation * (k - 1) + 1) // 2,
                           dilation=dilation, groups=groups, bias=True)

    def forward(self, x):
        x = self.conv(x)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True):
        super().__init__()
        self.cv1 = ConvBnAct(c_in, c_out, 3)
        self.cv2 = ConvBnAct(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CIB(nn.Module):
    def __init__(self, c_in, c_out, shortcut=True):
        super().__init__()
        hidden = 2 * c_out
        self.dw1 = ConvBnAct(c_in, c_in, 3, groups=c_in)
        self.pw1 = ConvBnAct(c_in, hidden, 1)
        self.dw2 = ConvBnAct(hidden, hidden, 3, groups=hidden)
        self.pw2 = ConvBnAct(hidden, c_out, 1)
        self.dw3 = ConvBnAct(c_out, c_out, 3, groups=c_out)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.dw3(self.pw2(self.dw2(self.pw1(self.dw1(x)))))
        return x + y if self.add else y


class CRMBottleneck(nn.Module):
    """Dilated 3×3 then 3×3, gated by sigmoid(1×1 conv of the input), plus
    the residual."""

    def __init__(self, c, dilation):
        super().__init__()
        self.cv1 = ConvBnAct(c, c, 3, dilation=dilation)
        self.cv2 = ConvBnAct(c, c, 3)
        self.gate = Conv2d(c, c, 1)

    def forward(self, x):
        return x + self.cv2(self.cv1(x)) * torch.sigmoid(self.gate(x))


class CSP(nn.Module):
    """cv1 split in halves, ``n`` chained inner blocks, cv2 over all."""

    def __init__(self, c_in, c_out, n, make_block):
        super().__init__()
        self.c = c = c_out // 2
        self.n = n
        self.cv1 = ConvBnAct(c_in, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m{i}", make_block(c))
        self.cv2 = ConvBnAct((2 + n) * c, c_out, 1)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


def c2f(c_in, c_out, n, shortcut=False, cib=False):
    return CSP(c_in, c_out, n, lambda c: CIB(c, c, shortcut) if cib else Bottleneck(c, c, shortcut))


class SCDown(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.cv1 = ConvBnAct(c_in, c_out, 1)
        self.cv2 = ConvBnAct(c_out, c_out, 3, 2, groups=c_out, act=False)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class SPPF(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.cv1 = ConvBnAct(c_in, c_in // 2, 1)
        self.cv2 = ConvBnAct(2 * c_in, c_out, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, 1))


def attention(q, k, v):
    """(B, L, H, D) softmax attention over all keys, in float32."""
    logits = matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(q.shape[-1])
    probs = torch.softmax(logits.float(), dim=-1)
    return matmul(probs, v.transpose(1, 2)).transpose(1, 2)


class PSAAttention(nn.Module):
    """Heads packed ``[q(kd) | k(kd) | v(hd)]`` in one 1×1 qkv conv, whole-row
    attention, a 3×3 depthwise positional branch over V, a 1×1 projection."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.nh, self.hd = num_heads, c // num_heads
        self.kd = self.hd // 2
        self.qkv = ConvBnAct(c, (2 * self.kd + self.hd) * num_heads, 1, act=False)
        self.pe = ConvBnAct(c, c, 3, groups=c, act=False)
        self.proj = ConvBnAct(c, c, 1, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        nh, kd, hd = self.nh, self.kd, self.hd
        per_head = self.qkv(x).permute(0, 2, 3, 1).reshape(b, h * w, nh, 2 * kd + hd)
        out = attention(per_head[..., :kd], per_head[..., kd:2 * kd], per_head[..., 2 * kd:])
        out = out.reshape(b, h, w, c).permute(0, 3, 1, 2)
        v = per_head[..., 2 * kd:].reshape(b, h, w, nh * hd).permute(0, 3, 1, 2)
        return self.proj(out + self.pe(v))


class PSA(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.c = c = c_out // 2
        self.cv1 = ConvBnAct(c_in, 2 * c, 1)
        self.attn = PSAAttention(c, max(1, c // 64))
        self.ffn1 = ConvBnAct(c, 2 * c, 1)
        self.ffn2 = ConvBnAct(2 * c, c, 1, act=False)
        self.cv2 = ConvBnAct(2 * c, c_out, 1)

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, : self.c], y[:, self.c:]
        b = b + self.attn(b)
        b = b + self.ffn2(self.ffn1(b))
        return self.cv2(torch.cat([a, b], 1))


class Backbone(nn.Module):
    def __init__(self, s):
        super().__init__()

        def crm(c, n, dilation):
            return CSP(c, c, n, lambda ci: CRMBottleneck(ci, dilation))

        c64, c128, c256, c512, c1024 = (_ch(x, s) for x in (64, 128, 256, 512, 1024))
        self.stem = ConvBnAct(3, c64, 3, 2)
        self.down2 = ConvBnAct(c64, c128, 3, 2)
        self.c2f_2 = crm(c128, _depth(3, s), 2)
        self.down3 = ConvBnAct(c128, c256, 3, 2)
        self.c2f_3 = crm(c256, _depth(6, s), 2)
        self.down4 = SCDown(c256, c512)
        self.c2f_4 = crm(c512, _depth(6, s), 4)
        self.down5 = SCDown(c512, c1024)
        self.c2fcib_5 = c2f(c1024, c1024, _depth(3, s), True, cib=True)
        self.sppf = SPPF(c1024, c1024)
        self.psa = PSA(c1024, c1024)

    def forward(self, x):
        x = self.c2f_2(self.down2(self.stem(x)))
        p3 = self.c2f_3(self.down3(x))
        p4 = self.c2f_4(self.down4(p3))
        p5 = self.psa(self.sppf(self.c2fcib_5(self.down5(p4))))
        return p3, p4, p5


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class PANNeck(nn.Module):
    def __init__(self, s):
        super().__init__()
        c256, c512, c1024 = _ch(256, s), _ch(512, s), _ch(1024, s)
        d3 = _depth(3, s)
        self.td_c2f_4 = c2f(c1024 + c512, c512, d3)
        self.td_c2f_3 = c2f(c512 + c256, c256, d3)
        self.bu_down_3 = ConvBnAct(c256, c256, 3, 2)
        self.bu_c2fcib_4 = c2f(c256 + c512, c512, d3, True, cib=True)
        self.bu_down_4 = SCDown(c512, c512)
        self.bu_c2fcib_5 = c2f(c512 + c1024, c1024, d3, True, cib=True)

    def forward(self, p3, p4, p5):
        n4 = self.td_c2f_4(torch.cat([_up(p5), p4], 1))
        n3 = self.td_c2f_3(torch.cat([_up(n4), p3], 1))
        m4 = self.bu_c2fcib_4(torch.cat([self.bu_down_3(n3), n4], 1))
        m5 = self.bu_c2fcib_5(torch.cat([self.bu_down_4(m4), p5], 1))
        return n3, m4, m5


class DetectHead(nn.Module):
    def __init__(self, num_classes, channels):
        super().__init__()
        self.levels = len(channels)
        c2 = max(16, channels[0] // 4, REG_MAX * 4)
        c3 = max(channels[0], min(num_classes, 100))
        for i, ch in enumerate(channels):
            for name, layer in {
                f"reg{i}_cv1": ConvBnAct(ch, c2, 3), f"reg{i}_cv2": ConvBnAct(c2, c2, 3),
                f"reg{i}_out": Conv2d(c2, 4 * REG_MAX, 1),
                f"cls{i}_dw1": ConvBnAct(ch, ch, 3, groups=ch), f"cls{i}_pw1": ConvBnAct(ch, c3, 1),
                f"cls{i}_dw2": ConvBnAct(c3, c3, 3, groups=c3), f"cls{i}_pw2": ConvBnAct(c3, c3, 1),
                f"cls{i}_out": Conv2d(c3, num_classes, 1),
            }.items():
                self.add_module(name, layer)

    def forward(self, feats):
        out = []
        for i, f in enumerate(feats):
            reg, cls = f, f
            for name in ("cv1", "cv2", "out"):
                reg = getattr(self, f"reg{i}_{name}")(reg)
            for name in ("dw1", "pw1", "dw2", "pw2", "out"):
                cls = getattr(self, f"cls{i}_{name}")(cls)
            out.append((reg, cls))
        return out


class DocLayoutYOLO(nn.Module):
    """``forward(views (B, S, S, 3) in [0, 1])`` → per level ``(reg, cls)``
    maps, NHWC."""

    def __init__(self, num_classes=10, variant="m"):
        super().__init__()
        s = SCALES[variant]
        self.backbone = Backbone(s)
        self.neck = PANNeck(s)
        self.head = DetectHead(num_classes, (_ch(256, s), _ch(512, s), _ch(1024, s)))

    def forward(self, images):
        levels = self.head(self.neck(*self.backbone(images.permute(0, 3, 1, 2))))
        return [(r.permute(0, 2, 3, 1), c.permute(0, 2, 3, 1)) for r, c in levels]


def decode_all(levels):
    """Every anchor of every view: ``(boxes (B, A, 4) in view pixels,
    best score (B, A), best class (B, A))``."""
    regs, clss, points, strides = [], [], [], []
    for (reg, cls), s in zip(levels, STRIDES):
        b, h, w, _ = reg.shape
        regs.append(reg.reshape(b, h * w, -1))
        clss.append(cls.reshape(b, h * w, -1))
        ys, xs = torch.meshgrid(torch.arange(h, device=reg.device, dtype=torch.float32),
                                torch.arange(w, device=reg.device, dtype=torch.float32),
                                indexing="ij")
        points.append(torch.stack([(xs + 0.5) * s, (ys + 0.5) * s], -1).reshape(-1, 2))
        strides.append(torch.full((h * w, 1), float(s), device=reg.device))
    reg, cls = torch.cat(regs, 1), torch.cat(clss, 1)
    points, strides = torch.cat(points), torch.cat(strides)
    probs = torch.softmax(reg.reshape(*reg.shape[:-1], 4, REG_MAX).float(), -1)
    dist = (probs * torch.arange(REG_MAX, device=reg.device, dtype=torch.float32)).sum(-1)
    boxes = torch.cat([points - dist[..., :2] * strides, points + dist[..., 2:] * strides], -1)
    score, klass = torch.sigmoid(cls.float()).max(-1)
    return boxes, score, klass


def iou(a, b):
    """``(N, 4)`` × ``(M, 4)`` xyxy → ``(N, M)``."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp_min(0).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), torch.zeros_like(union))


def greedy_nms(boxes, scores, classes, threshold, class_aware):
    """Indices kept by greedy NMS in descending score order (ties: lower
    index first)."""
    order = torch.sort(scores, descending=True, stable=True)[1]
    over = iou(boxes[order], boxes[order]) > threshold
    if class_aware:
        c = classes[order]
        over &= c[:, None] == c[None, :]
    over = over.cpu().numpy()
    alive = np.ones(len(order), bool)
    for i in range(len(order)):
        if alive[i]:
            alive[i + 1:] &= ~over[i, i + 1:]
    return order[torch.from_numpy(np.nonzero(alive)[0]).to(order.device)]


# ----------------------------------------------------------------------------
# views and crops
# ----------------------------------------------------------------------------


def grid_bounds(width, height, grids, overlap):
    """Integer ``(x0, y0, x1, y1)`` of the full page and each grid cell, the
    overlap a percentage of the cell on internal edges."""
    bounds = [(0, 0, width, height)]
    for rows, cols in grids:
        bw, bh = width / cols, height / rows
        ox, oy = bw * overlap / 100, bh * overlap / 100
        for r in range(rows):
            for c in range(cols):
                x0 = c * bw - (ox if c > 0 else 0)
                y0 = r * bh - (oy if r > 0 else 0)
                x1 = (c + 1) * bw + (ox if c < cols - 1 else 0)
                y1 = (r + 1) * bh + (oy if r < rows - 1 else 0)
                bounds.append((int(max(0, x0)), int(max(0, y0)), int(min(width, x1)),
                               int(min(height, y1))))
    return bounds


def interp_matrix(n_in, n_out, device):
    """Half-pixel-centre, edge-clamped bilinear weights ``(n_out, n_in)``."""
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = torch.floor(src)
    frac = (src - lo).float()
    lo = lo.long()
    m = torch.zeros(n_out, n_in)
    rows = torch.arange(n_out)
    m.index_put_((rows, lo.clamp(0, n_in - 1)), 1 - frac, accumulate=True)
    m.index_put_((rows, (lo + 1).clamp(0, n_in - 1)), frac, accumulate=True)
    return m.to(device)


def letterbox_views(page, bounds, size, pad=114.0):
    """Each view resized aspect-preserving (scale ``min(S/h, S/w)``, size
    rounded) onto a ``pad`` canvas at ``//2`` offsets. Returns (views (V, S,
    S, 3) in pixels, per view (1/scale, x offset, y offset) to map view
    pixels back to page pixels)."""
    views, affine = [], []
    for x0, y0, x1, y1 in bounds:
        h, w = y1 - y0, x1 - x0
        s = min(size / h, size / w)
        nh, nw = int(round(h * s)), int(round(w * s))
        top, left = (size - nh) // 2, (size - nw) // 2
        crop = page[y0:y1, x0:x1].float()
        resized = torch.einsum("oh,hwc,pw->opc", interp_matrix(h, nh, page.device), crop,
                               interp_matrix(w, nw, page.device))
        canvas = torch.full((size, size, page.shape[2]), pad, device=page.device)
        canvas[top:top + nh, left:left + nw] = resized
        views.append(canvas)
        affine.append((1.0 / s, x0 - left / s, y0 - top / s))
    return torch.stack(views), affine


def crop_resize(page, boxes, size):
    """Bilinear, border-clamped crops of ``boxes`` (xyxy page pixels)
    resized to ``size``×``size``: ``(N, S, S, 3)`` pixels."""
    h, w = page.shape[:2]
    img = page.float()
    idx = (torch.arange(size, device=page.device, dtype=torch.float32) + 0.5) / size
    out = []
    for x1, y1, x2, y2 in boxes.float().tolist():
        ch, cw = max(y2 - y1, 1.0), max(x2 - x1, 1.0)
        sy = (y1 + idx * ch - 0.5).clamp(0, h - 1)
        sx = (x1 + idx * cw - 0.5).clamp(0, w - 1)
        wy = 1 - (sy[:, None] - torch.arange(h, device=page.device)).abs()
        wx = 1 - (sx[:, None] - torch.arange(w, device=page.device)).abs()
        out.append(torch.einsum("oh,hwc,pw->opc", wy.clamp_min(0), img, wx.clamp_min(0)))
    return torch.stack(out)


# ----------------------------------------------------------------------------
# ViT tower
# ----------------------------------------------------------------------------


class Dense(nn.Module):
    def __init__(self, n_in, n_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out))
        self.bias = nn.Parameter(torch.zeros(n_out)) if bias else None

    def forward(self, x):
        y = matmul(x, self.weight)
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    def __init__(self, n, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.h, self.d = heads, width // heads
        self.q, self.k, self.v = (Dense(width, width, False) for _ in range(3))
        self.o = Dense(width, width, False)

    def forward(self, x):
        b, l, _ = x.shape
        q, k, v = (m(x).view(b, l, self.h, self.d) for m in (self.q, self.k, self.v))
        return self.o(attention(q, k, v).reshape(b, l, -1))


class MLP(nn.Module):
    def __init__(self, width, hidden):
        super().__init__()
        self.fc1, self.fc2 = Dense(width, hidden), Dense(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, width, heads, mlp_ratio):
        super().__init__()
        self.ln1, self.ln2 = LayerNorm(width), LayerNorm(width)
        self.attn = Attention(width, heads)
        self.mlp = MLP(width, int(width * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViTower(nn.Module):
    """Patch conv, learned positions, pre-LN blocks, final LN, mean pool,
    projection, L2 normalisation: ``(B, S, S, 3)`` in [0, 1] → ``(B, E)``."""

    def __init__(self, image_size, patch, width, layers, heads, mlp_ratio, embed_dim):
        super().__init__()
        self.layers = layers
        self.patch_embed = Conv2d(3, width, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.empty(1, (image_size // patch) ** 2, width))
        for i in range(layers):
            self.add_module(f"block{i}", Block(width, heads, mlp_ratio))
        self.final_ln = LayerNorm(width)
        self.proj = Dense(width, embed_dim)

    def forward(self, images):
        x = self.patch_embed(images.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        x = x + self.pos_embed
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        out = self.proj(self.final_ln(x).mean(1))
        return out / out.norm(dim=-1, keepdim=True).clamp_min(1e-12)


# ----------------------------------------------------------------------------
# the page
# ----------------------------------------------------------------------------


def views_and_affine(page, cfg):
    """The page's letterboxed views in [0, 1] and the per-view map back to
    page pixels, for ``page`` (H, W, 3) as the program receives it."""
    h, w = page.shape[:2]
    bounds = grid_bounds(w, h, cfg["grids"], cfg["overlap"])
    views, affine = letterbox_views(page, bounds, cfg["imgsz"])
    return views / 255.0, affine, bounds


def detect_candidates(detector, page, cfg, chunk=6):
    """Every anchor of every view in page pixels: ``(boxes (V·A, 4), scores
    (V·A,), classes (V·A,), view (V·A,))`` and the per-view top ``max_det``
    decoded the same way, for the full selection."""
    views, affine, bounds = views_and_affine(page, cfg)
    outs = []
    for i in range(0, views.shape[0], chunk):
        outs.append(decode_all(detector(views[i:i + chunk])))
    boxes, scores, classes = (torch.cat(x) for x in zip(*outs))
    a = torch.tensor(affine, device=page.device, dtype=torch.float32)
    s, ox, oy = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    page_boxes = torch.stack([boxes[..., 0] * s + ox, boxes[..., 1] * s + oy,
                              boxes[..., 2] * s + ox, boxes[..., 3] * s + oy], -1)
    return page_boxes, scores, classes, bounds


def select_regions(page_boxes, scores, classes, bounds, page_hw, cfg):
    """The program's selection rule on per-view candidates: per view the top
    ``max_det`` by score over ``conf``, greedy class-agnostic NMS at
    ``view_iou``; with ``edge_filter``, boxes within 10 px of an internal
    cell edge dropped; the
    class-aware cross-view NMS at ``combine_iou`` over the ``cap·K``
    strongest; the top ``K``. Returns (boxes, scores, classes)."""
    h, w = page_hw
    kept_b, kept_s, kept_c = [], [], []
    for v in range(page_boxes.shape[0]):
        sc, idx = torch.sort(scores[v], descending=True, stable=True)
        idx = idx[: cfg["max_det"]][sc[: cfg["max_det"]] >= cfg["conf"]]
        keep = idx[greedy_nms(page_boxes[v, idx], scores[v, idx], classes[v, idx],
                              cfg["view_iou"], False)]
        b = page_boxes[v, keep]
        x0, y0, x1, y1 = bounds[v]
        t = 10.0
        drop = torch.zeros(len(keep), dtype=torch.bool, device=b.device)
        if cfg.get("edge_filter", True):
            if abs(x1 - w) > t:
                drop |= b[:, 2] >= x1 - t
            if abs(y1 - h) > t:
                drop |= b[:, 3] >= y1 - t
            if x0 > t:
                drop |= b[:, 0] <= x0 + t
            if y0 > t:
                drop |= b[:, 1] <= y0 + t
        kept_b.append(b[~drop])
        kept_s.append(scores[v, keep][~drop])
        kept_c.append(classes[v, keep][~drop])
    b, s, c = torch.cat(kept_b), torch.cat(kept_s), torch.cat(kept_c)
    k = cfg["regions"]
    top = torch.sort(s, descending=True, stable=True)[1][: cfg["cap"] * k]
    keep = top[greedy_nms(b[top], s[top], c[top], cfg["combine_iou"], True)][:k]
    return b[keep], s[keep], c[keep]
