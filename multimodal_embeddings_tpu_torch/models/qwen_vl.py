"""The Qwen2.5-VL document-parsing model, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/qwen_vl.py`` (the reference
notebook's ``QWEN2_5_document_parsing.ipynb``, which turns a page into
"QwenVL HTML"):

* the vision tower: a 14-px patch convolution without bias, blocks of
  FastLayerNorm → fused qkv → 2-D rotary embedding → window attention over
  8×8-patch windows (the grid padded to whole windows, pad keys masked, pad
  queries dropped) or full attention in ``fullatt_block_indexes``, an output
  projection and a GELU MLP, a final LayerNorm and the 2×2 patch merger into
  the text width;
* the text decoder: Qwen2 blocks (RMSNorm, q/k/v with bias, GQA, M-RoPE,
  SwiGLU), whose input splices the k-th vision token into the k-th
  ``image_pad_id`` slot;
* greedy generation with a static KV cache: a prefill that keeps the last
  position's logits, then one token per step with both of the JAX loop forms
  (the fixed-length ``scan`` and the early-exit ``while_loop``), identical
  tokens.

Attention runs through ``models/transformer.py::sdpa``, which picks K4
(flash attention) for the full-attention vision blocks at L ≥ 2048 and K1
(the whole-row kernel) for those at L ∈ [256, 1664], as the JAX package does
on a TPU; ``quantize`` = True/``"int8"``/``"int4"`` stores every decoder
projection and the ``lm_head`` int8 (K2) or packed int4 (K3). The configs
mirror the JAX ones field for field, and module and parameter names follow
the JAX scopes, so ``models/weights.py`` bridges a JAX tree by path.

Generation differs from JAX only in form: PyTorch runs the loop eagerly on
the host, one device flag read per step for the early exit, and the decode
step writes the KV cache in place (the JAX arrays are immutable; in place
saves a cache copy per layer per step). ``decode_step`` takes the cache
position as JAX's does: a Python int, a 0-d tensor (every row at one depth;
the generate loops pass ``prompt_len + t`` so, with no host read), or a
``(B,)`` tensor of per-row depths (continuous batching,
``models/qwen_serve.py``). Each form becomes per-row depths: each row writes
its k/v at its own slot by a device-side scatter and sees the slots ``<=
position[row]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.models.mme5 import Embed
from multimodal_embeddings_tpu_torch.models.transformer import (
    Dense,
    FastLayerNorm,
    GeluMLP,
    RMSNorm,
    SwiGLU,
    _dense,
    apply_rope,
    sdpa,
)

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class QwenVisionConfig:
    patch_size: int = 14
    merge_size: int = 2  # 2x2 patch merging into one text token
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: float = 4.0
    # window attention over window_size-pixel windows except in the listed
    # full-attention blocks; None disables windowing
    window_size: Optional[int] = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    rope_theta: float = 10000.0


@dataclasses.dataclass(frozen=True)
class QwenTextConfig:
    vocab_size: int = 151936
    hidden: int = 3584
    layers: int = 28
    heads: int = 28
    kv_heads: int = 4
    head_dim: int = 128
    mlp_hidden: int = 18944
    max_len: int = 4096
    rope_theta: float = 1000000.0
    # M-RoPE frequency sections of the temporal/height/width streams
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    kv_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class QwenVLConfig:
    vision: QwenVisionConfig = dataclasses.field(default_factory=QwenVisionConfig)
    text: QwenTextConfig = dataclasses.field(default_factory=QwenTextConfig)
    image_pad_id: int = 151655  # <|image_pad|>
    eos_id: int = 151645  # <|im_end|>
    # decoder projections + lm_head storage: False | True/"int8" | "int4";
    # the vision tower stays float
    quantize: Any = False

    @classmethod
    def qwen25_vl_7b(cls) -> "QwenVLConfig":
        return cls()

    @classmethod
    def qwen25_vl_3b(cls) -> "QwenVLConfig":
        return cls(
            text=QwenTextConfig(hidden=2048, layers=36, heads=16, kv_heads=2, mlp_hidden=11008)
        )

    @classmethod
    def qwen25_vl_32b(cls) -> "QwenVLConfig":
        """The notebook's flagship: hidden 5120, 64 layers, 40 query / 8 KV
        heads of 128, SwiGLU 27648, a 152064-token vocabulary."""
        return cls(
            text=QwenTextConfig(
                vocab_size=152064, hidden=5120, layers=64, heads=40, kv_heads=8,
                mlp_hidden=27648,
            )
        )

    @classmethod
    def qwen25_vl_7b_int8(cls) -> "QwenVLConfig":
        return dataclasses.replace(cls.qwen25_vl_7b(), quantize=True)

    @classmethod
    def qwen25_vl_3b_int8(cls) -> "QwenVLConfig":
        return dataclasses.replace(cls.qwen25_vl_3b(), quantize=True)

    @classmethod
    def qwen25_vl_3b_int4(cls) -> "QwenVLConfig":
        return dataclasses.replace(cls.qwen25_vl_3b(), quantize="int4")

    @classmethod
    def qwen25_vl_32b_int8(cls) -> "QwenVLConfig":
        return dataclasses.replace(cls.qwen25_vl_32b(), quantize=True)

    @classmethod
    def qwen25_vl_32b_int4(cls) -> "QwenVLConfig":
        """The notebook's 4-bit flagship storage: one H100 holds it whole
        (~20 GB of parameters)."""
        return dataclasses.replace(cls.qwen25_vl_32b(), quantize="int4")

    @classmethod
    def tiny(cls) -> "QwenVLConfig":
        return cls(
            vision=QwenVisionConfig(patch_size=14, merge_size=2, width=32, layers=2, heads=2),
            text=QwenTextConfig(
                vocab_size=512, hidden=64, layers=2, heads=4, kv_heads=2, head_dim=16,
                mlp_hidden=128, max_len=128, mrope_section=(2, 3, 3),
            ),
            image_pad_id=5,
            eos_id=2,
        )


def vision_rope_2d(gh: int, gw: int, head_dim: int, theta: float = 10000.0, device=None):
    """2-D rotary tables: for patch (i, j) the angles are
    ``[row_freqs(i) | col_freqs(j)]`` of length head_dim/2 (computed in f64,
    stored f32). Returns (cos, sin) of shape (gh·gw, head_dim/2),
    row-major patch order."""
    dim = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    hfreqs = np.outer(np.arange(gh, dtype=np.float64), inv_freq)
    wfreqs = np.outer(np.arange(gw, dtype=np.float64), inv_freq)
    ang = np.concatenate(
        [
            np.broadcast_to(hfreqs[:, None, :], (gh, gw, hfreqs.shape[1])),
            np.broadcast_to(wfreqs[None, :, :], (gh, gw, wfreqs.shape[1])),
        ],
        axis=-1,
    ).reshape(gh * gw, head_dim // 2)
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(device)
    return cos, sin


def window_attention(q, k, v, gh: int, gw: int, win: int) -> torch.Tensor:
    """Attention within win×win patch windows of the (gh, gw) grid. q/k/v:
    (B, gh·gw, H, D), row-major patches, rotary already applied. The grid is
    padded to whole windows; pad keys are masked and pad queries dropped."""
    b, length, h, d = q.shape
    nwh, nww = -(-gh // win), -(-gw // win)
    ph, pw = nwh * win - gh, nww * win - gw

    def part(x):
        x = x.reshape(b, gh, gw, h, x.shape[-1])
        x = F.pad(x, (0, 0, 0, 0, 0, pw, 0, ph))
        x = x.reshape(b, nwh, win, nww, win, h, x.shape[-1]).permute(0, 1, 3, 2, 4, 5, 6)
        return x.reshape(b * nwh * nww, win * win, h, x.shape[-1])

    mask = None
    if ph or pw:
        valid = F.pad(torch.ones(gh, gw, dtype=torch.bool, device=q.device), (0, pw, 0, ph))
        valid = valid.reshape(nwh, win, nww, win).transpose(1, 2).reshape(nwh * nww, win * win)
        mask = valid[None].expand(b, -1, -1).reshape(b * nwh * nww, 1, 1, win * win)
    out = sdpa(part(q), part(k), part(v), mask=mask)
    dv = out.shape[-1]
    out = out.reshape(b, nwh, nww, win, win, h, dv).permute(0, 1, 3, 2, 4, 5, 6)
    out = out.reshape(b, nwh * win, nww * win, h, dv)[:, :gh, :gw]
    return out.reshape(b, length, h, dv)


def mrope_tables(position_ids: torch.Tensor, head_dim: int, theta: float,
                 sections: Tuple[int, int, int]):
    """M-RoPE (cos, sin) of shape (B, L, head_dim/2) from the (3, B, L)
    t/h/w position streams: frequency f rotates by the position of the
    stream whose section holds f."""
    d2 = head_dim // 2
    if sum(sections) != d2:
        raise ValueError(f"sections {sections} do not sum to {d2}")
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    axis_of = np.concatenate([np.full(s, i, np.int64) for i, s in enumerate(sections)])
    dev = position_ids.device
    pos = position_ids[torch.from_numpy(axis_of).to(dev)]  # (d2, B, L)
    ang = pos.permute(1, 2, 0).float() * torch.from_numpy(inv_freq.astype(np.float32)).to(dev)
    return torch.cos(ang), torch.sin(ang)


def apply_rope_batched(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding with per-batch tables: x (B, L, H, D),
    cos/sin (B, L, D/2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def qwen_mrope_position_ids(
    token_ids: torch.Tensor,  # (B, L)
    image_pad_id: int,
    grid_hw: Optional[Tuple[int, int]],  # the MERGED vision grid (gh', gw')
):
    """(t, h, w) position streams for sequences with at most one contiguous
    image span: text advances all three together, image tokens keep t at
    the span start and spread h/w over the merged grid, text after the image
    resumes at ``start + max(gh', gw')``; rows without an image take plain
    positions. Returns (position_ids (3, B, L) int32, mrope_delta (B,)
    int32), delta = (max position + 1) − L."""
    b, length = token_ids.shape
    dev = token_ids.device
    idx = torch.arange(length, device=dev)[None, :]
    if grid_hw is None:
        pos = idx.expand(b, length).to(torch.int32)
        return torch.stack([pos] * 3), torch.zeros(b, dtype=torch.int32, device=dev)
    gh, gw = grid_hw
    is_pad = token_ids == image_pad_id
    has = is_pad.any(dim=1)
    first = is_pad.int().argmax(dim=1)  # first pad (0 when none)
    npad = is_pad.sum(dim=1)
    rank = is_pad.cumsum(dim=1) - 1
    row = torch.div(rank, gw, rounding_mode="floor")
    col = torch.remainder(rank, gw)
    end = (first + npad)[:, None]
    after = idx >= end
    after_pos = first[:, None] + max(gh, gw) + (idx - end)
    plain = idx.expand(b, length)
    t = torch.where(is_pad, first[:, None].expand(b, length), torch.where(after, after_pos, plain))
    h = torch.where(is_pad, first[:, None] + row, torch.where(after, after_pos, plain))
    w = torch.where(is_pad, first[:, None] + col, torch.where(after, after_pos, plain))
    pos = torch.stack([t, h, w]).to(torch.int32)
    pos = torch.where(has[None, :, None], pos, plain[None].to(torch.int32))
    delta = torch.where(has, first + max(gh, gw) + (length - first - npad) - length,
                        torch.zeros_like(first)).to(torch.int32)
    return pos, delta


class QwenVisionTower(nn.Module):
    """Qwen2.5-VL vision encoder: 2-D rotary positions (no learned position
    table), window attention except in ``fullatt_block_indexes``, the 2×2
    patch merger into ``out_dim``."""

    def __init__(self, config: QwenVisionConfig, out_dim: int, dtype):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        w, hd = c.width, c.width // c.heads
        self.patch_embed = nn.Conv2d(3, w, c.patch_size, stride=c.patch_size, bias=False)
        for i in range(c.layers):
            self.add_module(f"ln1_{i}", FastLayerNorm(w, dtype=dtype))
            self.add_module(f"qkv_{i}", Dense(w, 3 * w, True, (w, 3, c.heads, hd),
                                              bias_shape=(3, c.heads, hd)))
            self.add_module(f"proj_{i}", Dense(w, w, True, (c.heads, hd, w)))
            self.add_module(f"ln2_{i}", FastLayerNorm(w, dtype=dtype))
            self.add_module(f"mlp_{i}", GeluMLP(w, int(w * c.mlp_ratio), dtype=dtype))
        self.final_ln = FastLayerNorm(w, dtype=dtype)
        m2 = c.merge_size * c.merge_size
        self.merger_fc1 = Dense(m2 * w, m2 * w)
        self.merger_fc2 = Dense(m2 * w, out_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) CLIP-normalised pixels → (B, (H/p/m)·(W/p/m), out_dim)."""
        c = self.config
        x = self.patch_embed(images.to(self.dtype).permute(0, 3, 1, 2))
        b, width, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, C), row-major patches
        hd = width // c.heads
        cos, sin = vision_rope_2d(gh, gw, hd, c.rope_theta, x.device)
        win = None if c.window_size is None else max(1, c.window_size // c.patch_size)
        length = gh * gw
        for i in range(c.layers):
            h = getattr(self, f"ln1_{i}")(x)
            qkv = getattr(self, f"qkv_{i}")(h).view(b, length, 3, c.heads, hd)
            q = apply_rope(qkv[:, :, 0], cos, sin)
            k = apply_rope(qkv[:, :, 1], cos, sin)
            v = qkv[:, :, 2]
            if win is None or i in c.fullatt_block_indexes or win >= max(gh, gw):
                attn = sdpa(q, k, v)
            else:
                attn = window_attention(q, k, v, gh, gw, win)
            x = x + getattr(self, f"proj_{i}")(attn.reshape(b, length, width))
            x = x + getattr(self, f"mlp_{i}")(getattr(self, f"ln2_{i}")(x))
        x = self.final_ln(x)
        m = c.merge_size
        x = x.reshape(b, gh // m, m, gw // m, m, width).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (gh // m) * (gw // m), m * m * width)
        x = F.gelu(self.merger_fc1(x), approximate="tanh")
        return self.merger_fc2(x)


class QwenBlock(nn.Module):
    """Qwen2 decoder block: RMSNorm, GQA attention with q/k/v bias and
    M-RoPE, RMSNorm, SwiGLU; weights float, int8 or packed int4."""

    def __init__(self, config: QwenTextConfig, dtype, quantize=False):
        super().__init__()
        c = self.config = config
        hd, d = c.head_dim, c.hidden
        self.kv_dtype = _KV_DTYPES[c.kv_dtype]
        self.attn_norm = RMSNorm(d, dtype=dtype)
        self.q = _dense(d, c.heads * hd, True, (d, c.heads, hd), quantize, dtype, (c.heads, hd))
        self.k = _dense(d, c.kv_heads * hd, True, (d, c.kv_heads, hd), quantize, dtype,
                        (c.kv_heads, hd))
        self.v = _dense(d, c.kv_heads * hd, True, (d, c.kv_heads, hd), quantize, dtype,
                        (c.kv_heads, hd))
        self.o = _dense(c.heads * hd, d, False, (c.heads, hd, d), quantize, dtype)
        self.mlp_norm = RMSNorm(d, dtype=dtype)
        self.mlp = SwiGLU(d, c.mlp_hidden, quantize, dtype)

    def forward(self, x, cos, sin, mask=None, cache=None, index=None):
        """Prefill (``index`` None): causal attention over x, returns
        (x, (k, v) in the cache dtype). Decode (x one token per row): writes
        each row's k/v in place at its (row, slot) pair of ``index`` and
        attends over the keys ``mask`` shows; returns (x, cache).
        ``QwenVLModel.decode_step`` makes both once per step."""
        c = self.config
        b, l, _ = x.shape
        h = self.attn_norm(x)
        q = self.q(h).view(b, l, c.heads, c.head_dim)
        k = self.k(h).view(b, l, c.kv_heads, c.head_dim)
        v = self.v(h).view(b, l, c.kv_heads, c.head_dim)
        q = apply_rope_batched(q, cos, sin)
        k = apply_rope_batched(k, cos, sin)
        if index is None:
            new_cache = (k.to(self.kv_dtype), v.to(self.kv_dtype))
            attn = sdpa(q, k, v, mask=mask, causal=True)
        else:
            k_cache, v_cache = cache
            k_cache[index] = k[:, 0].to(k_cache.dtype)
            v_cache[index] = v[:, 0].to(v_cache.dtype)
            new_cache = (k_cache, v_cache)
            attn = sdpa(q, k_cache, v_cache, mask=mask)
        x = x + self.o(attn.reshape(b, l, c.heads * c.head_dim))
        x = x + self.mlp(self.mlp_norm(x))
        return x, new_cache


class QwenVLModel(nn.Module):
    """The VLM: token embedding with the vision tokens spliced into the
    image-pad slots, the decoder, ``final_norm`` and ``lm_head``."""

    def __init__(self, config: QwenVLConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        t = config.text
        self.vision = QwenVisionTower(config.vision, t.hidden, dtype)
        self.tok_embed = Embed(t.vocab_size, t.hidden, dtype)
        for i in range(t.layers):
            self.add_module(f"layer{i}", QwenBlock(t, dtype, config.quantize))
        self.final_norm = RMSNorm(t.hidden, dtype=dtype)
        self.lm_head = _dense(t.hidden, t.vocab_size, False, None, config.quantize, dtype)

    @property
    def blocks(self) -> List[QwenBlock]:
        return [getattr(self, f"layer{i}") for i in range(self.config.text.layers)]

    def merged_grid(self, images) -> Optional[Tuple[int, int]]:
        if images is None:
            return None
        m = self.config.vision.patch_size * self.config.vision.merge_size
        return int(images.shape[1]) // m, int(images.shape[2]) // m

    def mrope(self, position_ids):
        t = self.config.text
        return mrope_tables(position_ids, t.head_dim, t.rope_theta, t.mrope_section)

    def embed_multimodal(self, token_ids: torch.Tensor, images: Optional[torch.Tensor]):
        """Token embeddings with the k-th vision token in the k-th
        ``image_pad_id`` slot."""
        x = self.tok_embed(token_ids)
        if images is None:
            return x
        vis = self.vision(images)  # (B, T, hidden)
        is_pad = token_ids == self.config.image_pad_id
        rank = (is_pad.cumsum(dim=1) - 1).clamp(0, vis.shape[1] - 1)
        gathered = torch.gather(vis, 1, rank[..., None].expand(-1, -1, vis.shape[2]))
        return torch.where(is_pad[..., None], gathered.to(x.dtype), x)

    def forward(
        self,
        token_ids: torch.Tensor,
        images: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        cache_len: Optional[int] = None,
        last_only: bool = False,
    ):
        """Prefill: (logits, KV caches padded to ``cache_len`` (default
        ``max_len``), mrope_delta (B,)). ``last_only`` computes the
        ``lm_head`` on the final position only."""
        t = self.config.text
        x = self.embed_multimodal(token_ids, images)
        position_ids, delta = qwen_mrope_position_ids(
            token_ids, self.config.image_pad_id, self.merged_grid(images)
        )
        cos, sin = self.mrope(position_ids)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        caches = []
        for block in self.blocks:
            x, (k, v) = block(x, cos, sin, mask=mask)
            pad = (cache_len or t.max_len) - k.shape[1]
            caches.append((F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad))))
        if last_only:
            x = x[:, -1:]
        return self.lm_head(self.final_norm(x)), caches, delta

    def decode_step(self, token_ids: torch.Tensor, caches, position,
                    mrope_delta: Optional[torch.Tensor] = None):
        """One cached step: token_ids (B, 1) at cache slot ``position`` — a
        Python int or a 0-d tensor (all rows at one depth), or a (B,) int
        tensor (per-row depths, continuous batching); the rotary angle uses
        ``position + mrope_delta``. Every form is broadcast to (B,) depths:
        row r writes its k/v at (r, depth[r]) by a device-side scatter and
        sees the slots ``<= depth[r]``. The caches are updated in place and
        returned."""
        x = self.tok_embed(token_ids)
        b = token_ids.shape[0]
        if torch.is_tensor(position):
            pos = torch.broadcast_to(position.to(device=x.device, dtype=torch.int32), (b,))
        else:
            pos = torch.full((b,), position, dtype=torch.int32, device=x.device)
        slots = torch.arange(caches[0][0].shape[1], device=x.device)
        mask = slots[None, None, None, :] <= pos[:, None, None, None]
        index = (torch.arange(b, device=x.device), pos.long())
        if mrope_delta is not None:
            pos = pos + mrope_delta
        cos, sin = self.mrope(pos[None, :, None].expand(3, b, 1))
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            x, cache = block(x, cos, sin, mask=mask, cache=cache, index=index)
            new_caches.append(cache)
        return self.lm_head(self.final_norm(x)), new_caches


def build_generate_fns(
    model: QwenVLModel,
    prompt_len: int,
    max_new_tokens: int,
    early_stop: bool = True,
    prefill_chunk: int = 0,
):
    """(prefill, decode) for greedy generation, as the JAX pair:

    ``prefill(tokens, imgs) -> (last_logits, caches, delta)``, by
    ``prefill_chunk`` rows at a time when set (rows are independent);
    ``decode(last_logits, caches, delta, force_steps=None) -> (B, T)``.
    Output position 0 is the prefill's argmax; step t feeds the token at
    cache slot ``prompt_len + t``; rows that emitted EOS stay EOS. The fixed
    form runs all ``max_new_tokens`` steps (the JAX ``scan``); ``early_stop``
    leaves the loop once every row is done (the JAX ``while_loop``, one
    device flag read per step). ``force_steps`` (B,) forces EOS from that
    output position on."""
    eos = model.config.eos_id
    # the static KV allocation: prompt + generation rounded up to 128
    cache_len = min(model.config.text.max_len, -(-(prompt_len + max_new_tokens) // 128) * 128)

    @torch.inference_mode()
    def prefill_one(tokens, imgs):
        logits, caches, delta = model(tokens, imgs, cache_len=cache_len, last_only=True)
        return logits[:, -1], caches, delta

    def prefill(tokens, imgs):
        b = tokens.shape[0]
        c = prefill_chunk
        if not c or c <= 0 or b <= c:
            return prefill_one(tokens, imgs)
        if b % c:
            raise ValueError(f"batch {b} not divisible by prefill_chunk {c}")
        parts = [
            prefill_one(tokens[i : i + c], None if imgs is None else imgs[i : i + c])
            for i in range(0, b, c)
        ]
        logits = torch.cat([p[0] for p in parts])
        caches = [
            (torch.cat([p[1][i][0] for p in parts]), torch.cat([p[1][i][1] for p in parts]))
            for i in range(len(parts[0][1]))
        ]
        return logits, caches, torch.cat([p[2] for p in parts])

    def first_token(last_logits, force_steps):
        tok = last_logits.argmax(dim=-1).to(torch.int32)
        if force_steps is not None:
            tok = torch.where(force_steps <= 0, torch.full_like(tok, eos), tok)
        return tok

    def advance(token, caches, done, delta, t, positions, force_steps):
        # step t feeds cache slot prompt_len + t as a 0-d device tensor, a
        # view into ``positions``: no host-to-device copy per step
        logits, caches = model.decode_step(token[:, None], caches, positions[t], delta)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        if force_steps is not None:
            nxt = torch.where(t + 1 >= force_steps, torch.full_like(nxt, eos), nxt)
        nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
        return nxt, caches, done | (nxt == eos)

    def cache_slots(device):
        return torch.arange(prompt_len, prompt_len + max_new_tokens, dtype=torch.int32,
                            device=device)

    @torch.inference_mode()
    def decode(last_logits, caches, delta, force_steps=None):
        token = first_token(last_logits, force_steps)
        done = token == eos
        positions = cache_slots(token.device)
        out = []
        for t in range(max_new_tokens):
            out.append(token)
            token, caches, done = advance(token, caches, done, delta, t, positions, force_steps)
        return torch.stack(out, dim=1)

    @torch.inference_mode()
    def decode_early(last_logits, caches, delta, force_steps=None):
        token = first_token(last_logits, force_steps)
        b = token.shape[0]
        out = torch.full((b, max_new_tokens), eos, dtype=torch.int32, device=token.device)
        done = token == eos
        positions = cache_slots(token.device)
        t = 0
        while t < max_new_tokens and not bool(done.all()):
            out[:, t] = token
            token, caches, done = advance(token, caches, done, delta, t, positions, force_steps)
            t += 1
        return out

    return prefill, (decode_early if early_stop else decode)


def greedy_generate(
    model: QwenVLModel,
    token_ids,
    images=None,
    max_new_tokens: int = 128,
    early_stop: bool = True,
    prefill_chunk: int = 0,
) -> np.ndarray:
    """Greedy decoding with a static KV cache on the model's device: token
    ids (B, L) and images (B, H, W, 3) as numpy arrays or tensors →
    (B, max_new_tokens) int32 numpy, EOS after the first EOS."""
    device = next(model.parameters()).device
    prompt = torch.as_tensor(np.asarray(token_ids), dtype=torch.long).to(device)
    b, prompt_len = prompt.shape
    if prompt_len + max_new_tokens > model.config.text.max_len:
        raise ValueError(
            f"prompt_len {prompt_len} + max_new_tokens {max_new_tokens} exceeds "
            f"max_len {model.config.text.max_len}"
        )
    imgs = None
    if images is not None:
        imgs = torch.as_tensor(np.asarray(images, np.float32)).to(device)
    prefill, decode = build_generate_fns(
        model, prompt_len, max_new_tokens, early_stop=early_stop, prefill_chunk=prefill_chunk
    )
    last_logits, caches, delta = prefill(prompt, imgs)
    return decode(last_logits, caches, delta).cpu().numpy()

