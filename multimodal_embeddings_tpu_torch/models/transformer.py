"""Transformer primitives of the ViT and Mllama towers, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/transformer.py``: ``RMSNorm``,
``FastLayerNorm``, the RoPE tables, ``sdpa``, ``Attention``, ``SwiGLU``,
``GeluMLP``, ``EncoderBlock``, ``GatedEncoderBlock``, ``LlamaBlock``,
``CrossAttentionBlock`` and ``last_token_pool``. Dense weights are stored as
the JAX package stores them, ``(in, out)`` with the JAX kernel's axes
flattened, and applied as ``x @ W``; a bias keeps the JAX bias's shape
(``(3, H, D)`` for a fused qkv projection) and is flattened at use.
``quantize`` swaps in the int8 ``Int8Dense`` or the packed-int4
``Int4Dense`` (``models/quantized.py``). ``models/weights.py`` converts.

The JAX package's opt-in kernel routes run here too:

* ``EncoderBlock(fuse_ln=True | "attn" | "mlp")`` fuses a pre-LN into the
  next projection — ln1 into one ``[Wq|Wk|Wv]`` product, ln2 into fc1 with
  its bias — through K6 (``kernels/ln_matmul.py``), for a bf16 block input
  of width divisible by 128 that is not quantized, as JAX gates it;
* ``MMTPU_LN_STATS=1``: ``FastLayerNorm``'s statistics of a 3-D input with
  a length divisible by 8 through K7 (``kernels/ln_stats.py``);
* ``MMTPU_ENC_ATTN_BLHD=1``: ``sdpa``'s whole-row route through
  ``encoder_attention_blhd`` where the JAX package takes its BLHD kernel.

Three routes are on by default, as in the JAX package, and a variable set
to ``"0"`` opts out of each (A/B hygiene):

* ``MMTPU_ENC_ATTN=0``: ``sdpa``'s whole-row K1 dispatch is off, so a key
  prefix becomes a key mask and unmasked self-attention takes the XLA-path
  numerics (``Attention``'s prefix call goes through ``sdpa`` for it);
* ``MMTPU_ENC_ATTN_BLF=0``: ``Attention`` leaves the BLF route
  (``encoder_attention_blf``) for the proj-BHLD route;
* ``MMTPU_ENC_ATTN_PROJ=0``: ``Attention`` leaves the proj-BHLD route for
  the generic one through ``sdpa``.

``MMTPU_F32_LOGITS=1`` makes ``sdpa``'s XLA path compute bf16 q·k with an
f32 result instead of rounding the logits to bf16, as JAX does.

Every variable is read at call time, by ``_switch`` or ``_opted_out``.

Types follow the JAX modules: ``dtype`` is the compute type that norms
cast their output to and int8 projections run in; a float Dense computes
in its weight's type. Gates and norm scales are kept in f32 (see
``models/quantized.py::storage_dtype``), so ``x + tanh(gate)·h`` promotes
to f32 exactly where the JAX modules do.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.kernels.encoder_attention import (
    blhd_supported,
    encoder_attention,
    encoder_attention_blf,
    encoder_attention_blhd,
)
from multimodal_embeddings_tpu_torch.kernels.flash_attention import flash_attention
from multimodal_embeddings_tpu_torch.kernels.ln_matmul import ln_matmul
from multimodal_embeddings_tpu_torch.kernels.ln_stats import ln_stats
from multimodal_embeddings_tpu_torch.models.quantized import quant_dense_cls

NEG_INF = -1e30


def _switch(name: str) -> bool:
    """An opt-in route of the JAX package, read at call time:
    ``MMTPU_LN_STATS``, ``MMTPU_ENC_ATTN_BLHD`` or ``MMTPU_F32_LOGITS`` set
    to ``"1"``."""
    return os.environ.get(name) == "1"


def _opted_out(name: str) -> bool:
    """A default-on kernel route of the JAX package switched off, read at
    call time: ``MMTPU_ENC_ATTN``, ``MMTPU_ENC_ATTN_BLF``,
    ``MMTPU_ENC_ATTN_PROJ`` or ``MMTPU_PSA_BLF`` set to ``"0"``."""
    return os.environ.get(name) == "0"


class Dense(nn.Module):
    """``flax.linen.Dense``/``DenseGeneral`` with the contraction and output
    axes flattened: ``x @ weight (+ bias)``, weight ``(in, out)``, computed
    in the weight's dtype. ``kernel_shape`` is the JAX kernel's shape
    (``(C, H, D)``, ``(H, D, C)``, …), which the weight bridge reads and
    writes."""

    def __init__(
        self, in_features: int, out_features: int, bias: bool = True, kernel_shape=None,
        bias_shape=None,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (out_features,))) if bias else None
        self.kernel_shape = tuple(kernel_shape or (in_features, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        b = None if self.bias is None else self.bias.reshape(-1).to(w.dtype)
        return F.linear(x.to(w.dtype), w.t(), b)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """``y``, a product with this layer's weight computed outside
        ``forward``, as the product over the whole contraction: the identity
        here; a row-parallel shard (``parallel/sharding.py``) sums it over
        the model axis."""
        return y


def _dense(in_f, out_f, bias, kernel_shape, quantize, dtype, bias_shape=None):
    """A float ``Dense``, or for ``quantize`` True/``"int8"``/``"int4"`` its
    quantized drop-in computing in ``dtype``, which carries the float
    kernel's ``kernel_shape`` too (the activation traces read it)."""
    if quantize:
        dense = quant_dense_cls(quantize)(in_f, out_f, bias=bias, dtype=dtype,
                                          bias_shape=bias_shape)
        dense.kernel_shape = tuple(kernel_shape or (in_f, out_f))
        return dense
    return Dense(in_f, out_f, bias=bias, kernel_shape=kernel_shape, bias_shape=bias_shape)


class FastLayerNorm(nn.Module):
    """LayerNorm with the JAX fallback's arithmetic: f32 statistics by the
    one-pass formula ``var = max(mean(x²) − mean², 0)``, eps 1e-6, result
    cast to ``dtype`` (the input's when None) — not ``F.layer_norm``'s
    two-pass variance. Under ``MMTPU_LN_STATS=1`` the statistics of a
    ``(B, L, D)`` input with ``L % 8 == 0`` come from K7 (``ln_stats``);
    the normalise and affine stay the same tensor code."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if _switch("MMTPU_LN_STATS") and x.dim() == 3 and x.shape[1] % 8 == 0:
            mean, rstd = ln_stats(x.contiguous(), self.eps)
        else:
            mean = xf.mean(dim=-1, keepdim=True)
            var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
            rstd = torch.rsqrt(var + self.eps)
        y = (xf - mean) * (rstd * self.scale.float()) + self.bias.float()
        return y.to(self.dtype or x.dtype)


class RMSNorm(nn.Module):
    """f32 ``x·rsqrt(mean(x²) + eps)·scale``, eps 1e-5, cast to ``dtype``
    (the input's when None)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.scale.float()).to(self.dtype or x.dtype)


def rope_frequencies(head_dim: int, length: int, theta: float, device=None):
    """Llama-3 RoPE tables ``(cos, sin)`` of shape ``(length, head_dim/2)``,
    f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / (theta**exponent)
    t = torch.arange(length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, L, H, D); rotate the halves ``(x[..., :D/2], x[..., D/2:])``."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = cos[None, : x.shape[1], None, :]
    sin = sin[None, : x.shape[1], None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# the JAX package's dispatch thresholds as they run on a TPU: the flash
# kernel from 2048 tokens, the whole-row kernel for unmasked self-attention
# of [256, 1664] tokens (multiples of 16, head dims up to 128)
FLASH_MIN_LEN = 2048
ENC_ATTN_MIN_LEN, ENC_ATTN_MAX_LEN = 256, 1664


def _enc_attn_eligible(q, k, v, mask, causal, pad_to_16: bool = False) -> bool:
    if _opted_out("MMTPU_ENC_ATTN") or causal or mask is not None:
        return False
    if q.shape[1] != k.shape[1] or q.shape[2] != k.shape[2]:
        return False  # self-attention, no GQA broadcast
    if v.shape[:3] != q.shape[:3]:
        return False
    l = q.shape[1]
    if pad_to_16:
        l = -(-l // 16) * 16
    if not (ENC_ATTN_MIN_LEN <= l <= ENC_ATTN_MAX_LEN) or l % 16:
        return False
    return q.shape[3] <= 128 and v.shape[3] <= 128


def sdpa(
    q: torch.Tensor,  # (B, Lq, H, D)
    k: torch.Tensor,  # (B, Lk, KVH, D)
    v: torch.Tensor,  # (B, Lk, KVH, Dv)
    mask: Optional[torch.Tensor] = None,  # bool, broadcast to (B, H, Lq, Lk)
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,  # (B,) valid key prefix lengths
    key_valid_len: Optional[int] = None,  # a static valid key prefix shared by all rows
) -> torch.Tensor:
    """Attention with the JAX package's dispatch as it runs on a TPU:

    * ``key_valid_len`` → K1 (``encoder_attention``) where the whole-row
      kernel is eligible (L padded to 16), else a key mask;
    * ``kv_lengths`` at Lq = Lk ≥ 2048, non-causal → K4 (``flash_attention``),
      else a key mask;
    * unmasked self-attention with Lq = Lk ≥ 2048 (causal or not, GQA or
      not) → K4;
    * unmasked non-causal self-attention without GQA at L ∈ [256, 1664],
      L % 16 = 0, head dims ≤ 128 → K1: under ``MMTPU_ENC_ATTN_BLHD=1``
      through ``encoder_attention_blhd`` where ``blhd_supported``, else
      ``encoder_attention``; ``MMTPU_ENC_ATTN=0`` turns both K1 rules off;
    * a single query row with GQA (decode) folds the query heads into the
      query axis, so K/V are read once;
    * everything else runs the XLA-path numerics below. KV head ``i`` serves
      query heads ``i·rep … i·rep+rep−1``.

    XLA path, bf16: logits are rounded to bf16, masked with −1e30, divided by
    √D in f32; ``e`` is rounded to bf16 BEFORE both the f32 denominator and
    the f32-accumulated PV product. f32 (or mixed, e.g. an f32 query against
    a bf16 cache, or bf16 under ``MMTPU_F32_LOGITS=1``): f32 logits, softmax
    of the scaled, masked logits in f32, the probabilities cast to v's
    dtype, then PV. (K1's and K4's contract differs: their denominator sums
    the unrounded ``e``.)"""
    lq, lk = q.shape[1], k.shape[1]
    if key_valid_len is not None:
        if key_valid_len >= lk:
            key_valid_len = None
        elif mask is None and not causal and _enc_attn_eligible(q, k, v, None, False, True):
            return encoder_attention(q, k, v, valid_len=key_valid_len)
        else:
            mask = (torch.arange(lk, device=q.device) < key_valid_len)[None, None, None, :]
    if kv_lengths is not None:
        if not causal and lq == lk and lq >= FLASH_MIN_LEN:
            return flash_attention(q, k, v, lengths=kv_lengths)
        keep = torch.arange(lk, device=q.device)[None, :] < kv_lengths.to(q.device)[:, None]
        mask = keep[:, None, None, :]
    if mask is None and lq == lk and lq >= FLASH_MIN_LEN:
        return flash_attention(q, k, v, causal=causal)
    if _enc_attn_eligible(q, k, v, mask, causal):
        if _switch("MMTPU_ENC_ATTN_BLHD") and blhd_supported(q, v):
            return encoder_attention_blhd(q, k, v)
        return encoder_attention(q, k, v)

    b, h, d = q.shape[0], q.shape[2], q.shape[3]
    kvh = k.shape[2]
    if kvh != h and lq == 1 and not causal and (mask is None or mask.shape[2] == 1):
        # GQA decode fold: (B, 1, H, D) → (B, rep, KVH, D), same dot products
        rep = h // kvh
        qf = q.reshape(b, lq, kvh, rep, d).transpose(2, 3).reshape(b, lq * rep, kvh, d)
        out = sdpa(qf, k, v, mask=mask)
        out = out.reshape(b, lq, rep, kvh, -1).transpose(2, 3)
        return out.reshape(b, lq, h, -1)
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    if q.dtype == torch.bfloat16 and k.dtype == torch.bfloat16 and not _switch("MMTPU_F32_LOGITS"):
        logits = torch.einsum("blhd,bmhd->bhlm", q, k)
        if causal:
            keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~keep, NEG_INF)
        if mask is not None:
            logits = logits.masked_fill(~mask, NEG_INF)
        lf = logits.float() / math.sqrt(d)
        p16 = torch.exp(lf - lf.amax(dim=-1, keepdim=True)).to(v.dtype)
        denom = p16.float().sum(dim=-1)  # (B, H, Lq)
        out = torch.einsum("bhlm,bmhd->blhd", p16.float(), v.float())
        return (out / denom.transpose(1, 2)[..., None]).to(v.dtype)
    # JAX's preferred_element_type=float32: the products of the input
    # values, summed in f32
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / math.sqrt(d)
    if causal:
        keep = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


class Attention(nn.Module):
    """Multi-head attention with optional GQA, RoPE, q/k RMSNorm and a
    separate kv input. Self-attention with none of those runs on K1: over a
    key prefix ``key_valid_len`` through ``encoder_attention`` (the Mllama
    vision tower's 1601 of 1608); over all keys by the JAX package's
    dispatch (``transformer.py`` ``Attention.__call__``), read at call time:

    1. BLF: ``encoder_attention_blf`` on the ``(B, L, H·D)`` projections
       (the ViT), unless ``MMTPU_ENC_ATTN_BLF=0``;
    2. proj-BHLD: the projections viewed as ``(B, H, L, D)`` (a permutation,
       no copy), ``encoder_attention(bhld_inputs=True)`` and the out
       projection contracting over (h, d), unless ``MMTPU_ENC_ATTN_PROJ=0``
       or the block is quantized (as JAX gates it);
    3. ``sdpa``.

    Every length goes to K1 (the JAX package's [256, 1664] window and
    ``% 16`` gate are TPU VMEM rules). A quantized block skips BLF and
    proj-BHLD, as JAX gates them, and runs ``sdpa``. Under
    ``MMTPU_ENC_ATTN=0`` the prefix call goes to ``sdpa``, which masks the
    keys. Everything else runs ``sdpa``; a key prefix is only taken on the
    K1 path and that fallback.

    ``pre_ln=(scale, bias)`` is the fused prologue of a float block's
    self-attention: the block's LayerNorm and the q/k/v projections as ONE
    K6 product over ``[Wq|Wk|Wv]``, then ``sdpa`` on strided views of its
    output."""

    def __init__(
        self,
        width: int,
        num_heads: int,
        head_dim: int,
        num_kv_heads: Optional[int] = None,
        use_rope: bool = False,
        use_qk_norm: bool = False,
        rope_theta: float = 500000.0,
        quantize: bool = False,
        dtype=None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim
        self.use_rope = use_rope
        self.use_qk_norm = use_qk_norm
        self.rope_theta = rope_theta
        self.quantize = quantize
        h, kvh, d = num_heads, self.num_kv_heads, head_dim
        self.q = _dense(width, h * d, False, (width, h, d), quantize, dtype)
        self.k = _dense(width, kvh * d, False, (width, kvh, d), quantize, dtype)
        self.v = _dense(width, kvh * d, False, (width, kvh, d), quantize, dtype)
        self.o = _dense(h * d, width, False, (h, d, width), quantize, dtype)
        if use_qk_norm:
            self.q_norm = RMSNorm(d, dtype=dtype)
            self.k_norm = RMSNorm(d, dtype=dtype)

    def forward(
        self,
        x: torch.Tensor,
        kv: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        key_valid_len: Optional[int] = None,
        pre_ln: Optional[tuple] = None,
    ) -> torch.Tensor:
        b, l, _ = x.shape
        h, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        if pre_ln is not None:
            return self._fused_prologue(x, mask, causal, key_valid_len, pre_ln)
        src = x if kv is None else kv
        q, k, v = self.q(x), self.k(src), self.v(src)
        if (
            kv is None and mask is None and not causal and kvh == h
            and not self.use_rope and not self.use_qk_norm
        ):
            if key_valid_len is not None and key_valid_len < l:
                heads = (t.view(b, l, h, d) for t in (q, k, v))
                if _opted_out("MMTPU_ENC_ATTN"):
                    return self._attend(x, *heads, None, False, key_valid_len)
                o = encoder_attention(*heads, valid_len=key_valid_len)
                return self.o(o.reshape(b, l, h * d))
            if not self.quantize:
                if not _opted_out("MMTPU_ENC_ATTN_BLF"):
                    return self.o(encoder_attention_blf(q, k, v, heads=h))
                if not _opted_out("MMTPU_ENC_ATTN_PROJ"):
                    return self._proj_bhld(q, k, v)
        return self._attend(x, q.view(b, l, h, d), k.view(b, -1, kvh, d),
                            v.view(b, -1, kvh, d), mask, causal)

    def _proj_bhld(self, q, k, v):
        """The proj-BHLD route: the ``(B, L, H·D)`` projections as
        ``(B, H, L, D)`` views, K1 in its BHLD form, and the out projection
        contracting over (h, d) from ``(B, H, L, D)``."""
        b, l, _ = q.shape
        h, d = self.num_heads, self.head_dim
        o = encoder_attention(
            *(t.view(b, l, h, d).permute(0, 2, 1, 3) for t in (q, k, v)), bhld_inputs=True
        )
        return self.o.reduce(torch.einsum("bhld,hdc->blc", o, self.o.weight.view(h, d, -1)))

    def _fused_prologue(self, x, mask, causal, key_valid_len, pre_ln):
        b, l, width = x.shape
        h, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        w = torch.cat([self.q.weight, self.k.weight, self.v.weight], dim=1)
        fused = ln_matmul(x.reshape(-1, width).to(w.dtype), *pre_ln, w)
        nq, nk = h * d, kvh * d
        q = fused[:, :nq].view(b, l, h, d)
        k = fused[:, nq : nq + nk].view(b, l, kvh, d)
        v = fused[:, nq + nk :].view(b, l, kvh, d)
        return self._attend(x, q, k, v, mask, causal, key_valid_len)

    def _attend(self, x, q, k, v, mask, causal, key_valid_len=None):
        """q/k/v norms and rotary, ``sdpa``, the out projection."""
        b, l, _ = x.shape
        h, d = self.num_heads, self.head_dim
        if self.use_qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if self.use_rope:
            cos, sin = rope_frequencies(d, max(l, k.shape[1]), self.rope_theta, x.device)
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = sdpa(q, k, v, mask=mask, causal=causal, key_valid_len=key_valid_len)
        return self.o(o.reshape(b, l, h * d))


class GeluMLP(nn.Module):
    """fc1 → GELU (tanh) → fc2. ``pre_ln=(scale, bias)``: a float block's
    LayerNorm and fc1 (with its bias) as one K6 product."""

    def __init__(self, width: int, hidden: int, quantize: bool = False, dtype=None):
        super().__init__()
        self.fc1 = _dense(width, hidden, True, None, quantize, dtype)
        self.fc2 = _dense(hidden, width, True, None, quantize, dtype)

    def forward(self, x: torch.Tensor, pre_ln: Optional[tuple] = None) -> torch.Tensor:
        if pre_ln is not None:
            w = self.fc1.weight
            h = ln_matmul(x.reshape(-1, x.shape[-1]).to(w.dtype), *pre_ln, w,
                          bias=self.fc1.bias.to(w.dtype))
            h = h.view(*x.shape[:-1], -1)
        else:
            h = self.fc1(x)
        return self.fc2(F.gelu(h, approximate="tanh"))


class SwiGLU(nn.Module):
    def __init__(self, width: int, hidden: int, quantize: bool = False, dtype=None):
        super().__init__()
        self.gate = _dense(width, hidden, False, None, quantize, dtype)
        self.up = _dense(width, hidden, False, None, quantize, dtype)
        self.down = _dense(hidden, width, False, None, quantize, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``.

    ``fuse_ln`` ∈ {False, True, "attn", "mlp"} fuses ln1 into the q/k/v
    projections and/or ln2 into fc1 (K6), where the block input is bf16 of
    a width divisible by 128 and the block is not quantized — the JAX
    gate; elsewhere the block runs unfused. The parameters are the same
    either way."""

    def __init__(
        self, width: int, num_heads: int, mlp_ratio: float = 4.0,
        quantize: bool = False, dtype=None, fuse_ln=False,
    ):
        super().__init__()
        self.fuse_ln = fuse_ln
        self.quantize = quantize
        self.ln1 = FastLayerNorm(width, dtype=dtype)
        self.attn = Attention(
            width, num_heads, width // num_heads, quantize=quantize, dtype=dtype
        )
        self.ln2 = FastLayerNorm(width, dtype=dtype)
        self.mlp = GeluMLP(width, int(width * mlp_ratio), quantize, dtype)

    def forward(self, x, mask=None, key_valid_len=None) -> torch.Tensor:
        fuse = (bool(self.fuse_ln) and not self.quantize and x.dtype == torch.bfloat16
                and x.shape[-1] % 128 == 0)
        if fuse and self.fuse_ln in (True, "attn"):
            h = self.attn(x, mask=mask, key_valid_len=key_valid_len,
                          pre_ln=(self.ln1.scale, self.ln1.bias))
        else:
            h = self.attn(self.ln1(x), mask=mask, key_valid_len=key_valid_len)
        x = x + h
        if fuse and self.fuse_ln in (True, "mlp"):
            return x + self.mlp(x, pre_ln=(self.ln2.scale, self.ln2.bias))
        return x + self.mlp(self.ln2(x))


class GatedEncoderBlock(nn.Module):
    """Mllama global-transformer layer: ``x += tanh(gate_attn)·attn`` and
    ``x += tanh(gate_ffn)·mlp``."""

    def __init__(
        self, width: int, num_heads: int, mlp_ratio: float = 4.0,
        quantize: bool = False, dtype=None,
    ):
        super().__init__()
        self.gate_attn = nn.Parameter(torch.zeros(1))
        self.gate_ffn = nn.Parameter(torch.zeros(1))
        self.ln1 = FastLayerNorm(width, dtype=dtype)
        self.attn = Attention(
            width, num_heads, width // num_heads, quantize=quantize, dtype=dtype
        )
        self.ln2 = FastLayerNorm(width, dtype=dtype)
        self.mlp = GeluMLP(width, int(width * mlp_ratio), quantize, dtype)

    def forward(self, x, mask=None, key_valid_len=None) -> torch.Tensor:
        h = self.attn(self.ln1(x), mask=mask, key_valid_len=key_valid_len)
        x = x + torch.tanh(self.gate_attn) * h
        return x + torch.tanh(self.gate_ffn) * self.mlp(self.ln2(x))


class LlamaBlock(nn.Module):
    """Llama-3 decoder block: RMSNorm + causal GQA-RoPE attention + SwiGLU."""

    def __init__(
        self, width: int, num_heads: int, num_kv_heads: int, head_dim: int,
        mlp_hidden: int, rope_theta: float = 500000.0, quantize: bool = False,
        dtype=None,
    ):
        super().__init__()
        self.attn_norm = RMSNorm(width, dtype=dtype)
        self.attn = Attention(
            width, num_heads, head_dim, num_kv_heads, use_rope=True,
            rope_theta=rope_theta, quantize=quantize, dtype=dtype,
        )
        self.mlp_norm = RMSNorm(width, dtype=dtype)
        self.mlp = SwiGLU(width, mlp_hidden, quantize, dtype)

    def forward(self, x, mask=None) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), mask=mask, causal=True)
        return x + self.mlp(self.mlp_norm(x))


class CrossAttentionBlock(nn.Module):
    """Mllama gated cross-attention block: the text stream attends to the
    vision states through tanh-gated residuals."""

    def __init__(
        self, width: int, num_heads: int, num_kv_heads: int, head_dim: int,
        mlp_hidden: int, quantize: bool = False, dtype=None,
    ):
        super().__init__()
        self.attn_gate = nn.Parameter(torch.zeros(1))
        self.mlp_gate = nn.Parameter(torch.zeros(1))
        self.attn_norm = RMSNorm(width, dtype=dtype)
        self.cross_attn = Attention(
            width, num_heads, head_dim, num_kv_heads, use_qk_norm=True,
            quantize=quantize, dtype=dtype,
        )
        self.mlp_norm = RMSNorm(width, dtype=dtype)
        self.mlp = SwiGLU(width, mlp_hidden, quantize, dtype)

    def forward(self, x, vision_states, cross_mask=None) -> torch.Tensor:
        h = self.cross_attn(self.attn_norm(x), kv=vision_states, mask=cross_mask)
        x = x + torch.tanh(self.attn_gate) * h
        return x + torch.tanh(self.mlp_gate) * self.mlp(self.mlp_norm(x))


def last_token_pool(
    hidden: torch.Tensor, attention_mask: torch.Tensor, normalize: bool = True
) -> torch.Tensor:
    """The mmE5 embedding contract: the hidden state at index
    ``sum(attention_mask) − 1`` of each row, optionally L2-normalised."""
    idx = attention_mask.sum(dim=1).long() - 1
    pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    if normalize:
        pooled = pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return pooled
