"""Whole-row encoder attention (K1) for the page programs' three call sites.

Replaces the Pallas TPU kernels of
``multimodal_embeddings_tpu/kernels/encoder_attention.py``:
``encoder_attention_blf`` (``_enc_attn_blf_kernel`` and its ``scratch``
twin, same math), ``encoder_attention_blf_packed``
(``_enc_attn_blf_packed_kernel``) and ``encoder_attention`` /
``encoder_attention_padded`` (``_enc_attn_kernel`` with its static
``valid_len`` key mask). All three wrappers here launch ONE hand-written CUDA
kernel, ``csrc/encoder_attention.cu``, which addresses q, k and v through
(batch, row, head) strides and attends over the key prefix
``[0, valid_len)``:

* ``encoder_attention_blf``: q/k/v are separate ``(B, L, H·D)`` slabs, head
  ``h`` at column ``h·D`` (the ViT's plain-matmul projections);
* ``encoder_attention_blf_packed``: q/k/v are strided views of one
  ``(B, L, H·(2kd+hd))`` slab, per head ``[q(kd) | k(kd) | v(hd)]`` (the
  detector PSA block's conv output, ultralytics channel order);
* ``encoder_attention``: ``(B, L, H, D)`` operands and a key prefix
  ``valid_len`` (the Mllama vision tower: 1601 valid of 1608 rows). The JAX
  ``encoder_attention_padded`` pads L to 16 for the TPU's sublanes; the
  kernel takes any L, so the port's ``encoder_attention_padded`` is this
  wrapper with ``valid_len`` and no padding. With
  ``bhld_inputs=True`` q/k/v and the output are ``(B, H, L, D)`` instead —
  the ViT's proj-BHLD route (``MMTPU_ENC_ATTN_BLF=0``) hands it permuted
  views of its ``(B, L, H·D)`` projections, read through their strides with
  no copy. The JAX ``heads_per_block`` and ``row_block`` arguments tile the
  TPU's VMEM and have no counterpart here;
* ``encoder_attention_blhd``: ``(B, L, H, D)`` operands over all keys with a
  given scale — the opt-in route of ``sdpa`` (``MMTPU_ENC_ATTN_BLHD=1``),
  whose q/k/v are strided column slices of the fused LayerNorm→qkv product,
  read in place. ``blhd_supported`` is the JAX package's dispatch rule, so
  the route is taken at the same shapes.

What bounds the kernel on an H100, and what its design does about it, is
written at the top of the CUDA source: bf16 runs on tensor cores in two
passes over the key tiles (the exact row max, then exp and PV), f32 on CUDA
cores. ``_plan`` chooses each launch's padded head dims, the copy width of
each operand and the shared-memory bytes, in Python, where the CPU tests
reach it. Numerics (both the kernel and the plain versions): f32 scores
``(q·k)·scale``, f32 ``exp(s − rowmax)`` over all valid keys and the f32
denominator of the unrounded ``e``, ``e`` cast to the input dtype before an
f32-accumulated PV product, output ``/ max(denom, 1e-30)`` cast to the input
dtype.

``sm_scale`` (every wrapper and plain version; None: ``1/√D``, the key
dim) is the scale the kernel takes as an argument.

Keys at or past ``valid_len`` are left out, which is what the TPU kernel's
score of −1e30 comes to (its ``e`` is exactly 0 in f32); every row is still
a query.

Dispatch: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
launches the kernel or raises. Each wrapper counts its kernel launches in
``<wrapper>.launches``; ``encoder_attention`` counts its (B, L, H, D) form
there and its BHLD form in ``encoder_attention.bhld.launches``.

Gradients: the two forms the ViT's forward reaches, ``encoder_attention_blf``
and ``encoder_attention(bhld_inputs=True)`` over all keys, run on the card
through ``KernelAttention``, an ``autograd.Function`` whose forward is the
kernel launch and whose backward is plain tensor code (``attention_backward``:
the scores recomputed in f32 from the saved q and k, no kernel launch). The
JAX package has no backward to port: ``jax.grad`` cannot linearize its Pallas
kernels, so its gradient, where it has one, is XLA's autodiff of the einsum
path. Every other form raises on the card when grad mode is on and an input
requires a gradient (``_build.refuse_grad``); on the CPU the plain version
carries the gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "encoder_attention"
# per-block dynamic shared memory an H100 grants (227 KB)
_MAX_SMEM = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
# the bf16 kernel's tile (csrc/encoder_attention.cu): query rows per CTA,
# keys per ring stage, ring stages, bf16 appended to every shared row
_BQ, _BK, _STAGES, _PAD = 128, 64, 3, 8
# the f32 kernel's tile: query rows per block, keys per staged K/V tile
_F32_TQ, _F32_KT = 16, 64


class Plan(NamedTuple):
    """One launch's shapes: D and DV as the kernel holds them (bf16: padded
    to a multiple of 16 with zero columns), the bytes per copy of q, k and v
    (16, 8 or 4 for ``cp.async``, else 2 by plain loads; bf16 only) and the
    dynamic shared-memory bytes."""

    dp: int
    dvp: int
    widths: tuple
    smem: int


def _copy_width(ptr: int, strides, elem: int) -> int:
    """The largest of 16, 8 and 4 bytes that divides the operand's base
    address and each of its (batch, row, head) strides in bytes, else the
    element size."""
    for width in (16, 8, 4):
        if width >= elem and all(x % width == 0 for x in (ptr, *(st * elem for st in strides))):
            return width
    return elem


def _plan(dtype, l: int, d: int, dv: int, operands) -> Plan:
    """The launch plan of K1 over L rows and head dims D / DV; ``operands``
    holds (base address, (batch, row, head) element strides) of q, k and v.
    bf16: a 3-stage ring of 64-key K and V tiles and a 128-row Q tile, rows
    padded by 8, independent of L. f32: 16 query rows' whole f32 score rows,
    so its bytes grow with L."""
    elem = dtype.itemsize
    widths = tuple(_copy_width(ptr, st, elem) for ptr, st in operands)
    if dtype == torch.bfloat16:
        dp, dvp = -(-d // 16) * 16, -(-dv // 16) * 16
        smem = 2 * (_STAGES * _BK * (dp + dvp + 2 * _PAD) + _BQ * (dp + _PAD))
        return Plan(dp, dvp, widths, smem)
    k_stride = max(d | 1, dv)  # an odd K row stride: no bank conflicts
    smem = 4 * (_F32_TQ * d + _F32_TQ * ((l + 3) & ~3) + _F32_KT * k_stride + _F32_TQ)
    return Plan(d, dv, widths, smem)


@functools.cache
def _lib():
    """The built library with its C signatures declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    strides = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # batch, row, head
    lib.enc_attn_launch.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 6
        + strides * 4
        + [ctypes.c_float]
        + [ctypes.c_int] * 6  # the plan: dp, dvp, three copy widths, smem
        + [ctypes.c_void_p]
    )
    lib.enc_attn_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernel's reference)
# ---------------------------------------------------------------------------


def _attend_plain(q, k, v, scale: float, valid_len=None) -> torch.Tensor:
    """(B, H, L, D), (B, H, L, D), (B, H, L, Dv) → (B, H, L, Dv) in q's
    dtype, with the module docstring's numerics; keys ``[0, valid_len)``."""
    if valid_len is not None:
        k, v = k[..., :valid_len, :], v[..., :valid_len, :]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(q.dtype).float(), v.float())
    return (o / denom.clamp_min(1e-30)).to(q.dtype)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, l, f = x.shape
    return x.reshape(b, l, heads, f // heads).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    b, h, l, d = o.shape
    return o.transpose(1, 2).reshape(b, l, h * d)


def _scale(sm_scale, d: int) -> float:
    return 1.0 / math.sqrt(d) if sm_scale is None else float(sm_scale)


def encoder_attention_blf_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, sm_scale=None
) -> torch.Tensor:
    """Plain version of ``encoder_attention_blf``."""
    scale = _scale(sm_scale, q.shape[2] // heads)
    o = _attend_plain(_heads(q, heads), _heads(k, heads), _heads(v, heads), scale)
    return _merge(o)


def _split_packed(qkv, heads, key_dim):
    b, l, f = qkv.shape
    per_head = qkv.reshape(b, l, heads, f // heads).transpose(1, 2)
    return (
        per_head[..., :key_dim],
        per_head[..., key_dim : 2 * key_dim],
        per_head[..., 2 * key_dim :],
    )


def encoder_attention_blf_packed_reference(
    qkv: torch.Tensor, heads: int, key_dim: int, head_dim: int, sm_scale=None
) -> torch.Tensor:
    """Plain version of ``encoder_attention_blf_packed``."""
    q, k, v = _split_packed(qkv, heads, key_dim)
    return _merge(_attend_plain(q, k, v, _scale(sm_scale, key_dim)))


def encoder_attention_blhd_reference(q, k, v, sm_scale=None) -> torch.Tensor:
    """Plain version of ``encoder_attention_blhd``."""
    scale = _scale(sm_scale, q.shape[3])
    o = _attend_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale)
    return o.transpose(1, 2)


def attention_backward(q, k, v, o, do, scale: float) -> tuple:
    """The gradient of K1's contract over all keys, in plain tensor code:
    (B, H, L, D) q, k, (B, H, L, Dv) v, the forward's output o and its
    gradient do → (dq, dk, dv) in f32. The f32 scores are recomputed from q
    and k; ``P = e / denom`` with the denominator of the unrounded ``e`` (the
    cast of ``e`` to the input dtype is taken as the identity); ``dV = Pᵀ·dO``,
    ``dP = dO·Vᵀ``, ``dS = P ⊙ (dP − rowsum(dO ⊙ O))``, ``dQ = dS·K·scale``,
    ``dK = dSᵀ·Q·scale``. Batch items go in chunks of at most 2²⁷ scores."""
    b, h, l, _ = q.shape
    chunk = max(1, (1 << 27) // (h * l * k.shape[2]))
    grads = []
    for i in range(0, b, chunk):
        qf, kf, vf, of, dof = (t[i : i + chunk].float() for t in (q, k, v, o, do))
        s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        dv = torch.matmul(p.transpose(-1, -2), dof)
        dp = torch.matmul(dof, vf.transpose(-1, -2))
        ds = p * (dp - (dof * of).sum(dim=-1, keepdim=True))
        grads.append((torch.matmul(ds, kf) * scale,
                      torch.matmul(ds.transpose(-1, -2), qf) * scale, dv))
    return tuple(torch.cat(g) for g in zip(*grads))


def encoder_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len=None,
    bhld_inputs: bool = False, sm_scale=None,
) -> torch.Tensor:
    """Plain version of ``encoder_attention``."""
    scale = _scale(sm_scale, q.shape[3])
    if bhld_inputs:
        return _attend_plain(q, k, v, scale, valid_len)
    o = _attend_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale, valid_len)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    dtype = tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"encoder attention runs on cpu or cuda, not {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError("q, k and v must share one device and dtype")
        if t.stride(-1) != 1:
            raise ValueError(
                f"expected a unit feature stride, got {tuple(t.shape)} "
                f"strides {t.stride()}"
            )
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {dtype} (float32 or bfloat16)")


def _launch(q, k, v, out, dims, strides, scale, valid_len) -> torch.Tensor:
    """One kernel launch writing ``out``. ``dims`` = (B, L, H, D, Dv);
    ``strides`` holds the (batch, row, head) element strides of q, k, v and
    out, in that order, each operand with a unit feature stride."""
    b, l, heads, d, dv = dims
    if d > _MAX_DIM or dv > _MAX_DIM:
        raise ValueError(f"head dims {d}/{dv} exceed {_MAX_DIM}")
    plan = _plan(q.dtype, l, d, dv, [(t.data_ptr(), st) for t, st in zip((q, k, v), strides)])
    if plan.smem > _MAX_SMEM:
        raise ValueError(
            f"L={l} needs {plan.smem} B of shared memory per block in {q.dtype} "
            f"(limit {_MAX_SMEM}): the f32 form keeps whole score rows"
        )
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.enc_attn_launch(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, l, heads, d, dv, valid_len, *(x for st in strides for x in st),
        scale, plan.dp, plan.dvp, *plan.widths, plan.smem, stream,
    )
    if err != 0:
        raise RuntimeError(f"encoder attention launch failed: cudaError {err}")
    return out


def _launch_blf(q, k, v, heads, d, dv, head_strides, scale) -> torch.Tensor:
    """K1 over (B, L, ·) views whose heads lie ``head_strides`` columns
    apart, all keys; returns ``(B, L, heads·dv)``."""
    b, l = q.shape[:2]
    out = torch.empty((b, l, heads * dv), device=q.device, dtype=q.dtype)
    strides = [(t.stride(0), t.stride(1), hs)
               for t, hs in zip((q, k, v, out), (*head_strides, dv))]
    return _launch(q, k, v, out, (b, l, heads, d, dv), strides, scale, l)


class KernelAttention(torch.autograd.Function):
    """K1 over all keys with a gradient: the forward launches the kernel (a
    CPU tensor takes the plain version, so the backward can be held against
    autograd there), the backward is ``attention_backward`` and launches no
    kernel. ``form`` is ``"blf"`` (q, k, v ``(B, L, H·D)``, ``heads`` heads)
    or ``"bhld"`` (``(B, H, L, D)`` views); ``sm_scale`` as the wrappers'.
    The wrappers count the launch."""

    @staticmethod
    def forward(ctx, q, k, v, form: str, heads: int, sm_scale=None):
        d = q.shape[2] // heads if form == "blf" else q.shape[3]
        scale = _scale(sm_scale, d)
        if not q.is_cuda:
            out = (encoder_attention_blf_reference(q, k, v, heads, scale) if form == "blf"
                   else encoder_attention_reference(q, k, v, bhld_inputs=True, sm_scale=scale))
        elif form == "blf":
            dv = v.shape[2] // heads
            out = _launch_blf(q, k, v, heads, d, dv, (d, d, dv), scale)
        else:
            out = _launch_4d(q, k, v, True, scale, q.shape[2])
        ctx.form, ctx.heads, ctx.scale = form, heads, scale
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if ctx.form == "blf":
            h = ctx.heads
            dq, dk, dv = attention_backward(_heads(q, h), _heads(k, h), _heads(v, h),
                                            _heads(o, h), _heads(do, h), ctx.scale)
            dq, dk, dv = _merge(dq), _merge(dk), _merge(dv)
        else:
            dq, dk, dv = attention_backward(q, k, v, o, do, ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def encoder_attention_blf(
    q: torch.Tensor,  # (B, L, H·D)
    k: torch.Tensor,  # (B, L, H·D)
    v: torch.Tensor,  # (B, L, H·Dv)
    heads: int,
    sm_scale=None,
) -> torch.Tensor:
    """Unmasked whole-row attention over head-major ``(B, L, H·D)`` slabs,
    scale ``sm_scale`` (``1/√D`` when None). Returns ``(B, L, H·Dv)`` in q's
    dtype; on the card it carries a gradient (``KernelAttention``)."""
    b, l, f = q.shape
    if f % heads or v.shape[2] % heads or k.shape != q.shape:
        raise ValueError(f"bad shapes {q.shape} {k.shape} {v.shape} / {heads}")
    if v.shape[:2] != (b, l):
        raise ValueError(f"v {tuple(v.shape)} does not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return encoder_attention_blf_reference(q, k, v, heads, sm_scale)
    _check_cuda(q, k, v)
    out = KernelAttention.apply(q, k, v, "blf", heads, sm_scale)
    encoder_attention_blf.launches += 1
    return out


encoder_attention_blf.launches = 0


def encoder_attention_blf_packed(
    qkv: torch.Tensor,  # (B, L, heads·(2·key_dim + head_dim)), per head [q|k|v]
    heads: int,
    key_dim: int,
    head_dim: int,
    sm_scale=None,
) -> torch.Tensor:
    """Whole-row attention read straight off a packed per-head ``[q|k|v]``
    slab, scale ``sm_scale`` (``1/√key_dim`` when None). Returns ``(B, L,
    heads·head_dim)`` in qkv's dtype."""
    b, l, f = qkv.shape
    stride = 2 * key_dim + head_dim
    if f != heads * stride:
        raise ValueError(f"qkv width {f} != {heads}·(2·{key_dim}+{head_dim})")
    if qkv.device.type == "cpu":
        return encoder_attention_blf_packed_reference(qkv, heads, key_dim, head_dim, sm_scale)
    _check_cuda(qkv)
    _build.refuse_grad("encoder_attention_blf_packed", qkv)
    q = qkv[..., :key_dim]
    k = qkv[..., key_dim : 2 * key_dim]
    v = qkv[..., 2 * key_dim :]
    out = _launch_blf(q, k, v, heads, key_dim, head_dim, (stride,) * 3,
                      _scale(sm_scale, key_dim))
    encoder_attention_blf_packed.launches += 1
    return out


encoder_attention_blf_packed.launches = 0


def _launch_4d(q, k, v, bhld: bool, scale, valid_len) -> torch.Tensor:
    """K1 over 4-D operands read through their strides: (B, L, H, D), or
    (B, H, L, D) with ``bhld``; the output in the same layout."""
    if bhld:
        b, h, l, d = q.shape
        order = (0, 2, 1)  # (batch, row, head) dims of a BHLD tensor
    else:
        b, l, h, d = q.shape
        order = (0, 1, 2)
    dv = v.shape[3]
    out_shape = (b, h, l, dv) if bhld else (b, l, h, dv)
    out = torch.empty(out_shape, device=q.device, dtype=q.dtype)
    strides = [tuple(t.stride(i) for i in order) for t in (q, k, v, out)]
    return _launch(q, k, v, out, (b, l, h, d, dv), strides, scale, valid_len)


def encoder_attention(
    q: torch.Tensor,  # (B, L, H, D), or (B, H, L, D) with bhld_inputs
    k: torch.Tensor,  # as q
    v: torch.Tensor,  # (B, L, H, Dv), or (B, H, L, Dv)
    valid_len=None,
    bhld_inputs: bool = False,
    sm_scale=None,
) -> torch.Tensor:
    """Whole-row attention over the keys ``[0, valid_len)`` (all L when
    None), scale ``sm_scale`` (``1/√D`` when None); every row is a query. Returns ``(B, L, H, Dv)``
    (``(B, H, L, Dv)`` with ``bhld_inputs``) in q's dtype. On the card the
    BHLD form over all keys carries a gradient (``KernelAttention``); the
    other forms raise under grad."""
    l = q.shape[2] if bhld_inputs else q.shape[1]
    if k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"bad shapes {q.shape} {k.shape} {v.shape}")
    n = l if valid_len is None else valid_len
    if not 1 <= n <= l:
        raise ValueError(f"valid_len {valid_len} outside [1, {l}]")
    if q.device.type == "cpu":
        return encoder_attention_reference(q, k, v, valid_len, bhld_inputs, sm_scale)
    _check_cuda(q, k, v)
    if bhld_inputs and n == l:
        out = KernelAttention.apply(q, k, v, "bhld", q.shape[1], sm_scale)
    else:
        _build.refuse_grad("encoder_attention", q, k, v)
        out = _launch_4d(q, k, v, bhld_inputs, _scale(sm_scale, q.shape[3]), n)
    counter = encoder_attention.bhld if bhld_inputs else encoder_attention
    counter.launches += 1
    return out


encoder_attention.launches = 0  # the (B, L, H, D) form
encoder_attention.bhld = SimpleNamespace(launches=0)  # the (B, H, L, D) form


def encoder_attention_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             valid_len: int) -> torch.Tensor:
    """The JAX name of ``encoder_attention(q, k, v, valid_len=valid_len)``
    on ``(B, L, H, D)`` operands: the kernel takes any L, so nothing is
    padded. Launches are counted in ``encoder_attention.launches``."""
    return encoder_attention(q, k, v, valid_len=valid_len)


def _blhd_pick_hpb(l, h, d, dv, dtype):
    """Largest LEGAL head block fitting the VMEM budget, or None.

    Mosaic requires a block's last two dims be (8, 128)-divisible OR
    equal to the full array dims — so a (1, L, hpb, D) block needs hpb
    to be a multiple of 8 or hpb == H (the headline chain-23 crash:
    hpb=2 of H=4 was rejected)."""
    ib = 6 if dtype == torch.bfloat16 else 8
    elem = dtype.itemsize
    inter = ib * l * l
    legal = {h} | {c for c in range(8, h, 8) if h % c == 0}
    fitting = [
        hpb
        for hpb in legal
        if 2 * l * hpb * (2 * d + 2 * dv) * elem + inter <= 14e6
    ]
    return max(fitting) if fitting else None


def blhd_supported(q, v) -> bool:
    """Whether the JAX package takes its BLHD variant at these shapes (a
    TPU VMEM rule, kept so that ``sdpa`` dispatches where JAX does)."""
    _, l, h, d = q.shape
    return _blhd_pick_hpb(l, h, d, v.shape[3], q.dtype) is not None


def encoder_attention_blhd(
    q: torch.Tensor,  # (B, L, H, D)
    k: torch.Tensor,  # (B, L, H, D)
    v: torch.Tensor,  # (B, L, H, Dv)
    sm_scale=None,
) -> torch.Tensor:
    """Unmasked whole-row attention over ``(B, L, H, D)`` operands, read
    through their (batch, row, head) strides without a copy, scale
    ``sm_scale`` (``1/√D`` when None). Returns ``(B, L, H, Dv)`` in q's
    dtype."""
    b, l, h, d = q.shape
    if k.shape != q.shape or v.dim() != 4 or v.shape[:3] != (b, l, h):
        raise ValueError(f"bad shapes {q.shape} {k.shape} {v.shape}")
    scale = _scale(sm_scale, d)
    if q.device.type == "cpu":
        return encoder_attention_blhd_reference(q, k, v, scale)
    _check_cuda(q, k, v)
    _build.refuse_grad("encoder_attention_blhd", q, k, v)
    out = _launch_4d(q, k, v, False, scale, l)
    encoder_attention_blhd.launches += 1
    return out


encoder_attention_blhd.launches = 0
