"""Flash attention (K4): online-softmax attention over key tiles, with GQA,
per-batch key lengths, causal masking and Dk ≠ Dv.

Replaces the Pallas TPU kernel ``flash_attention`` (``_flash_kernel``) of
``multimodal_embeddings_tpu/kernels/flash_attention.py`` with a hand-written
CUDA kernel, ``csrc/flash_attention.cu``. Numerics (kernel and plain
version): scores ``(q·k)`` summed in f32 from the input type's operands, times
``1/√Dk`` in f32; keys at or past ``lengths[b]``, and keys after the query
under ``causal``, score −1e30; keys are visited in blocks of 128 with an f32
running max and sum, the sum adds the unrounded f32 ``p`` and ``p`` is cast to
the input type only for the f32-accumulated PV product; the output is
``acc / max(sum, 1e-30)`` in q's type. Query head ``h`` reads kv head
``h // (H / KVH)`` (``jnp.repeat`` order). ``lengths`` must be ≥ 1; a length
past L counts as L.

The plain version repeats the TPU kernel's block loop at ``block_k`` = 128
(a whole-row softmax would round ``p`` to bf16 against another max). What
bounds the kernel on an H100, and what its design does about it, is written
at the top of the CUDA source.

``flash_attention_v2`` replaces the TPU package's K/V-resident variant
(``_flash_kernel_v2``) with the same contract and arguments: the same CUDA
tile body on another schedule, one block per (head, batch item) walking its
query tiles in order, so its outputs equal ``flash_attention``'s row for
row and its plain version is ``flash_attention``'s.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` and
``flash_attention_v2.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
BLOCK_K = 128
NEG_INF = -1e30


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    strides = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]  # batch, row, head
    for fn in (lib.flash_attn_launch, lib.flash_attn_v2_launch):
        fn.argtypes = (
            [ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + strides * 3
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def flash_attention_reference(
    q: torch.Tensor,  # (B, L, H, Dk)
    k: torch.Tensor,  # (B, L, KVH, Dk)
    v: torch.Tensor,  # (B, L, KVH, Dv)
    lengths: Optional[torch.Tensor] = None,  # (B,) valid key counts
    causal: bool = False,
) -> torch.Tensor:
    """Plain version of ``flash_attention``: the TPU kernel's loop over key
    blocks of 128, all query rows at once."""
    b, l, h, dk = q.shape
    kvh = k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    work = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qf = q.transpose(1, 2).float()  # (B, H, L, Dk)
    kf = k.transpose(1, 2).float()
    vf = v.transpose(1, 2).float()
    if lengths is None:
        valid = torch.full((b,), l, dtype=torch.long, device=q.device)
    else:
        valid = lengths.to(device=q.device, dtype=torch.long).clamp(max=l)
    rows = torch.arange(l, device=q.device)
    scale = 1.0 / math.sqrt(dk)
    m = torch.full((b, h, l, 1), NEG_INF, dtype=torch.float32, device=q.device)
    s = torch.zeros((b, h, l, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, l, v.shape[3]), dtype=torch.float32, device=q.device)
    for k0 in range(0, l, BLOCK_K):
        keys = torch.arange(k0, min(k0 + BLOCK_K, l), device=q.device)
        scores = torch.matmul(qf, kf[:, :, k0 : k0 + BLOCK_K].transpose(-1, -2)) * scale
        keep = keys[None, :] < valid[:, None]  # (B, K)
        keep = keep[:, None, None, :]
        if causal:
            keep = keep & (keys[None, :] <= rows[:, None])[None, None]
        scores = scores.masked_fill(~keep, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new)
        s = s * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(work).float(), vf[:, :, k0 : k0 + BLOCK_K])
        m = m_new
    out = acc / s.clamp_min(1e-30)
    return out.to(q.dtype).transpose(1, 2)


def _flash(launch: str, q, k, v, lengths, causal) -> torch.Tensor:
    """Check the operands and run the plain version (CPU) or the kernel
    behind the C entry point ``launch`` (CUDA); True in the second value
    when the kernel was launched."""
    b, l, h, dk = q.shape
    kvh, dv = k.shape[2], v.shape[3]
    if k.shape != (b, l, kvh, dk) or v.shape[:3] != (b, l, kvh) or h % kvh:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if lengths is not None and lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, lengths, causal), False
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention runs on cpu or one cuda device, not {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16")
    if dk > _MAX_DIM or dv > _MAX_DIM:
        raise ValueError(f"head dims {dk}/{dv} exceed {_MAX_DIM}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"expected a unit feature stride, got strides {t.stride()}")
    lens = None
    if lengths is not None:
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, l, h, dv), device=q.device, dtype=q.dtype)
    args = []
    for t in (q, k, v):
        args += [t.stride(0), t.stride(1), t.stride(2)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(_lib(), launch)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lens is None else lens.data_ptr(), b, l, h, kvh, dk, dv, *args,
        int(causal), 1.0 / math.sqrt(dk), stream,
    )
    if err != 0:
        raise RuntimeError(f"{launch} failed: cudaError {err}")
    return out, True


def flash_attention(
    q: torch.Tensor,  # (B, L, H, Dk)
    k: torch.Tensor,  # (B, L, KVH, Dk)
    v: torch.Tensor,  # (B, L, KVH, Dv)
    lengths: Optional[torch.Tensor] = None,  # (B,) valid key counts, ≥ 1
    causal: bool = False,
) -> torch.Tensor:
    """Self-attention over key tiles, never forming the (L, L) scores.
    Returns ``(B, L, H, Dv)`` in q's dtype."""
    out, launched = _flash("flash_attn_launch", q, k, v, lengths, causal)
    flash_attention.launches += launched
    return out


flash_attention.launches = 0


def flash_attention_v2(
    q: torch.Tensor,  # (B, L, H, Dk)
    k: torch.Tensor,  # (B, L, KVH, Dk)
    v: torch.Tensor,  # (B, L, KVH, Dv)
    lengths: Optional[torch.Tensor] = None,  # (B,) valid key counts, ≥ 1
    causal: bool = False,
) -> torch.Tensor:
    """``flash_attention`` on the K/V-resident schedule: one block per
    (head, batch item). The same contract and the same outputs."""
    out, launched = _flash("flash_attn_v2_launch", q, k, v, lengths, causal)
    flash_attention_v2.launches += launched
    return out


flash_attention_v2.launches = 0
