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
at the top of the CUDA source: in bf16, 128-row query tiles on warpgroup
tensor cores (``wgmma``) fed by a ring of K/V tiles that TMA loads.
``_plan`` chooses each launch's form in Python, where the CPU tests reach
it: per operand TMA or ``cp.async`` (a base or stride TMA cannot take), the
padded head dims, the ring's stages, the shared-memory bytes, and v2's
cluster size and clusters per (head, batch item).

``flash_attention_v2`` replaces the TPU package's K/V-resident variant
(``_flash_kernel_v2``) with the same contract and arguments: the same CUDA
consumer code on another schedule, a cluster of CTAs per (head, batch item)
walking its query tiles with each K/V tile multicast once to all members, so
its outputs equal ``flash_attention``'s bit for bit and its plain version is
``flash_attention``'s.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. ``flash_attention.launches`` and
``flash_attention_v2.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "flash_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DIM = 128
BLOCK_K = 128
NEG_INF = -1e30
# the bf16 kernel (csrc/flash_attention.cu): query rows per CTA, largest
# ring, the bytes of its barriers; the card's SMs and the dynamic shared
# memory a CTA may take (227 KB)
_BQ, _MAX_STAGES, _BARRIER_BYTES = 128, 4, 8 * (2 * 4 + 2)
_SMS, _MAX_SMEM = 132, 232448


class Plan(NamedTuple):
    """One bf16 launch's form: Dk and Dv padded to 16; per operand (q, k, v)
    its path, ``"tma"`` or ``"cp.async"``, and the bytes per copy on the
    latter (16, 8, 4, or 2 by plain loads; 0 on TMA); the K/V ring's stages;
    v2's cluster size C and clusters per (head, batch item) S (both 1 for
    v1); the dynamic shared-memory bytes."""

    dkp: int
    dvp: int
    paths: tuple
    widths: tuple
    stages: int
    cluster: int
    splits: int
    smem: int

    def ints(self) -> list:
        """The plan as the C entry point takes it."""
        return [self.dkp, self.dvp, *self.widths, self.stages, self.cluster, self.splits,
                self.smem]


def _dim_cols(p: int) -> int:
    """Shared columns of a head dim padded to p: 64-column atoms, then a
    remainder atom of 16, 32 or (for 48) 64 columns."""
    rem = p % 64
    return p // 64 * 64 + (64 if rem == 48 else rem)


def _tma_ok(ptr: int, strides, extents) -> bool:
    """TMA takes a 16-byte-aligned base and (batch, row, head) strides that
    are positive multiples of 16 bytes (bf16), on the dims of extent > 1."""
    return ptr % 16 == 0 and all(
        st > 0 and (2 * st) % 16 == 0 for st, n in zip(strides, extents) if n > 1)


def _copy_width(ptr: int, strides, extents) -> int:
    """The largest of 16, 8 and 4 bytes that divides the base address and
    each (batch, row, head) stride in bytes (dims of extent > 1), else 2."""
    for width in (16, 8, 4):
        if ptr % width == 0 and all((2 * st) % width == 0
                                    for st, n in zip(strides, extents) if n > 1):
            return width
    return 2


def _plan(b: int, l: int, h: int, kvh: int, dk: int, dv: int, operands, v2: bool,
          resident=None) -> Plan:
    """The bf16 launch plan; ``operands`` holds (base address, (batch, row,
    head) element strides) of q, k and v. Neither ``causal`` nor ``lengths``
    enters it. Stages: as many as fit, up to 4. Where B·H alone leaves SMs
    idle, v2 takes the cluster size C (1, 2, 4 or 8) and the clusters per
    (head, batch item) S with the fewest rounds of query-tile steps,
    ceil(B·H·S·C / resident CTAs) × ceil(nq / (S·C)) (ties: the larger C,
    then the smaller S); else C = S = 1. ``resident(dvp, smem, C)`` is how
    many CTAs in clusters of C the card holds at once (the card's answer
    in ``plan_for``); by default one CTA on each of 132 SMs."""
    dkp, dvp = -(-dk // 16) * 16, -(-dv // 16) * 16
    paths, widths = [], []
    for (ptr, strides), heads in zip(operands, (h, kvh, kvh)):
        extents = (b, l, heads)
        if _tma_ok(ptr, strides, extents):
            paths.append("tma")
            widths.append(0)
        else:
            paths.append("cp.async")
            widths.append(_copy_width(ptr, strides, extents))
    kc, vc = _dim_cols(dkp), _dim_cols(dvp)

    def smem(stages):
        return 1024 + 2 * _BQ * kc + 2 * stages * BLOCK_K * (kc + vc) + _BARRIER_BYTES

    stages = max(s for s in range(2, _MAX_STAGES + 1) if smem(s) <= _MAX_SMEM)
    if resident is None:
        def resident(dvp, smem, c):
            return _SMS // c * c
    cluster, splits = 1, 1
    if v2 and b * h < resident(dvp, smem(stages), 1):
        # the fewest rounds of query-tile steps: ceil(B·H·S·C / resident)
        # waves of CTAs, each walking ceil(nq / (S·C)) tiles; ties: the
        # larger C, then the smaller S
        nq = -(-l // _BQ)
        cost = {}
        for c in (1, 2, 4, 8):
            fit = resident(dvp, smem(stages), c)
            if c > nq or fit <= 0:
                continue
            for s in range(1, -(-nq // c) + 1):
                cost[c, s] = -(-b * h * s * c // fit) * -(-nq // (s * c))
        cluster, splits = min(cost, key=lambda cs: (cost[cs], -cs[0], cs[1]))
    return Plan(dkp, dvp, tuple(paths), tuple(widths), stages, cluster, splits, smem(stages))


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, v2: bool = False) -> Plan:
    """The plan a bf16 launch on these operands takes."""
    b, l, h, dk = q.shape
    operands = [(t.data_ptr(), (t.stride(0), t.stride(1), t.stride(2))) for t in (q, k, v)]
    return _plan(b, l, h, k.shape[2], dk, v.shape[3], operands, v2,
                 _resident_ctas if q.is_cuda else None)


@functools.cache
def _resident_ctas(dvp: int, smem: int, cluster: int) -> int:
    """CTAs of the bf16 kernel the card holds at once in clusters of
    ``cluster`` (the CUDA occupancy calls)."""
    n = _lib().flash_attn_resident_ctas(dvp, smem, cluster)
    if n < 0:
        raise RuntimeError(f"occupancy query failed for Dv {dvp}, {smem} B, cluster {cluster}")
    return n


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
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    lib.flash_attn_resident_ctas.argtypes = [ctypes.c_int] * 3
    lib.flash_attn_resident_ctas.restype = ctypes.c_int
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


def _kernel_checks(q, k, v) -> None:
    """Raise on what the kernel does not take (every launch runs these)."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must all be float32 or all bfloat16")
    if q.shape[3] > _MAX_DIM or v.shape[3] > _MAX_DIM:
        raise ValueError(f"head dims {q.shape[3]}/{v.shape[3]} exceed {_MAX_DIM}")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError(f"expected a unit feature stride, got strides {t.stride()}")


def _flash(launch: str, q, k, v, lengths, causal) -> tuple:
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
    _kernel_checks(q, k, v)
    _build.refuse_grad("flash_attention_v2" if launch == "flash_attn_v2_launch"
                       else "flash_attention", q, k, v)
    lens = None
    if lengths is not None:
        lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, l, h, dv), device=q.device, dtype=q.dtype)
    args = []
    for t in (q, k, v):
        args += [t.stride(0), t.stride(1), t.stride(2)]
    plan = None
    if q.dtype == torch.bfloat16:
        plan = (ctypes.c_int * 9)(*plan_for(q, k, v, v2=launch == "flash_attn_v2_launch").ints())
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(_lib(), launch)(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lens is None else lens.data_ptr(), b, l, h, kvh, dk, dv, *args,
        int(causal), 1.0 / math.sqrt(dk), plan, stream,
    )
    if err != 0:
        raise RuntimeError(f"{launch} failed: error {err} (a cudaError_t, or 1000 + the "
                           "CUresult of a TMA map encoding)")
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
    """``flash_attention`` on the K/V-resident schedule: a cluster of CTAs
    per (head, batch item) sharing each K/V tile. The same contract and the
    same outputs."""
    out, launched = _flash("flash_attn_v2_launch", q, k, v, lengths, causal)
    flash_attention_v2.launches += launched
    return out


flash_attention_v2.launches = 0
