"""3×3 convolutions with a fused bias and SiLU (K5): stride 1 SAME with a
dilation, and the stride-2 form.

Replaces two Pallas TPU kernels of ``multimodal_embeddings_tpu/kernels/
conv.py`` with ONE hand-written CUDA kernel body, ``csrc/conv3x3.cu`` (an
implicit GEMM over the channels-last layout whose stride is a parameter of
the halo tile's addresses; what bounds it and what its design does about
that is written at the top of the source):

* ``conv3x3_nchw`` (``_conv3x3_kernel``): stride 1, zero SAME padding of
  ``dilation`` on every side, any H and W — the GL-CRM bottleneck's dilated
  "global" and plain "local" 3×3s with the BatchNorm folded into the weights.
  x and the weights in the compute dtype, the bias f32;
* ``conv3x3_s2_nchw`` (``_conv3x3_s2_kernel``): stride 2, lax ``SAME``,
  which for the even H and W it requires (ValueError otherwise) pads 0 rows
  and columns on top/left and 1 on bottom/right: output (y′, x′) reads input
  (2y′+dy, 2x′+dx), dy, dx ∈ {0, 1, 2}, and rows or columns ≥ H or W read 0.
  The weight is cast to x's dtype, the bias to f32 (zeros when None). This
  is NOT the detector's stride-2 ``ConvBnAct``, which pads 1 on every side
  (``models/layers.py::autopad``); as in the JAX package, no model calls it.

Contract of both (the kernel and the plain versions): f32 accumulation over
the 9·C taps, plus the f32 bias, then SiLU in f32, rounded once to x's dtype.

Layout: x is ``(N, C, H, W)`` as in the JAX package, and on the card it must
be stored channels-last (unit channel stride: ``torch.channels_last``, the
detector's memory format, or a channel slice of such a tensor, as the CSP
stages hand their halves on): the kernel reads it in place through its
strides and writes a contiguous channels-last output. The JAX ``rows``
and ``interpret`` arguments tile and emulate the TPU grid and have no
counterpart here.

Dispatch: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
launches the kernel or raises. A bf16 launch takes the form ``_plan``
chooses before it: the halo path (TMA, or ``cp.async`` for an x TMA cannot
take), the tile, the cluster of CTAs sharing one halo, the channel chunks,
the ring's stages, the shared-memory bytes and the persistent grid.
``conv3x3_nchw.launches`` and ``conv3x3_s2_nchw.launches`` count the kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multimodal_embeddings_tpu_torch.kernels import _build
from multimodal_embeddings_tpu_torch.kernels.flash_attention import _copy_width
from multimodal_embeddings_tpu_torch.kernels.flash_attention import _tma_ok as _strides_tma_ok

_SOURCE = "conv3x3"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "silu": 1}
_BN, _WLD, _TW = 48, 56, 16  # output channels per CTA, epilogue row, tile width
_STAGES, _MAX_CLUSTER = (4, 3, 2), 8
_SMS, _MAX_SMEM = 132, 232448
_EPILOGUE = 4 * 16 * _WLD * 2  # a consumer warpgroup's epilogue rows, in its stage
_BARRIERS = 8 * (3 * 4 + 1) + 4 * _BN  # and the CTA's 48 biases


class Plan(NamedTuple):
    """One bf16 launch's form. ``path``: how the halo reaches shared memory,
    ``"tma"`` or ``"cp.async"``, and ``width`` the bytes per copy on the
    latter (16, 8, 4, or 2 by plain loads; 0 on TMA); ``tile``: output
    pixels (rows, columns) per consumer warpgroup's step, 16 or 8 rows of
    16; ``phase``: 1 for dense tiles, d for
    polyphase tiles (every d-th pixel, where a dense halo would not fit);
    ``cluster``: CTAs sharing one halo, each with its own 48 output
    channels; ``groups``: clusters of distinct channels that each load the
    halo for themselves; ``nchunks`` channel chunks of ``pc`` channels
    (padded to 16) each, the weights resident when there is one; the halo
    ``stages`` (2-4, each taken by the consumer warpgroup of its tile); the
    dynamic shared-memory bytes; the persistent ``grid``."""

    path: str
    width: int
    tile: tuple
    phase: int
    cluster: int
    groups: int
    nchunks: int
    pc: int
    stages: int
    smem: int
    grid: tuple

    def ints(self) -> list:
        """The plan as the C entry point takes it."""
        return [self.width, self.tile[0] // 4, self.phase, self.cluster, self.groups,
                self.nchunks, self.pc, self.stages, self.smem, self.grid[0] // self.cluster]


def _atoms(pc: int) -> list:
    """The channel boxes of a chunk padded to 16: 64s, then 32, then 16."""
    out, rest = [64] * (pc // 64), pc % 64
    if rest >= 32:
        out.append(32)
        rest -= 32
    if rest:
        out.append(16)
    return out


def _kp(pc: int) -> int:
    """The weight matrix's depth, 9 taps × pc, padded to the 64-deep atoms."""
    return -(-9 * pc // 64) * 64


def _round1k(nbytes: int) -> int:
    return -(-nbytes // 1024) * 1024


def _smem_bytes(pc: int, nchunks: int, hh: int, hw: int, stages: int) -> int:
    """Resident weights (one chunk), the stages (each box 1024-aligned, then
    a chunk's weights when chunked; at least a warpgroup's epilogue rows),
    the barriers and biases (the source's ``layout``)."""
    weights = _round1k(_BN * _kp(pc) * 2)
    stage = sum(_round1k(hh * hw * 2 * w) for w in _atoms(pc)) + (weights if nchunks > 1 else 0)
    stage = max(stage, _round1k(_EPILOGUE))
    return 1024 + (weights if nchunks == 1 else 0) + stages * stage + _BARRIERS


def _tma_ok(ptr: int, c: int, strides, extents) -> bool:
    """TMA takes x at a 16-byte-aligned base with 2C and the (batch, row,
    pixel) strides in bytes multiples of 16, on the dims of extent > 1."""
    return (2 * c) % 16 == 0 and _strides_tma_ok(ptr, strides, extents)


@functools.lru_cache(maxsize=512)
def _plan(n: int, c: int, h: int, w: int, cout: int, oh: int, ow: int, stride: int,
          dilation: int, ptr_mod16: int, strides: tuple, resident=None) -> Plan:
    """The bf16 launch plan of an (n, c, h, w) x with (batch, row, pixel)
    element ``strides`` and a base address ≡ ``ptr_mod16`` (mod 16). The
    first form that fits 227 KB with 2 stages, in this order: dense tiles
    before polyphase ones (a dilation whose halo is too large); the fewest
    channel chunks (1: resident weights); 16 tile rows before 8; then as
    many stages as fit, up to 4. Clusters of ceil(Cout / 48) CTAs, split into the
    fewest groups that keep a cluster at 8 or less and one cluster
    resident. ``resident(mr, smem, q)`` is how many CTAs in
    clusters of q the card holds at once (the card's answer in
    ``plan_for``); by default one CTA on each of 132 SMs. The grid: that
    many clusters per group, at most one per tile."""
    extents = (n, h, w)
    tma = _tma_ok(ptr_mod16, c, strides, extents)
    form = None
    phases = (1, dilation) if stride == 1 and dilation > 1 else (1,)
    for phase in phases:
        td, dense_tma = dilation // phase, tma and phase == 1
        for nchunks in range(1, -(-c // 16) + 1):
            pc = -(-(-(-c // nchunks)) // 16) * 16
            if pc * (nchunks - 1) >= c:
                continue  # an empty chunk
            for mr in (4, 2):
                hh, hw = (4 * mr - 1) * stride + 2 * td + 1, (_TW - 1) * stride + 2 * td + 1
                if dense_tma and max(hh, hw) > 256:
                    continue  # a TMA box holds at most 256 rows or columns
                fits = [s for s in _STAGES if _smem_bytes(pc, nchunks, hh, hw, s) <= _MAX_SMEM]
                if fits:
                    form = (phase, dense_tma, nchunks, pc, mr, fits[0],
                            _smem_bytes(pc, nchunks, hh, hw, fits[0]))
                    break
            if form:
                break
        if form:
            break
    phase, on_tma, nchunks, pc, mr, stages, smem = form
    if resident is None:
        def resident(mr, smem, q):
            return _SMS // q * q
    nblk = -(-cout // _BN)
    for groups in range(-(-nblk // _MAX_CLUSTER), nblk + 1):
        cluster = -(-nblk // groups)
        fit = resident(mr, smem, cluster)
        if fit >= cluster:
            break
    else:
        raise RuntimeError(f"no CTA of the 3x3 conv fits the card ({smem} B shared)")
    sub_h, sub_w = -(-oh // phase), -(-ow // phase)
    tiles = n * phase * phase * -(-sub_h // (4 * mr)) * -(-sub_w // _TW)
    clusters = max(1, min(tiles, fit // cluster // groups))
    return Plan("tma" if on_tma else "cp.async",
                0 if on_tma else _copy_width(ptr_mod16, strides, extents), (4 * mr, _TW),
                phase, cluster, groups, nchunks, pc, stages, smem, (clusters * cluster, groups))


def plan_for(x: torch.Tensor, cout: int, stride: int, dilation: int, out_hw) -> Plan:
    """The plan a bf16 launch on this x takes."""
    n, c, h, w = x.shape
    sn, _, sh, sw = x.stride()
    return _plan(n, c, h, w, cout, *out_hw, stride, dilation, x.data_ptr() % 16,
                 (sn, sh, sw), _resident_ctas if x.is_cuda else None)


@functools.lru_cache(maxsize=512)
def _plan_array(plan: Plan):
    """The plan's ints as the C array the entry point takes (made once)."""
    return (ctypes.c_int * 10)(*plan.ints())


@functools.cache
def _resident_ctas(mr: int, smem: int, cluster: int) -> int:
    """CTAs of the bf16 kernel the card holds at once in clusters of
    ``cluster`` (the CUDA occupancy calls)."""
    got = _lib().conv3x3_resident_ctas(mr, smem, cluster)
    if got < 0:
        raise RuntimeError(f"occupancy query failed for {4 * mr} tile rows, {smem} B, "
                           f"cluster {cluster}")
    return got


def _weights(w: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The weights in the bf16 kernel's layout, (groups·cluster, chunks,
    kp / 64, 48, 64): per block of 48 output channels and channel chunk, the
    (48, 9·pc) matrix whose column tap·pc + c holds input channel j·pc + c
    (zeros past C, Cout and 9·pc), in 64-deep atoms of 48 rows, each row's
    16-byte pieces swizzled as ``wgmma`` reads them (piece q of row n at q
    XOR n mod 8). Kept on ``w`` until w changes (its data pointer or
    ``_version``) or the plan does, so a layer's weight is laid out once.
    An inference tensor has no ``_version`` and may change in place inside
    ``torch.inference_mode()`` unseen, so its layout is made anew on every
    call."""
    cout, c = w.shape[:2]
    nb, kp = plan.groups * plan.cluster, _kp(plan.pc)
    key = None if w.is_inference() else (w.data_ptr(), w._version, nb, plan.nchunks, plan.pc)
    cached = getattr(w, "_k5_layout", None)
    if key is not None and cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        out = _pack(w, nb, kp, plan.nchunks, plan.pc, cout, c)
    if key is not None:
        w._k5_layout = (key, out)
    return out


def _pack(w, nb, kp, nchunks, pc, cout, c):
    """``_weights``'s layout of w, computed."""
    wp = F.pad(w, (0, 0, 0, 0, 0, nchunks * pc - c, 0, nb * _BN - cout))
    mat = wp.new_zeros((nb, nchunks, _BN, kp))
    mat[..., :9 * pc] = wp.reshape(nb, _BN, nchunks, pc, 9).permute(
        0, 2, 1, 4, 3).reshape(nb, nchunks, _BN, 9 * pc)
    atoms = mat.view(nb, nchunks, _BN, kp // 64, 8, 8).permute(0, 1, 3, 2, 4, 5)
    rows = torch.arange(_BN, device=w.device).view(_BN, 1, 1) % 8
    piece = (torch.arange(8, device=w.device).view(1, 8, 1) ^ rows).expand(_BN, 8, 8)
    return atoms.gather(-2, piece.expand(atoms.shape)).reshape(nb, nchunks, kp // 64, _BN, 64)


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.conv3x3_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    )
    lib.conv3x3_launch.restype = ctypes.c_int
    lib.conv3x3_resident_ctas.argtypes = [ctypes.c_int] * 3
    lib.conv3x3_resident_ctas.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def conv3x3_reference(x, w, bias=None, act: str = "none", dilation: int = 1) -> torch.Tensor:
    """Plain version of ``conv3x3_nchw``: the f32 convolution of x and w
    cast to x's dtype, plus the f32 bias, then SiLU, cast to x's dtype."""
    if act not in _ACTS:
        raise ValueError(f"act must be 'none' or 'silu', not {act!r}")
    out = F.conv2d(x.float(), w.to(x.dtype).float(), padding=dilation, dilation=dilation)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def conv3x3_s2_reference(x, w, bias=None, act: str = "none") -> torch.Tensor:
    """Plain version of ``conv3x3_s2_nchw``: the f32 stride-2 convolution of
    x, padded 1 on the bottom and the right, and w cast to x's dtype, plus
    the f32 bias, then SiLU, cast to x's dtype."""
    if act not in _ACTS:
        raise ValueError(f"act must be 'none' or 'silu', not {act!r}")
    out = F.conv2d(F.pad(x.float(), (0, 1, 0, 1)), w.to(x.dtype).float(), stride=2)
    if bias is not None:
        out = out + bias.float().reshape(1, -1, 1, 1)
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def _check_operands(x, w, bias, act):
    c, cout = x.shape[1], w.shape[0]
    if w.shape != (cout, c, 3, 3):
        raise ValueError(f"weight {tuple(w.shape)} is not ({cout}, {c}, 3, 3)")
    if bias is not None and bias.shape != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({cout},)")
    if act not in _ACTS:
        raise ValueError(f"act must be 'none' or 'silu', not {act!r}")


def _launch(x, w, bias, act, stride, pad, dilation, out_hw) -> torch.Tensor:
    """One kernel launch on a CUDA x: checks, the weights in the kernel's
    layout, a contiguous channels-last output of ``out_hw``."""
    n, c, h, width = x.shape
    cout = w.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"the 3x3 conv runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a dtype (f32 or bf16) "
                         "and a device")
    sn, sc, sh, sw = x.stride()
    if sc != 1 and c > 1:
        raise ValueError(f"x must be channels-last (unit channel stride), got strides "
                         f"{x.stride()}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != x.device:
            raise ValueError(f"bias must be f32 on {x.device}, got {bias.dtype} on {bias.device}")
        bias = bias.contiguous()
    plan = None
    if x.dtype == torch.float32:
        wt = w.permute(2, 3, 1, 0).contiguous()  # (9, C, Cout): row tap·C + c
    else:
        form = plan_for(x, cout, stride, dilation, out_hw)
        wt = _weights(w, form)
        plan = _plan_array(form)
    out = torch.empty((n, cout, *out_hw), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    err = _lib().conv3x3_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), wt.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, width, c, cout, *out_hw, sn, sh, sw, stride, pad, dilation, _ACTS[act], plan,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: cudaError {err}")
    return out


def conv3x3_nchw(
    x: torch.Tensor,  # (N, C, H, W)
    w: torch.Tensor,  # (Cout, C, 3, 3), cast to x's dtype
    bias=None,  # (Cout,) f32
    *,
    act: str = "none",  # "none" | "silu"
    dilation: int = 1,
) -> torch.Tensor:
    """Stride-1 SAME 3×3 conv (+ optional f32 bias and SiLU) of an
    ``(N, C, H, W)`` tensor → ``(N, Cout, H, W)`` in x's dtype; on the card
    x is channels-last and so is the result."""
    _check_operands(x, w, bias, act)
    if dilation < 1:
        raise ValueError(f"dilation {dilation}")
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias, act, dilation)
    _build.refuse_grad("conv3x3_nchw", x, w, bias)
    out = _launch(x, w.to(x.dtype), bias, act, 1, dilation, dilation, x.shape[2:])
    conv3x3_nchw.launches += 1
    return out


conv3x3_nchw.launches = 0


def conv3x3_s2_nchw(
    x: torch.Tensor,  # (N, C, H, W), H and W even
    w: torch.Tensor,  # (Cout, C, 3, 3), cast to x's dtype
    bias=None,  # (Cout,), cast to f32
    *,
    act: str = "none",  # "none" | "silu"
) -> torch.Tensor:
    """Stride-2 lax-SAME 3×3 conv (+ optional bias and SiLU) of an
    ``(N, C, H, W)`` tensor with even H and W → ``(N, Cout, H/2, W/2)`` in
    x's dtype; on the card x is channels-last and so is the result."""
    _check_operands(x, w, bias, act)
    h, width = x.shape[2:]
    if h % 2 or width % 2:
        raise ValueError(f"the stride-2 conv takes even H and W, got {h}x{width}")
    if x.device.type == "cpu":
        return conv3x3_s2_reference(x, w, bias, act)
    _build.refuse_grad("conv3x3_s2_nchw", x, w, bias)
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32)
    out = _launch(x, w.to(x.dtype), bias, act, 2, 0, 1, (h // 2, width // 2))
    conv3x3_s2_nchw.launches += 1
    return out


conv3x3_s2_nchw.launches = 0
