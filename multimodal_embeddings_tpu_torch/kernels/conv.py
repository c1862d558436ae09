"""3×3 convolutions with a fused bias and SiLU (K5): stride 1 SAME with a
dilation, and the stride-2 form.

Replaces two Pallas TPU kernels of ``multimodal_embeddings_tpu/kernels/
conv.py`` with ONE hand-written CUDA kernel, ``csrc/conv3x3.cu`` (an implicit
GEMM over the channels-last layout whose stride is a parameter of the gather;
what bounds it and what its design does about that is written at the top of
the source):

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
launches the kernel or raises. ``conv3x3_nchw.launches`` and
``conv3x3_s2_nchw.launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "conv3x3"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"none": 0, "silu": 1}


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.conv3x3_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.conv3x3_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def conv3x3_reference(x, w, bias=None, act: str = "none", dilation: int = 1) -> torch.Tensor:
    """Plain version of ``conv3x3_nchw``: the f32 convolution of x and w as
    given, plus the f32 bias, then SiLU, cast to x's dtype."""
    if act not in _ACTS:
        raise ValueError(f"act must be 'none' or 'silu', not {act!r}")
    out = F.conv2d(x.float(), w.float(), padding=dilation, dilation=dilation)
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
    """One kernel launch on a CUDA x: checks, the (9, C, Cout) weight
    matrix, a contiguous channels-last output of ``out_hw``."""
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
    # (9, C, Cout): row tap·C + c of the implicit GEMM's weight matrix
    wt = w.permute(2, 3, 1, 0).contiguous()
    out = torch.empty((n, cout, *out_hw), device=x.device, dtype=x.dtype,
                      memory_format=torch.channels_last)
    vec = int(all(v % 8 == 0 for v in (c, cout, sn, sh, sw))
              and all(t.data_ptr() % 16 == 0 for t in (x, wt, out)))
    err = _lib().conv3x3_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), wt.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        n, h, width, c, cout, *out_hw, sn, sh, sw, stride, pad, dilation, _ACTS[act], vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: cudaError {err}")
    return out


def conv3x3_nchw(
    x: torch.Tensor,  # (N, C, H, W)
    w: torch.Tensor,  # (Cout, C, 3, 3)
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
    out = _launch(x, w, bias, act, 1, dilation, dilation, x.shape[2:])
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
    if bias is not None:
        bias = bias.to(device=x.device, dtype=torch.float32)
    out = _launch(x, w.to(x.dtype), bias, act, 2, 0, 1, (h // 2, width // 2))
    conv3x3_s2_nchw.launches += 1
    return out


conv3x3_s2_nchw.launches = 0
