"""Weight-only int8 quantization and the int8 weight matmul (K2).

Port of ``multimodal_embeddings_tpu/kernels/quantization.py``:

* ``QTensor``, ``compute_scale``, ``quantize_tensor`` and ``dequantize``:
  the same arithmetic (symmetric per-channel scales ``max|w| / 127``,
  round half to even, clip to ±127), bit for bit;
* ``int8_matmul``: replaces the Pallas TPU kernel ``int8_matmul``
  (``_mm_kernel``) with a hand-written CUDA kernel,
  ``csrc/int8_matmul.cu``: ``y = cast_x((x · bf16(q)) accumulated in f32
  · scale[N])``. The int8 weight is read from device memory as int8 and
  becomes bf16 only in shared memory;
* ``int8_apply``: a quantized 2-D weight applied to the last axis of x;
* ``stochastic_round_quantize``: unbiased int8 quantization,
  ``q = clip(floor(f32(w) / scale + u), −127, 127)`` with ``u`` uniform in
  [0, 1). ``_sr_quantize_2d`` replaces the Pallas TPU kernel ``_sr_kernel``
  with a hand-written CUDA kernel (K8), ``csrc/sr_quantize.cu``, elementwise
  over the 2-D collapse of w with an IEEE division, so it equals its plain
  version bit for bit on the same ``u``. The JAX package draws ``u`` with
  threefry; here it comes from a ``torch.Generator`` seeded with ``seed`` on
  w's device (other bits from the same seed), or from the caller (``u=``,
  the 2-D collapse's shape), which is how the tests hand both packages the
  same numbers.

K2's plain version follows the kernel's rounding, not the JAX package's CPU
fallback (which dequantizes first): products of x with the exact int8
values summed in f32, then the f32 scale, then one cast to x's dtype.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. ``int8_matmul.launches`` and
``_sr_quantize_2d.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "int8_matmul"
_SR_SOURCE = "sr_quantize"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class QTensor(NamedTuple):
    """int8 values + per-output-channel f32 scales."""

    q: torch.Tensor  # int8, the source tensor's shape
    scale: torch.Tensor  # f32, the source shape with contraction axes reduced to 1


def compute_scale(w: torch.Tensor, contract_axes: Sequence[int]) -> torch.Tensor:
    """Symmetric per-channel scale: max|w| over the contraction axes / 127."""
    amax = w.float().abs().amax(dim=tuple(contract_axes), keepdim=True)
    return amax.clamp_min(1e-8) / 127.0


def quantize_tensor(w: torch.Tensor, contract_axes: Sequence[int] = (0,)) -> QTensor:
    """Deterministic symmetric int8 quantization (round half to even)."""
    scale = compute_scale(w, contract_axes)
    q = torch.round(w.float() / scale).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.int8_matmul_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.int8_matmul_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def int8_matmul_reference(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of ``int8_matmul``."""
    y = torch.matmul(x.float(), q.float())
    return (y * scale.reshape(1, -1).float()).to(x.dtype)


def int8_matmul(
    x: torch.Tensor,  # (M, K) bf16 or f32
    q: torch.Tensor,  # (K, N) int8
    scale: torch.Tensor,  # (N,) or (1, N) f32
) -> torch.Tensor:
    """``x @ (q · scale)`` in x's dtype, with no bf16 copy of the weight in
    device memory."""
    if x.dim() != 2 or q.dim() != 2 or q.shape[0] != x.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} q {tuple(q.shape)}")
    m, k = x.shape
    n = q.shape[1]
    if q.dtype != torch.int8 or scale.numel() != n:
        raise ValueError(f"q must be int8 (got {q.dtype}) with {n} scales")
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale)
    if x.device.type != "cuda" or q.device != x.device or scale.device != x.device:
        raise ValueError(f"int8_matmul runs on cpu or one cuda device, not {x.device}")
    if x.dtype not in _DTYPE_CODES or scale.dtype != torch.float32:
        raise ValueError("x must be float32 or bfloat16 and scale float32")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    vec = k % 8 == 0 and n % 16 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().int8_matmul_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, k, n, int(vec), stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {err}")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def int8_apply(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Apply a quantized ``(K, N)`` weight to the last axis of ``x``."""
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]), qt.q, qt.scale)
    return y.reshape(*lead, qt.q.shape[-1])


# ---------------------------------------------------------------------------
# stochastic rounding (K8)
# ---------------------------------------------------------------------------


@functools.cache
def _sr_lib():
    """K8's library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SR_SOURCE)
    lib.sr_quantize_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    )
    lib.sr_quantize_launch.restype = ctypes.c_int
    return lib


def sr_build_info() -> _build.BuildInfo:
    """Build (or reuse) K8's library; returns its ``BuildInfo``."""
    _sr_lib()
    return _build.load(_SR_SOURCE)[1]


def sr_quantize_reference(w: torch.Tensor, scale_row: torch.Tensor, u: torch.Tensor):
    """Plain version of ``_sr_quantize_2d``."""
    return torch.floor(w.float() / scale_row + u).clamp(-127, 127).to(torch.int8)


def _sr_quantize_2d(
    w: torch.Tensor,  # (rows, cols) f32 or bf16
    scale_row: torch.Tensor,  # (1, cols) f32
    u: torch.Tensor,  # (rows, cols) f32 in [0, 1)
) -> torch.Tensor:
    """``clip(floor(f32(w) / scale_row + u), −127, 127)`` as int8."""
    rows, cols = w.shape
    if scale_row.shape != (1, cols) or u.shape != (rows, cols):
        raise ValueError(f"w {tuple(w.shape)}, scale {tuple(scale_row.shape)}, "
                         f"u {tuple(u.shape)}")
    if w.device.type == "cpu":
        return sr_quantize_reference(w, scale_row, u)
    if w.device.type != "cuda" or scale_row.device != w.device or u.device != w.device:
        raise ValueError(f"stochastic rounding runs on cpu or one cuda device, not {w.device}")
    if w.dtype not in _DTYPE_CODES or scale_row.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w must be float32 or bfloat16 ({w.dtype}), scale and u float32")
    w, scale_row, u = w.contiguous(), scale_row.contiguous(), u.contiguous()
    q = torch.empty((rows, cols), device=w.device, dtype=torch.int8)
    vec = cols % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (w, scale_row, u, q))
    err = _sr_lib().sr_quantize_launch(
        _DTYPE_CODES[w.dtype], w.data_ptr(), scale_row.data_ptr(), u.data_ptr(),
        q.data_ptr(), rows, cols, int(vec), torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"stochastic rounding launch failed: cudaError {err}")
    _sr_quantize_2d.launches += 1
    return q


_sr_quantize_2d.launches = 0


def sr_uniform(shape, seed: int, device) -> torch.Tensor:
    """The uniforms ``stochastic_round_quantize`` draws: f32 in [0, 1) from
    a ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def stochastic_round_quantize(
    w: torch.Tensor,
    contract_axes: Sequence[int] = (0,),
    seed: int = 0,
    *,
    u: Optional[torch.Tensor] = None,
) -> QTensor:
    """Unbiased int8 quantization, ``E[q·scale] = w``, with the JAX
    package's scales and layout: a rank > 2 weight is collapsed to (rows,
    channels), its contracted axes first, quantized, and restored. ``u``
    (the collapse's shape) replaces the seeded draw."""
    orig_shape = w.shape
    scale = compute_scale(w, contract_axes)
    perm = list(range(w.dim()))
    if w.dim() != 2:
        contracted = {a % w.dim() for a in contract_axes}
        kept = [a for a in perm if a not in contracted]
        perm = [a for a in perm if a not in kept] + kept
        w = w.permute(perm).reshape(-1, math.prod(orig_shape[a] for a in kept))
    s2 = scale.permute(perm).reshape(1, -1).expand(1, w.shape[1])
    q = _sr_quantize_2d(w, s2, sr_uniform(w.shape, seed, w.device) if u is None else u)
    if len(perm) != 2:
        inverse = sorted(range(len(perm)), key=perm.__getitem__)
        q = q.reshape([orig_shape[a] for a in perm]).permute(inverse).contiguous()
    return QTensor(q=q, scale=scale)
