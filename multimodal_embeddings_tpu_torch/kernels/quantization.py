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
* ``int8_apply``: a quantized 2-D weight applied to the last axis of x.

The plain version follows the kernel's rounding, not the JAX package's CPU
fallback (which dequantizes first): products of x with the exact int8
values summed in f32, then the f32 scale, then one cast to x's dtype.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. ``int8_matmul.launches`` counts kernel launches.
``stochastic_round_quantize`` (TPU PRNG rounding, off the serving path) is
not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "int8_matmul"
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
