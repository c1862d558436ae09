"""Weight-only packed-int4 quantization and the int4 weight matmul (K3).

Port of ``multimodal_embeddings_tpu/kernels/quantization_int4.py``:

* ``Q4Tensor``, ``int4_group_size``, ``quantize_tensor_int4``,
  ``unpack_int4`` and ``dequantize_int4``: the same layout and arithmetic,
  bit for bit. A ``(K, N)`` weight is split into groups of ``G`` rows (128,
  or one group when ``K < 128`` or ``K % 128 ≠ 0``); within a group the first
  ``G/2`` rows are the low nibbles and the last ``G/2`` the high nibbles of a
  ``(G/2, N)`` uint8 block; a nibble stores ``q + 8``. Scales are f32
  ``(n_groups, N)``, ``max|w|_group / 7``;
* ``int4_matmul``: replaces the Pallas TPU kernel ``int4_matmul``
  (``_mm4_kernel``) with a hand-written CUDA kernel, ``csrc/int4_matmul.cu``:
  per group, ``part = bf16(x_g) · q_g`` summed in f32, then
  ``acc += part · scale[g]``; one cast to x's type at the end. **x is rounded
  to bf16 even when it is f32**, as in the TPU kernel;
* ``int4_apply``: a packed 2-D weight applied to the last axis of x.

The plain version follows the kernel's rounding, not the JAX package's CPU
fallback, which dequantizes first and does not round x.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches
the kernel or raises. ``int4_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "int4_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the GEMV form (M <= 4): 128 output columns per block; below this many
# column tiles the packed rows are split over blocks as well, so that every
# SM has two blocks' loads in flight
_GEMV_MAX_M = 4
_GEMV_COLS = 128
_GEMV_MIN_BLOCKS = 264
_GEMV_MIN_ROWS_PER_SPLIT = 256
_counters: dict = {}


class Q4Tensor(NamedTuple):
    """Packed int4 values + per-(group, output-channel) scales."""

    packed: torch.Tensor  # uint8 (K/2, N), two offset-binary nibbles per byte
    scale: torch.Tensor  # f32 (n_groups, N); group size G = K / n_groups


def int4_group_size(k: int, group_size: int = 128) -> int:
    """The scale-group size used for a ``K``-row weight: ``group_size`` when
    it divides ``K``, else one group."""
    if k % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, got {k}")
    if k >= group_size and k % group_size == 0 and group_size % 2 == 0:
        return group_size
    return k


def quantize_tensor_int4(w: torch.Tensor, group_size: int = 128) -> Q4Tensor:
    """Symmetric group-wise int4 quantization of a 2-D ``(K, N)`` weight:
    ``q = clip(round(w / scale), -8, 7)``, ``scale = max|w|_group / 7``
    (floored at 1e-8 / 7), round half to even."""
    if w.dim() != 2:
        raise ValueError(f"expected a 2-D weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    g = int4_group_size(k, group_size)
    n_groups = k // g
    wg = w.float().reshape(n_groups, g, n)
    amax = wg.abs().amax(dim=1, keepdim=True)
    scale = amax.clamp_min(1e-8) / 7.0
    q = torch.round(wg / scale).clamp(-8, 7).to(torch.int32) + 8
    packed = (q[:, : g // 2] | (q[:, g // 2 :] << 4)).to(torch.uint8).reshape(k // 2, n)
    return Q4Tensor(packed=packed, scale=scale.reshape(n_groups, n))


def unpack_int4(qt: Q4Tensor) -> torch.Tensor:
    """Offset-binary unpack to int32 values in [-8, 7], ``(K, N)``."""
    k2, n = qt.packed.shape
    n_groups = qt.scale.shape[0]
    p = qt.packed.reshape(n_groups, k2 // n_groups, n).to(torch.int32)
    return torch.cat([(p & 15) - 8, (p >> 4) - 8], dim=1).reshape(2 * k2, n)


def dequantize_int4(qt: Q4Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``(K, N)`` dequantized weight: f32 scale multiply, then cast."""
    k2, n = qt.packed.shape
    n_groups = qt.scale.shape[0]
    vals = unpack_int4(qt).reshape(n_groups, -1, n).float()
    w = vals * qt.scale.float().reshape(n_groups, 1, n)
    return w.reshape(2 * k2, n).to(dtype)


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.int4_matmul_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    )
    lib.int4_matmul_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def gemv_splits(k: int, n: int) -> int:
    """How many parts the GEMV form cuts the K/2 packed rows into."""
    tiles = -(-n // _GEMV_COLS)
    if tiles >= _GEMV_MIN_BLOCKS:
        return 1
    return max(1, min(-(-_GEMV_MIN_BLOCKS // tiles), (k // 2) // _GEMV_MIN_ROWS_PER_SPLIT))


def _split_counters(device, n: int) -> torch.Tensor:
    """Zeroed int32 arrival counters of the split GEMV, one per column tile,
    kept per device (the kernel leaves them zero)."""
    t = _counters.get(device)
    if t is None or t.numel() < n:
        t = _counters[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return t


def int4_matmul_reference(
    x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of ``int4_matmul``: the TPU kernel's group loop."""
    m, k = x.shape
    n = packed.shape[1]
    n_groups = scale.shape[0]
    g = k // n_groups
    xb = x.to(torch.bfloat16).float()
    blocks = packed.reshape(n_groups, g // 2, n)
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(n_groups):
        p = blocks[i].to(torch.int32)
        w = torch.cat([(p & 15) - 8, (p >> 4) - 8]).float()
        part = torch.matmul(xb[:, i * g : (i + 1) * g], w)
        acc += part * scale[i].float()
    return acc.to(x.dtype)


def int4_matmul(
    x: torch.Tensor,  # (M, K) bf16 or f32
    packed: torch.Tensor,  # (K/2, N) uint8
    scale: torch.Tensor,  # (n_groups, N) f32
) -> torch.Tensor:
    """``bf16(x) @ dequant(packed, scale)`` in x's dtype, with no bf16 copy
    of the weight in device memory."""
    if x.dim() != 2 or packed.dim() != 2 or scale.dim() != 2:
        raise ValueError(f"bad ranks x {x.dim()} packed {packed.dim()} scale {scale.dim()}")
    m, k = x.shape
    n = packed.shape[1]
    n_groups = scale.shape[0]
    if packed.shape[0] * 2 != k or scale.shape[1] != n or n_groups < 1 or k % n_groups:
        raise ValueError(
            f"bad shapes x {tuple(x.shape)} packed {tuple(packed.shape)} scale {tuple(scale.shape)}"
        )
    if (k // n_groups) % 2 or packed.dtype != torch.uint8:
        raise ValueError(f"packed must be uint8 (got {packed.dtype}) with even groups")
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    if x.device.type != "cuda" or packed.device != x.device or scale.device != x.device:
        raise ValueError(f"int4_matmul runs on cpu or one cuda device, not {x.device}")
    if x.dtype not in _DTYPE_CODES or scale.dtype != torch.float32:
        raise ValueError("x must be float32 or bfloat16 and scale float32")
    xb = x.to(torch.bfloat16).contiguous()
    packed, scale = packed.contiguous(), scale.contiguous()
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    splits = gemv_splits(k, n) if m <= _GEMV_MAX_M else 1
    ws = counters = None  # the split GEMV's f32 partials and arrival counters
    if splits > 1:
        ws = torch.empty((splits, m, n), device=x.device, dtype=torch.float32)
        counters = _split_counters(x.device, -(-n // _GEMV_COLS))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().int4_matmul_launch(
        _DTYPE_CODES[x.dtype], xb.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, k, n, n_groups, splits,
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: cudaError {err}")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0


def int4_apply(x: torch.Tensor, qt: Q4Tensor) -> torch.Tensor:
    """Apply a packed int4 ``(K, N)`` weight to the last axis of ``x``."""
    lead = x.shape[:-1]
    y = int4_matmul(x.reshape(-1, x.shape[-1]), qt.packed, qt.scale)
    return y.reshape(*lead, qt.packed.shape[-1])
