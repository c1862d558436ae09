"""Row-wise LayerNorm statistics (K7).

Replaces the Pallas TPU kernel ``_ln_stats_kernel`` behind ``ln_stats`` of
``multimodal_embeddings_tpu/kernels/ln_stats.py``: the statistics half of
``FastLayerNorm`` (the normalise and the affine stay elementwise tensor
code). ``ln_stats`` launches a hand-written CUDA kernel, ``csrc/ln_stats.cu``
(what bounds it and what its design does about it is written at the top of
the source): one warp a row, 16-byte loads where the row and x's base
allow them, every launch programmatic (the next grid is placed while one
drains).

Contract (the kernel and the plain version), flax's one-pass formula: f32
sums of x and x², ``var = max(m2 − m², 0)``, ``rstd = rsqrt(var + eps)``;
outputs ``(B, L, 1)`` f32. No atomics: two calls give equal bits.

The JAX kernel's lane-sum strategy (``method``) and its VMEM row blocks
(``pick_row_block``) are TPU rules; ``pick_row_block`` is kept, verbatim,
so that the two packages' budgets can be compared, and gates nothing here.

Dispatch: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``ln_stats.launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "ln_stats"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# per-program VMEM budget for the (rb, D) tile: input dtype bytes + f32
# upcast + f32 square (conservatively itemsize+8 bytes/element), kept
# well under the ~16MB scoped limit (the chain-11 lesson).
_VMEM_TILE_BUDGET = 12 * 1024 * 1024


def pick_row_block(l: int, d: int, itemsize: int) -> int:
    """Largest row-block that divides L, is a multiple of 8 (f32 output
    sublane tile), and fits the per-program VMEM budget. 0 if none.

    Rows are independent for LayerNorm statistics, so row-chunking is
    exact — unlike attention, where columns couple through the softmax.
    The mme5 Mllama shape (1608, 1280) picks rb=536 (6.9MB); the ViT-B
    (784, 768) shape fits whole (rb=784)."""
    per_row = d * (itemsize + 8)
    best = 0
    for rb in range(8, l + 1, 8):
        if l % rb == 0 and rb * per_row <= _VMEM_TILE_BUDGET:
            best = rb
    return best


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.ln_stats_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    lib.ln_stats_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def ln_stats_reference(x: torch.Tensor, eps: float = 1e-6):
    """Plain version of ``ln_stats``."""
    xf = x.float()
    d = x.shape[-1]
    m = xf.sum(dim=-1, keepdim=True) / d
    m2 = (xf * xf).sum(dim=-1, keepdim=True) / d
    var = (m2 - m * m).clamp_min(0.0)
    return m, torch.rsqrt(var + eps)


def ln_stats(x: torch.Tensor, eps: float = 1e-6):
    """``(B, L, D)`` → (mean, rstd), each ``(B, L, 1)`` float32."""
    if x.dim() != 3:
        raise ValueError(f"ln_stats takes (B, L, D), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ln_stats_reference(x, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_stats runs on cpu or cuda, not {x.device}")
    _build.refuse_grad("ln_stats", x)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {x.dtype} (float32 or bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"x must be contiguous, got strides {x.stride()}")
    b, l, d = x.shape
    mean = torch.empty((b, l, 1), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    err = _lib().ln_stats_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b * l, d,
        eps, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ln_stats launch failed: cudaError {err}")
    ln_stats.launches += 1
    return mean, rstd


ln_stats.launches = 0
