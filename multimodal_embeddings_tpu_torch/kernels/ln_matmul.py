"""LayerNorm fused into the following matrix product (K6).

Replaces the Pallas TPU kernels ``_ln_mm_kernel`` and ``_ln_mm_bias_kernel``
behind ``ln_matmul`` of ``multimodal_embeddings_tpu/kernels/ln_matmul.py``:
the pre-LN blocks' ln1 → ``[Wq|Wk|Wv]`` and ln2 → fc1 without the
normalised activations' round trip through device memory. ``ln_matmul``
launches ONE hand-written CUDA kernel, ``csrc/ln_matmul.cu`` (a tensor-core
matmul with a LayerNorm prologue; what bounds it and what its design does
about that is written at the top of the source).

Contract (both the kernel and the plain version): μ = mean(x) in f32, a
TWO-pass variance mean((x − μ)²) — not ``FastLayerNorm``'s one-pass formula
— then ``xn = (x − μ)·rsqrt(var + eps)·γ + β`` in f32, rounded to x's dtype
before the product; f32 accumulation, the product rounded to x's dtype; with
a bias, ``round(acc) + bias`` in x's dtype (so it rounds twice).

The JAX ``block_m``/``block_n`` arguments tile the TPU grid and have no
counterpart here; the kernel takes any M, K and N.

Dispatch: a CPU tensor goes to the plain PyTorch version; a CUDA tensor
launches the kernel or raises. ``ln_matmul.launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "ln_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.ln_matmul_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.ln_matmul_launch.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def ln_matmul_reference(x, gamma, beta, w, bias=None, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of ``ln_matmul``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xn = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    out = torch.matmul(xn.to(x.dtype).float(), w.float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def ln_matmul(
    x: torch.Tensor,  # (M, K)
    gamma: torch.Tensor,  # (K,)
    beta: torch.Tensor,  # (K,)
    w: torch.Tensor,  # (K, N)
    bias=None,  # (N,) projection bias
    eps: float = 1e-6,
) -> torch.Tensor:
    """``LayerNorm(x; gamma, beta) @ w [+ bias]`` in one kernel → (M, N) in
    x's dtype."""
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k or gamma.shape != (k,) or beta.shape != (k,):
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if bias is not None and bias.shape != (n,):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({n},)")
    if x.device.type == "cpu":
        return ln_matmul_reference(x, gamma, beta, w, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_matmul runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a dtype (f32 or bf16)")
    if bias is not None and bias.dtype != x.dtype:
        raise ValueError(f"bias {bias.dtype} must be in x's dtype {x.dtype}")
    operands = [x, w] + ([] if bias is None else [bias])
    for t in operands + [gamma, beta]:
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    for t in operands:
        if not t.is_contiguous():
            raise ValueError(f"expected contiguous operands, got strides {t.stride()}")
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    out = torch.empty((m, n), device=x.device, dtype=x.dtype)
    vec = int(k % 8 == 0 and n % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w, gamma, beta)))
    err = _lib().ln_matmul_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, k, n, eps, vec, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ln_matmul launch failed: cudaError {err}")
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0
