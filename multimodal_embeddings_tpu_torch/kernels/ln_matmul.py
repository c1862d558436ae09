"""LayerNorm fused into the following matrix product (K6).

Replaces the Pallas TPU kernels ``_ln_mm_kernel`` and ``_ln_mm_bias_kernel``
behind ``ln_matmul`` of ``multimodal_embeddings_tpu/kernels/ln_matmul.py``:
the pre-LN blocks' ln1 → ``[Wq|Wk|Wv]`` and ln2 → fc1 without the
normalised activations' round trip through device memory. ``ln_matmul``
launches hand-written CUDA kernels, ``csrc/ln_matmul.cu`` (what bounds them
and what their design does about it is written at the top of the source).
A launch takes one of three forms (``ln_mm_form``, the launcher's rule
mirrored):

- ``wgmma`` (bf16, K % 8 == 0, N % 8 == 0, x, w and the bias on 16-byte
  boundaries, K ≤ 8,384; every path shape): persistent CTAs, one per SM,
  each walking a contiguous run of (128-row block, 256-column tile) units
  in row-block-major order (``ln_mm_wgmma_plan``), so a row block's
  statistics are computed once per CTA that enters it; a TMA ring of raw x
  and w chunks; x normalised in registers as ``wgmma``'s A operand;
- ``mma_sync`` (every other bf16 shape): ``mma.sync`` tiles with the
  statistics recomputed per N tile;
- ``f32`` (f32, checks only): CUDA cores.

Contract (every form and the plain version): μ = mean(x) in f32, a
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
from typing import NamedTuple

import torch

from multimodal_embeddings_tpu_torch.kernels import _build

_SOURCE = "ln_matmul"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C launcher's form codes, and the wgmma form's tile (rows of x ×
# columns of w), chunk (columns of x per ring stage), ring stages and the
# shared-memory budget they fit (``ln_mm_wgmma_config`` in the source;
# chip_smoke.py holds them equal)
_FORMS = ("f32", "mma_sync", "wgmma")
_WG_TILE_M, _WG_TILE_N, _WG_CHUNK = 128, 256, 64
_WG_STAGES = (4, 3)
_SMEM_LIMIT = 232448
# the ring's stage (x 128 × 64 and w 64 × 256 bf16), the epilogue's staging
# (8 warps × 16 rows × 64 bf16), the barriers, and the alignment of the base
_WG_STAGE_BYTES = 2 * (_WG_TILE_M + _WG_TILE_N) * _WG_CHUNK
_WG_STAGING, _WG_BARS, _WG_ALIGN = 8 * 16 * 128, 64, 1024
# (m, k, n, device index) -> the wgmma launch's grid
_grids: dict = {}


@functools.cache
def _lib():
    """The built library with its C signature declared (first call builds)."""
    lib, _ = _build.load(_SOURCE)
    lib.ln_matmul_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.ln_matmul_launch.restype = ctypes.c_int
    lib.ln_matmul_form.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.ln_matmul_form.restype = ctypes.c_int
    lib.ln_mm_wgmma_resident_ctas.argtypes = []
    lib.ln_mm_wgmma_resident_ctas.restype = ctypes.c_int
    lib.ln_mm_wgmma_config.argtypes = [ctypes.c_int] * 2
    lib.ln_mm_wgmma_config.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def wgmma_smem(k: int, stages: int) -> int:
    """Shared memory of a wgmma launch at rows of ``k``: the ring, the
    epilogue's staging, γ and β interleaved (8 bytes per column, padded to
    whole chunks), the barriers and the base's alignment."""
    k_pad = -(-k // _WG_CHUNK) * _WG_CHUNK
    return _WG_ALIGN + stages * _WG_STAGE_BYTES + _WG_STAGING + 8 * k_pad + _WG_BARS


@functools.lru_cache(maxsize=256)
def wgmma_stages(k: int) -> int:
    """The ring's stages at rows of ``k``: the most of ``_WG_STAGES`` that
    fit the card's 232,448 bytes of shared memory a block, 0 where none do
    (k > 8,384: the wgmma form refuses it)."""
    return next((s for s in _WG_STAGES if wgmma_smem(k, s) <= _SMEM_LIMIT), 0)


def ln_mm_form(m: int, k: int, n: int, aligned: bool = True,
               dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel form a launch takes, by the launcher's rule
    (``csrc/ln_matmul.cu::form_of``): ``"f32"`` for f32 operands;
    ``"wgmma"`` for bf16 where TMA can describe x and w (k % 8 == 0 and
    n % 8 == 0, x, w and the bias on 16-byte boundaries: ``aligned``) and
    the ring fits (``wgmma_stages(k) > 0``); ``"mma_sync"`` for every other
    bf16 shape. Every m takes the same form."""
    del m
    if dtype == torch.float32:
        return "f32"
    wgmma = k % 8 == 0 and n % 8 == 0 and aligned and wgmma_stages(k) > 0
    return "wgmma" if wgmma else "mma_sync"


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def form_for(x: torch.Tensor, w: torch.Tensor, bias=None) -> str:
    """``ln_mm_form`` of these (contiguous) operands."""
    return ln_mm_form(x.shape[0], x.shape[1], w.shape[1], _aligned(x, w, bias), x.dtype)


def launcher_form(x: torch.Tensor, w: torch.Tensor, bias=None) -> str:
    """The form the C launcher itself picks for these CUDA operands (builds
    the library): the check that ``ln_mm_form`` mirrors it."""
    code = _lib().ln_matmul_form(_DTYPE_CODES[x.dtype], x.shape[0], x.shape[1], w.shape[1],
                                 x.data_ptr(), w.data_ptr(),
                                 None if bias is None else bias.data_ptr())
    if not 0 <= code < len(_FORMS):
        raise ValueError(f"ln_matmul_form refused the operands ({code})")
    return _FORMS[code]


def wgmma_constants(k: int) -> tuple:
    """(tile rows, tile columns, chunk columns, stages, shared bytes,
    threads) of the built kernel at rows of ``k`` (builds the library)."""
    return tuple(_lib().ln_mm_wgmma_config(k, i) for i in range(6))


class LnMmPlan(NamedTuple):
    """How the wgmma form cuts its work, as the kernel cuts it: ``mb`` row
    blocks of 128 × ``nt`` N tiles of 256 columns are the units, numbered
    row-block-major (u = rb·nt + nj), each ``nchunks`` chunks of 64
    columns of x deep; CTA j of ``grid`` takes the contiguous run
    ``share(j)``, and computes a row block's statistics once on entering
    it (its first unit, or a unit of a new row block)."""

    mb: int
    nt: int
    nchunks: int
    grid: int
    stages: int
    smem: int

    @property
    def units(self) -> int:
        return self.mb * self.nt

    def share(self, j: int) -> tuple:
        """CTA j's units ``[start(j), start(j + 1))``: ``start(j) = j·base
        + min(j, rem)`` with ``base, rem = divmod(units, grid)``, so the
        first ``rem`` runs hold one unit more."""
        base, rem = divmod(self.units, self.grid)
        return j * base + min(j, rem), (j + 1) * base + min(j + 1, rem)

    def units_of(self, j: int) -> list:
        """CTA j's units as (row block, N tile), in the order it takes them."""
        return [divmod(u, self.nt) for u in range(*self.share(j))]

    def stats_passes(self, j: int) -> int:
        """The row blocks whose statistics CTA j computes: one per row block
        its run meets."""
        u0, u1 = self.share(j)
        return (u1 - 1) // self.nt - u0 // self.nt + 1 if u1 > u0 else 0


@functools.lru_cache(maxsize=256)
def ln_mm_wgmma_plan(m: int, k: int, n: int, ctas: int) -> LnMmPlan:
    """The wgmma form's plan for an (m, k) x and a (k, n) w on a card that
    holds ``ctas`` of its CTAs at once: one CTA per resident slot, never
    more than there are units."""
    stages = wgmma_stages(k)
    if m < 1 or k < 1 or n < 1 or ctas < 1 or not stages:
        raise ValueError(f"bad plan: m {m} k {k} n {n} on {ctas} CTAs")
    mb, nt = -(-m // _WG_TILE_M), -(-n // _WG_TILE_N)
    return LnMmPlan(mb, nt, -(-k // _WG_CHUNK), min(mb * nt, ctas), stages,
                    wgmma_smem(k, stages))


def wgmma_resident() -> int:
    """The wgmma form's CTAs that the current card holds at once (builds the
    library)."""
    return _lib().ln_mm_wgmma_resident_ctas()


@functools.cache
def _wgmma_ctas(device_index: int) -> int:
    with torch.cuda.device(device_index):
        got = wgmma_resident()
    if got < 1:
        raise RuntimeError(f"ln_matmul wgmma occupancy query failed ({got})")
    return got


def plan_for(x: torch.Tensor, w: torch.Tensor) -> LnMmPlan:
    """The plan a wgmma launch on these CUDA operands takes."""
    return ln_mm_wgmma_plan(x.shape[0], x.shape[1], w.shape[1], _wgmma_ctas(x.get_device()))


def _wgmma_grid(m: int, k: int, n: int, index: int) -> int:
    """The grid of a wgmma launch, kept per shape and device: the host's
    time per call is part of a small shape's time."""
    grid = _grids.get((m, k, n, index))
    if grid is None:
        grid = _grids[m, k, n, index] = ln_mm_wgmma_plan(m, k, n, _wgmma_ctas(index)).grid
    return grid


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
    if not x.is_cuda:
        raise ValueError(f"ln_matmul runs on cpu or cuda, not {x.device}")
    _build.refuse_grad("ln_matmul", x, gamma, beta, w, bias)
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x {x.dtype} and w {w.dtype} must share a dtype (f32 or bf16)")
    if bias is not None and bias.dtype != x.dtype:
        raise ValueError(f"bias {bias.dtype} must be in x's dtype {x.dtype}")
    index = x.get_device()
    operands = (x, w) if bias is None else (x, w, bias)
    for t in operands + (gamma, beta):
        if t.get_device() != index:
            raise ValueError(f"operands on {t.device} and {x.device}")
    for t in operands:
        if not t.is_contiguous():
            raise ValueError(f"expected contiguous operands, got strides {t.stride()}")
    gamma = gamma.float().contiguous()
    beta = beta.float().contiguous()
    out = x.new_empty((m, n))
    # the wgmma form's grid where the shape allows it (the launcher, which
    # reads the alignment, ignores it where it takes another form)
    grid = (_wgmma_grid(m, k, n, index)
            if ln_mm_form(m, k, n, True, x.dtype) == "wgmma" else 0)
    err = _lib().ln_matmul_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
        m, k, n, eps, grid, torch._C._cuda_getCurrentRawStream(index),
    )
    if err != 0:
        raise RuntimeError(f"ln_matmul launch failed: cudaError {err}")
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0
