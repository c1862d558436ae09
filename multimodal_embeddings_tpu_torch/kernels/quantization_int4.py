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
  (``_mm4_kernel``) with hand-written CUDA kernels, ``csrc/int4_matmul.cu``:
  per group, ``part = bf16(x_g) · q_g`` summed in f32, then
  ``acc += part · scale[g]``; one cast to x's type at the end. **x is rounded
  to bf16 even when it is f32**, as in the TPU kernel. A launch takes one of
  three forms (``mm_form``, the launcher's rule mirrored):

  - ``gemv`` (M ≤ 4, decode): HBM-bound; its (256-column tile, group) units
    are cut by ``gemv_plan`` into equal contiguous shares over the CTAs the
    card holds at once;
  - ``wgmma`` (M > 4 where TMA can describe every operand: G = 64 or
    G % 128 == 0, N % 16 == 0, x, packed and scale on 16-byte boundaries;
    every Qwen2.5-VL-32B prefill projection): tensor-core bound at the 32B
    prefill's M = 1535. Persistent CTAs in clusters of two (``wgmma_grid``)
    over 128 × 128 tiles, a TMA ring of x (multicast within the pair),
    packed and scale per chunk of 128 weight rows; the product taken as
    y^T = q^T x^T, so each consumer warpgroup turns nibbles straight into
    ``wgmma``'s register operand without an int-to-float conversion
    (``0x4300 | n`` is the bf16 128 + n, less 136 is q), the next chunk's
    while this one's ``wgmma`` run, and folds ``part · scale`` per group;
  - ``mma_sync`` (every other M > 4 shape): the ragged form on ``mma.sync``.
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
# the GEMV form (M <= 4): 256 output columns per tile; its work is
# (tile, group) units, and a CTA takes at least this many where the units
# are too few to give every resident CTA as many: each CTA has a fixed cost
# (filling its loads, staging x, summing its tiles), and of 1, 2, 4, 8 and
# 16, 4 gives the shortest decode step (scripts/torch_k3_gemv_probe.py)
_GEMV_MAX_M = 4
_GEMV_COLS = 256
_GEMV_MIN_UNITS = 4
# the wgmma form's output tile (128 x 128) and the C launcher's form codes
_WGMMA_TILE = 128
_FORMS = ("gemv", "mma_sync", "wgmma")
# (kind, device, stream) -> the GEMV's workspace and arrival counters
_scratch: dict = {}


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
    (floored at 1e-8 / 7), round half to even; both divisions are IEEE
    divisions on any device (see ``quantization.compute_scale``)."""
    if w.dim() != 2:
        raise ValueError(f"expected a 2-D weight, got shape {tuple(w.shape)}")
    k, n = w.shape
    g = int4_group_size(k, group_size)
    n_groups = k // g
    wg = w.float().reshape(n_groups, g, n)
    amax = wg.abs().amax(dim=1, keepdim=True).clamp_min(1e-8)
    scale = amax / torch.full_like(amax, 7.0)  # an IEEE division on CUDA too
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
    lib.int4_gemv_resident_ctas.argtypes = [ctypes.c_int] * 2
    lib.int4_gemv_resident_ctas.restype = ctypes.c_int
    lib.int4_matmul_form.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.int4_matmul_form.restype = ctypes.c_int
    lib.int4_wgmma_resident_ctas.argtypes = [ctypes.c_int] * 2
    lib.int4_wgmma_resident_ctas.restype = ctypes.c_int
    lib.int4_wgmma_cluster.argtypes = []
    lib.int4_wgmma_cluster.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


class GemvPlan(NamedTuple):
    """How the GEMV form (M <= 4) cuts its work: ``tiles`` 256-column tiles
    × ``n_groups`` groups make ``units`` (tile, group) units in tile-major
    order, and CTA c of ``grid`` takes the contiguous share ``share(c)``."""

    mt: int  # rows of x the kernel holds: 1, 2 or 4
    tiles: int
    n_groups: int
    grid: int

    @property
    def units(self) -> int:
        return self.tiles * self.n_groups

    def share(self, c: int) -> tuple:
        """CTA c's units ``[start(c), start(c + 1))``, as the kernel cuts
        them: ``start(c) = c·base + min(c, rem)`` with ``base, rem =
        divmod(units, grid)``, so the first ``rem`` shares hold one unit
        more."""
        base, rem = divmod(self.units, self.grid)
        return c * base + min(c, rem), (c + 1) * base + min(c + 1, rem)

    def cut_tiles(self) -> int:
        """Tiles whose units more than one CTA shares."""
        owners = [set() for _ in range(self.tiles)]
        for c in range(self.grid):
            u0, u1 = self.share(c)
            for t in range(u0 // self.n_groups, -(-u1 // self.n_groups)):
                owners[t].add(c)
        return sum(len(o) > 1 for o in owners)


def _gemv_mt(m: int) -> int:
    return 1 if m == 1 else 2 if m == 2 else 4


@functools.lru_cache(maxsize=256)
def gemv_plan(m: int, k: int, n: int, n_groups: int, ctas: int) -> GemvPlan:
    """The GEMV form's plan for an (m, k) x and a (k/2, n) weight in
    ``n_groups`` groups, on a card that holds ``ctas`` of its CTAs at once:
    one CTA per resident slot, each with an equal contiguous share of the
    units (shares differ by at most one unit), but at least
    ``_GEMV_MIN_UNITS`` units per CTA where the units are few, and never
    more CTAs than units."""
    if not 1 <= m <= _GEMV_MAX_M or ctas < 1:
        raise ValueError(f"the GEMV form takes 1 <= m <= {_GEMV_MAX_M} rows on >= 1 CTA")
    tiles = -(-n // _GEMV_COLS)
    units = tiles * n_groups
    grid = max(1, min(ctas, -(-units // _GEMV_MIN_UNITS)))
    return GemvPlan(_gemv_mt(m), tiles, n_groups, grid)


@functools.cache
def _gemv_ctas(device_index: int, out_code: int, mt: int) -> int:
    """CTAs of the GEMV form the card holds at once (the occupancy calls)."""
    with torch.cuda.device(device_index):
        got = _lib().int4_gemv_resident_ctas(out_code, mt)
    if got < 1:
        raise RuntimeError(f"int4 GEMV occupancy query failed ({got})")
    return got


def plan_for(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> GemvPlan:
    """The plan a GEMV launch on these CUDA operands takes."""
    m, k = x.shape
    mt = _gemv_mt(m)
    ctas = _gemv_ctas(x.device.index, _DTYPE_CODES[x.dtype], mt)
    return gemv_plan(m, k, packed.shape[1], scale.shape[0], ctas)


def mm_form(m: int, k: int, n: int, n_groups: int, aligned: bool = True) -> str:
    """The kernel form a launch takes, by the launcher's rule
    (``csrc/int4_matmul.cu::form_of``): ``"gemv"`` for m <= 4; ``"wgmma"``
    where TMA can describe every operand and a chunk of the group is whole
    (G = k / n_groups is 64 or a multiple of 128, n % 16 == 0, and x, packed
    and scale start on 16-byte boundaries: ``aligned``); ``"mma_sync"``
    for every other shape."""
    if m <= _GEMV_MAX_M:
        return "gemv"
    g = k // n_groups
    if (g == 64 or g % 128 == 0) and n % 16 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def _kernel_operands(x, packed, scale):
    """x rounded to bf16 and the three operands contiguous, as the kernel
    takes them."""
    return x.to(torch.bfloat16).contiguous(), packed.contiguous(), scale.contiguous()


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def form_for(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> str:
    """``mm_form`` of these operands as ``int4_matmul`` hands them to the
    kernel."""
    xb, packed, scale = _kernel_operands(x, packed, scale)
    m, k = x.shape
    return mm_form(m, k, packed.shape[1], scale.shape[0], _aligned(xb, packed, scale))


def launcher_form(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> str:
    """The form the C launcher itself picks for these CUDA operands (builds
    the library): the check that ``mm_form`` mirrors it."""
    xb, packed, scale = _kernel_operands(x, packed, scale)
    m, k = x.shape
    code = _lib().int4_matmul_form(m, k, packed.shape[1], scale.shape[0], xb.data_ptr(),
                                   packed.data_ptr(), scale.data_ptr())
    if not 0 <= code < len(_FORMS):
        raise ValueError(f"int4_matmul_form refused the shapes ({code})")
    return _FORMS[code]


def wgmma_grid(m: int, n: int, ctas: int, cluster: int) -> int:
    """The wgmma form's persistent CTAs, in clusters of ``cluster`` that take
    that many adjacent 128 × 128 tiles of one M tile at a time: as many
    clusters as the card holds at once (``ctas`` CTAs; a CTA takes a whole
    SM's shared memory), never more than the tile groups."""
    n_tiles = -(-n // _WGMMA_TILE)
    groups = -(-m // _WGMMA_TILE) * -(-n_tiles // cluster)
    return cluster * max(1, min(groups, ctas // cluster))


@functools.cache
def _wgmma_ctas(device_index: int, out_code: int, group_rows: int) -> tuple:
    """(CTAs of the wgmma form the card holds at once, CTAs per cluster):
    the occupancy calls and the kernel's cluster size."""
    with torch.cuda.device(device_index):
        got = _lib().int4_wgmma_resident_ctas(out_code, group_rows)
    if got < 1:
        raise RuntimeError(f"int4 wgmma occupancy query failed ({got})")
    return got, _lib().int4_wgmma_cluster()


def _gemv_scratch(device, stream: int, plan: GemvPlan):
    """The workspace (grid · 2 · mt · 256 f32: each CTA's partials of its
    first and last tile) and the zeroed int32 arrival counters, one per
    tile, kept per (device, stream) and grown as needed (the kernel leaves
    the counters zero): launches in one stream run one after another, so
    they may share them, and launches in two streams never do."""
    ws = _scratch.get(("ws", device, stream))
    need = plan.grid * 2 * plan.mt * _GEMV_COLS
    if ws is None or ws.numel() < need:
        ws = _scratch["ws", device, stream] = torch.empty(
            max(need, 2**20), dtype=torch.float32, device=device)
    counters = _scratch.get(("counters", device, stream))
    if counters is None or counters.numel() < plan.tiles:
        counters = _scratch["counters", device, stream] = torch.zeros(
            max(plan.tiles, 4096), dtype=torch.int32, device=device)
    return ws, counters


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
    of the weight in device memory. The GEMV form (M <= 4) takes its
    workspace from a cache per (device, stream), so calls in different
    streams may overlap."""
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
    _build.refuse_grad("int4_matmul", x, scale)
    if x.dtype not in _DTYPE_CODES or scale.dtype != torch.float32:
        raise ValueError("x must be float32 or bfloat16 and scale float32")
    xb, packed, scale = _kernel_operands(x, packed, scale)
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    grid, ws, counters = 1, None, None
    form = mm_form(m, k, n, n_groups, _aligned(xb, packed, scale))
    if form == "gemv":
        plan = plan_for(x, packed, scale)
        grid = plan.grid
        ws, counters = (t.data_ptr() for t in _gemv_scratch(x.device, stream, plan))
    elif form == "wgmma":
        grid = wgmma_grid(m, n, *_wgmma_ctas(x.device.index, _DTYPE_CODES[x.dtype], k // n_groups))
    err = _lib().int4_matmul_launch(
        _DTYPE_CODES[x.dtype], xb.data_ptr(), packed.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, k, n, n_groups, grid, ws, counters, stream,
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
