"""Weight-only int8 quantization and the int8 weight matmul (K2).

Port of ``multimodal_embeddings_tpu/kernels/quantization.py``:

* ``QTensor``, ``compute_scale``, ``quantize_tensor`` and ``dequantize``:
  the same arithmetic (symmetric per-channel scales ``max|w| / 127``,
  round half to even, clip to ±127), bit for bit;
* ``int8_matmul``: replaces the Pallas TPU kernel ``int8_matmul``
  (``_mm_kernel``) with hand-written CUDA kernels,
  ``csrc/int8_matmul.cu``: ``y = cast_x((x · bf16(q)) accumulated in f32
  · scale[N])``. The int8 weight is read from device memory as int8 and
  becomes bf16 only in registers or shared memory. A launch takes one of
  three forms (``int8_mm_form``, the launcher's rule mirrored):

  - ``wgmma`` (bf16 x, M > 4, K % 8 == 0, N % 16 == 0, x, q and scale on
    16-byte boundaries; every mmE5-11B text shape): persistent CTAs in
    clusters of two over tiles of 128 or 256 rows (``wgmma_tile_m``) × 128
    columns, a TMA ring of x (multicast within the pair) and the int8
    weight per chunk of weight rows, the product taken as y^T = q^T x^T so
    the weight becomes ``wgmma``'s register operand without an int-to-float
    conversion; the (tile pair, chunk) units cut by ``int8_wgmma_plan`` into
    equal contiguous shares over the resident clusters (stream-K; per M
    tile where the M tiles are few), a cut tile's partials summed in a
    fixed order in the same launch (deterministic);
  - ``mma_sync`` (every other bf16 shape): ``mma.sync`` tiles;
  - ``f32`` (f32 x, checks only): CUDA cores.
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
# the C launcher's form codes, and the wgmma form's output tile (128 or 256
# rows of x × 128 columns of W), the chunk of weight rows for each tile's
# rows, and the CTAs per cluster (``int8_wgmma_config`` in the source;
# chip_smoke.py holds them equal)
_FORMS = ("f32", "mma_sync", "wgmma")
_WG_TILE_N, _WG_CLUSTER = 128, 2
_WG_CHUNK = {128: 128, 256: 64}
# (device index, stream) -> the wgmma form's workspace and arrival counters;
# (m, k, n, device index, stream) -> a wgmma launch's plan arguments and
# scratch pointers
_scratch: dict = {}
_launch_args: dict = {}


class QTensor(NamedTuple):
    """int8 values + per-output-channel f32 scales."""

    q: torch.Tensor  # int8, the source tensor's shape
    scale: torch.Tensor  # f32, the source shape with contraction axes reduced to 1


def compute_scale(w: torch.Tensor, contract_axes: Sequence[int]) -> torch.Tensor:
    """Symmetric per-channel scale: max|w| over the contraction axes / 127,
    an IEEE division on any device. (Divided by a tensor: on CUDA, torch
    turns division by a Python number into multiplication by its
    reciprocal, which rounds differently; the JAX package's eager
    ``quantize_tensor`` divides.)"""
    amax = w.float().abs().amax(dim=tuple(contract_axes), keepdim=True).clamp_min(1e-8)
    return amax / torch.full_like(amax, 127.0)


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
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
    )
    lib.int8_matmul_launch.restype = ctypes.c_int
    lib.int8_matmul_form.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    lib.int8_matmul_form.restype = ctypes.c_int
    lib.int8_wgmma_resident_ctas.argtypes = [ctypes.c_int]
    lib.int8_wgmma_resident_ctas.restype = ctypes.c_int
    lib.int8_wgmma_config.argtypes = [ctypes.c_int] * 2
    lib.int8_wgmma_config.restype = ctypes.c_int
    return lib


def build_info() -> _build.BuildInfo:
    """Build (or reuse) the kernel library; returns its ``BuildInfo``."""
    _lib()
    return _build.load(_SOURCE)[1]


def int8_mm_form(m: int, k: int, n: int, aligned: bool = True,
                 dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel form a launch takes, by the launcher's rule
    (``csrc/int8_matmul.cu::form_of``): ``"f32"`` for an f32 x;
    ``"wgmma"`` for a bf16 x of m > 4 rows where TMA can describe every
    operand (k % 8 == 0, n % 16 == 0, and x, q and scale start on 16-byte
    boundaries: ``aligned``); ``"mma_sync"`` for every other bf16 shape.
    At m <= 4 a 128-row tile is nearly all zero fill in either tensor-core
    form, and the simpler one takes it."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if m > 4 and k % 8 == 0 and n % 16 == 0 and aligned else "mma_sync"


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def form_for(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> str:
    """``int8_mm_form`` of these operands as ``int8_matmul`` hands them to
    the kernel (contiguous)."""
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    return int8_mm_form(x.shape[0], x.shape[1], q.shape[1], _aligned(x, q, scale), x.dtype)


def launcher_form(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> str:
    """The form the C launcher itself picks for these CUDA operands (builds
    the library): the check that ``int8_mm_form`` mirrors it."""
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    code = _lib().int8_matmul_form(_DTYPE_CODES[x.dtype], x.shape[0], x.shape[1], q.shape[1],
                                   x.data_ptr(), q.data_ptr(), scale.data_ptr())
    if not 0 <= code < len(_FORMS):
        raise ValueError(f"int8_matmul_form refused the operands ({code})")
    return _FORMS[code]


def wgmma_constants(tile_m: int) -> tuple:
    """(tile rows, tile columns, chunk rows, cluster, stages) as the built
    kernel has them for tiles of ``tile_m`` rows (builds the library)."""
    return tuple(_lib().int8_wgmma_config(tile_m, i) for i in range(5))


def wgmma_tile_m(m: int, k: int, n: int, ctas: int) -> int:
    """The rows of x per output tile of the wgmma form: 256 where x has more
    than 128 rows and a share of the 256-row plan holds at least 64 chunks
    (4,096 weight rows), else 128. A 256-row tile serves each weight chunk,
    read from L2 once per M tile, to twice the rows (the L2-to-SM reads bound
    the form: 17% fewer bytes per product), but its f32 partials are twice
    as large; over a short share they cost more than that saves
    (scripts/torch_k2_probe.py on the H100: gate,up 0.0978 ms on 256 rows
    against 0.1102 on 128, down 0.0962 against 0.1035; q,o 0.0423 against
    0.0338, k,v 0.0268 against 0.0187)."""
    if m <= 128:
        return 128
    wide = int8_wgmma_plan(m, k, n, ctas, 256)
    return 256 if wide.units // wide.seqs // wide.sets >= 64 else 128


class WgmmaPlan(NamedTuple):
    """How the wgmma form cuts its work, as the kernel cuts it: ``mt`` ×
    ``nt`` output tiles of ``tile_m`` × 128 in groups of ``cluster``
    adjacent N tiles of one M tile (``groups``, numbered M-fastest), each
    group ``nchunks`` chunks of weight rows (128 at ``tile_m`` 128, 64 at
    256). The groups are dealt into ``seqs`` sequences (group g to sequence
    g % seqs: all groups where seqs is 1, one M tile's where it is mt), the
    clusters of the ``grid`` CTAs likewise (cluster c to sequence c % seqs,
    as its set c // seqs), and each sequence's units (group, chunk),
    group-major, are cut into contiguous shares, one per set."""

    tile_m: int
    mt: int
    nt: int
    nchunks: int
    cluster: int
    grid: int
    seqs: int

    @property
    def groups(self) -> int:
        return self.mt * -(-self.nt // self.cluster)

    @property
    def units(self) -> int:
        return self.groups * self.nchunks

    @property
    def clusters(self) -> int:
        return self.grid // self.cluster

    @property
    def sets(self) -> int:
        return self.clusters // self.seqs

    def share(self, j: int) -> tuple:
        """Set j's units of its sequence, ``[start(j), start(j + 1))``:
        ``start(j) = j·base + min(j, rem)`` with ``base, rem =
        divmod(units / seqs, sets)``, so the first ``rem`` shares hold one
        unit more."""
        base, rem = divmod(self.units // self.seqs, self.sets)
        return j * base + min(j, rem), (j + 1) * base + min(j + 1, rem)

    def units_of(self, c: int) -> list:
        """Cluster c's units as (group, chunk), in the order it takes them."""
        seq, (u0, u1) = c % self.seqs, self.share(c // self.seqs)
        return [((u // self.nchunks) * self.seqs + seq, u % self.nchunks) for u in range(u0, u1)]

    def contributors(self, group: int) -> list:
        """The clusters whose shares meet ``group``, in the order the kernel
        sums their partials (set order, which is k order), each with its
        chunks of the group ``(cluster, first chunk, end chunk)``."""
        seq, local = group % self.seqs, group // self.seqs
        lo, hi = local * self.nchunks, (local + 1) * self.nchunks
        out = []
        for j in range(self.sets):
            u0, u1 = self.share(j)
            if u0 < hi and u1 > lo:
                out.append((j * self.seqs + seq, max(u0, lo) - lo, min(u1, hi) - lo))
        return out

    def cut_groups(self) -> int:
        """Groups whose chunks more than one cluster shares."""
        return sum(len(self.contributors(g)) > 1 for g in range(self.groups))

    @property
    def ws_floats(self) -> int:
        """The workspace: per CTA two slots (the partial of the first and
        of the last group its share meets) × two warpgroups × 128 threads ×
        tile_m / 2 accumulators."""
        return self.grid * 2 * 2 * 128 * self.tile_m // 2

    @property
    def n_counters(self) -> int:
        """Arrival counters: one per tile and warpgroup."""
        return self.groups * self.cluster * 2


def wgmma_seqs(mt: int, clusters: int) -> int:
    """Sequences of the wgmma form's stream-K shares: one per M tile where
    the card holds at least 8 clusters per M tile, else one."""
    return mt if 8 * mt <= clusters else 1


@functools.lru_cache(maxsize=256)
def int8_wgmma_plan(m: int, k: int, n: int, ctas: int, tile_m: int = 0) -> WgmmaPlan:
    """The wgmma form's plan for an (m, k) x and a (k, n) weight on a card
    that holds ``ctas`` of its CTAs at once: tiles of ``tile_m`` rows
    (``wgmma_tile_m``'s choice where 0); the sequences ``wgmma_seqs`` gives
    (per M tile, the mt clusters of a set read each weight chunk together,
    and the 2 of 66 clusters that 4 M tiles leave over idle); one cluster
    per resident cluster slot, never more sets than a sequence has units."""
    tile_m = tile_m or wgmma_tile_m(m, k, n, ctas)
    if m < 1 or k < 1 or n < 1 or ctas < _WG_CLUSTER or tile_m not in _WG_CHUNK:
        raise ValueError(f"bad plan: m {m} k {k} n {n} tile {tile_m} on {ctas} CTAs")
    c, mt = _WG_CLUSTER, -(-m // tile_m)
    seqs = wgmma_seqs(mt, ctas // c)
    plan = WgmmaPlan(tile_m, mt, -(-n // _WG_TILE_N), -(-k // _WG_CHUNK[tile_m]), c, c, seqs)
    sets = min(ctas // c // seqs, plan.units // seqs)
    return plan._replace(grid=c * seqs * sets)


def wgmma_resident(tile_m: int) -> int:
    """The wgmma form's CTAs for tiles of ``tile_m`` rows that the current
    card holds at once (builds the library)."""
    return _lib().int8_wgmma_resident_ctas(tile_m)


@functools.cache
def _wgmma_ctas(device_index: int) -> int:
    """CTAs of the wgmma form the card holds at once, for either tile (the
    occupancy calls; the fewer of the two)."""
    with torch.cuda.device(device_index):
        got = min(wgmma_resident(t) for t in _WG_CHUNK)
    if got < _WG_CLUSTER:
        raise RuntimeError(f"int8 wgmma occupancy query failed ({got})")
    return got


def plan_for(x: torch.Tensor, q: torch.Tensor) -> WgmmaPlan:
    """The plan a wgmma launch on these CUDA operands takes."""
    return int8_wgmma_plan(x.shape[0], x.shape[1], q.shape[1], _wgmma_ctas(x.get_device()))


def _wgmma_scratch(index: int, stream: int, plan: WgmmaPlan):
    """The workspace and the zeroed int32 arrival counters, kept per
    (device, stream) and grown as needed (the kernel leaves the counters
    zero): launches in one stream run one after another, so they may share
    them, and launches in two streams never do."""
    ws, counters = _scratch.get((index, stream), (None, None))
    if ws is None or ws.numel() < plan.ws_floats or counters.numel() < plan.n_counters:
        ws = torch.empty(max(plan.ws_floats, 0 if ws is None else ws.numel()),
                         dtype=torch.float32, device=f"cuda:{index}")
        counters = torch.zeros(max(plan.n_counters, 4096), dtype=torch.int32,
                               device=f"cuda:{index}")
        _scratch[index, stream] = ws, counters
        _launch_args.clear()  # their pointers are stale
    return ws, counters


def _wgmma_args(m: int, k: int, n: int, index: int, stream: int) -> tuple:
    """(grid, tile rows, sequences, workspace, counters) of a wgmma launch,
    kept per shape, device and stream: the host's time per call is most of
    a small shape's time from an idle card."""
    key = (m, k, n, index, stream)
    args = _launch_args.get(key)
    if args is None:
        plan = int8_wgmma_plan(m, k, n, _wgmma_ctas(index))
        ws, counters = _wgmma_scratch(index, stream, plan)
        args = _launch_args[key] = (plan.grid, plan.tile_m, plan.seqs, ws.data_ptr(),
                                    counters.data_ptr())
    return args


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
    device memory. The wgmma form takes its workspace from a cache per
    (device, stream), so calls in different streams may overlap."""
    if x.dim() != 2 or q.dim() != 2 or q.shape[0] != x.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} q {tuple(q.shape)}")
    m, k = x.shape
    n = q.shape[1]
    if q.dtype != torch.int8 or scale.numel() != n:
        raise ValueError(f"q must be int8 (got {q.dtype}) with {n} scales")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return int8_matmul_reference(x, q, scale)
        raise ValueError(f"int8_matmul runs on cpu or one cuda device, not {x.device}")
    _build.refuse_grad("int8_matmul", x, scale)
    index = x.get_device()
    if q.get_device() != index or scale.get_device() != index:
        raise ValueError(f"int8_matmul runs on one cuda device: x on {x.device}, "
                         f"q on {q.device}, scale on {scale.device}")
    if x.dtype not in _DTYPE_CODES or scale.dtype != torch.float32:
        raise ValueError("x must be float32 or bfloat16 and scale float32")
    x, q, scale = x.contiguous(), q.contiguous(), scale.contiguous()
    y = x.new_empty((m, n))
    stream = torch._C._cuda_getCurrentRawStream(index)
    # the wgmma form's arguments where the shape allows it (the launcher,
    # which reads the alignment, ignores them where it takes another form)
    wgmma = (_wgmma_args(m, k, n, index, stream)
             if int8_mm_form(m, k, n, True, x.dtype) == "wgmma" else (0, 0, 0, None, None))
    err = _lib().int8_matmul_launch(
        _DTYPE_CODES[x.dtype], x.data_ptr(), q.data_ptr(), scale.data_ptr(),
        y.data_ptr(), m, k, n, *wgmma, stream,
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
    _build.refuse_grad("stochastic_round_quantize", w, scale_row, u)
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
