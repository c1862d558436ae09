"""The (data, model) mesh of ranks on ``torch.distributed``.

Port of ``multimodal_embeddings_tpu/core/mesh.py``. Where the JAX package
lays devices out in one ``jax.sharding.Mesh`` and lets XLA insert the
collectives, the port runs one process per card (a rank) and lays the ranks
out in a ``Mesh``: an n-D grid of global ranks with named axes,

* ``data``: the batch dimension (pages, regions, a training batch),
* ``model``: tensor parallelism (attention heads, MLP columns, the vocab),

and, for each axis, this rank's process group along it: explicit
sub-groups made by ``torch.distributed.new_group``, one per line of the
grid, every rank making every group in the same order when the mesh is
built (a line of one rank gets no group and no collective).
``make_pp_mesh`` in ``parallel/pipeline.py`` lays out a ``stage`` axis the
same way.

The process group uses NCCL on CUDA and gloo on the CPU. ``ProcessGroup``
joins a world for the span of a ``with`` block, its rendezvous a
``FileStore`` in a directory (no port is opened) or ``env://`` where a
launcher set ``RANK``/``WORLD_SIZE``. ``launch(fn, world_size, ...)`` spawns
the ranks and returns their results, so that one command line drives them
all, as JAX's single controller does; in a world that a launcher already
set up it runs ``fn`` on this rank alone.

``Mesh.all_reduce`` and ``Mesh.all_gather`` take ``grad=True`` for the
autograd-aware forms: their backward sums the gradients over the ranks,
as ``torch.distributed.nn.functional``'s do (that module is deprecated, and
its all-gather's backward on gloo fails on a sub-group).

``make_mesh``, ``make_hybrid_mesh``, ``data_sharding``, ``replicated``,
``shard_batch``, ``pad_to_multiple`` and ``DTypePolicy`` keep the JAX
names, arguments and errors; a sharding is ``Sharding(mesh, spec)`` and
``shard_batch`` returns this rank's slice of a global batch.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing.connection
import os
import tempfile
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_embeddings_tpu_torch.config import MeshConfig
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world() -> tuple:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def visible_devices(device="cuda") -> int:
    """The devices a world of ranks may take: the CUDA cards, or the CPU's
    cores for gloo ranks (asking for CUDA where there is none raises)."""
    if resolve_device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def quiet_other_ranks() -> None:
    """Silence the port's loggers on every rank but 0, which logs what JAX's
    single controller logs."""
    if world()[0] != 0:
        for name in ("mmtpu", "multimodal_embeddings_tpu_torch"):
            logging.getLogger(name).setLevel(logging.CRITICAL + 1)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: its CUDA device (``torch.cuda.current_device()``,
    which ``ProcessGroup`` sets) for ``"cuda"``, else ``device``; CUDA where
    there is none raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Global ranks in an n-D grid with named axes (``ranks``, in the place
    of JAX's ``devices``; ``shape`` maps each axis to its size) and this
    rank's process group along each axis and over the whole mesh."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim}-D ranks for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        rank, size = world()
        if self.ranks.size and int(self.ranks.max()) >= size:
            raise ValueError(f"mesh ranks {self.ranks.tolist()} outside a world of {size}")
        where = np.argwhere(self.ranks == rank)
        # None: this rank holds no place in the mesh
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._groups = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            for line in lines:
                group = _new_group(line)
                if rank in line:
                    self._groups[axis] = (group, [int(r) for r in line])
        self._groups[None] = (_new_group(self.ranks.ravel()), self.ranks.ravel().tolist())

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: Optional[str] = None):
        """This rank's process group along ``axis`` (the whole mesh for
        None); None where the line holds one rank."""
        return self._groups[axis][0]

    def axis_ranks(self, axis: Optional[str] = None) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in axis
        order."""
        return self._groups[axis][1]

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0,
                   grad: bool = False) -> torch.Tensor:
        """Each rank's ``x`` along ``axis`` concatenated on ``dim`` in axis
        order; ``grad``: autograd-aware, its backward hands each rank the sum
        over the ranks of the gradient of its block."""
        if len(self.axis_ranks(axis)) == 1:
            return x
        if grad:
            return _AllGather.apply(x, self, axis, dim)
        return self._gather(x.detach(), axis, dim)

    def _gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        line = self.axis_ranks(axis)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in line]
        dist.all_gather(parts, x.contiguous(), group=self.group(axis))
        # a group orders its members by global rank, the axis by position
        members = sorted(line)
        return torch.cat([parts[members.index(r)] for r in line], dim=dim)

    def all_reduce(self, x: torch.Tensor, axis: Optional[str] = None,
                   grad: bool = False) -> torch.Tensor:
        """The sum of ``x`` over ``axis`` (the whole mesh for None); ``grad``:
        autograd-aware (its backward sums the gradients over the ranks too),
        else in place."""
        if len(self.axis_ranks(axis)) == 1:
            return x
        if grad:
            return _AllReduce.apply(x, self, axis)
        dist.all_reduce(x, group=self.group(axis))
        return x

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


class _AllReduce(torch.autograd.Function):
    """Sum over the ranks of an axis; the backward sums the gradients over
    the same ranks: the derivative of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, mesh: "Mesh", axis):
        ctx.mesh, ctx.axis = mesh, axis
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=mesh.group(axis))
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dx, group=ctx.mesh.group(ctx.axis))
        return dx, None, None


class _AllGather(torch.autograd.Function):
    """Concatenation of the ranks' blocks in axis order; the backward hands
    each rank the sum over the ranks of its block's gradient."""

    @staticmethod
    def forward(ctx, x, mesh: "Mesh", axis, dim: int):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.index, ctx.size = mesh.axis_ranks(axis).index(world()[0]), x.shape[dim]
        return mesh._gather(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(dy, group=ctx.mesh.group(ctx.axis))
        return dy.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None


def _new_group(ranks):
    """A process group of ``ranks``; None for one rank. Every rank of the
    world calls this for every group, in the same order."""
    ranks = [int(r) for r in ranks]
    if len(ranks) == 1:
        return None
    return dist.new_group(ranks)


class ProcessGroup:
    """A ``torch.distributed`` world joined for the span of a ``with``
    block: NCCL when ``device`` is CUDA (this rank's card is
    ``local_rank``), gloo on the CPU. The rendezvous is a ``FileStore`` at
    ``store_path``, or ``env://`` (a launcher's ``MASTER_ADDR`` /
    ``MASTER_PORT``) when it is None."""

    def __init__(self, rank: int, world_size: int, device="cuda",
                 store_path: Optional[str] = None, local_rank: Optional[int] = None):
        self.rank, self.world_size = rank, world_size
        self.device = resolve_device(device)
        self.store_path = store_path
        self.local_rank = rank if local_rank is None else local_rank

    def __enter__(self) -> "ProcessGroup":
        backend = "gloo"
        if self.device.type == "cuda":
            backend = "nccl"
            torch.cuda.set_device(self.local_rank % torch.cuda.device_count())
        if self.store_path is None:
            dist.init_process_group(backend, init_method="env://", rank=self.rank,
                                    world_size=self.world_size)
        else:
            store = dist.FileStore(self.store_path, self.world_size)
            dist.init_process_group(backend, store=store, rank=self.rank,
                                    world_size=self.world_size)
        return self

    def __exit__(self, *exc) -> bool:
        dist.destroy_process_group()
        return False


def _rank_main(fn, rank, world_size, device, store_path, threads, args, conn) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, send the result
    home. An exception ends the process with a non-zero code, which the
    parent reports."""
    if threads:
        torch.set_num_threads(threads)
    with ProcessGroup(rank, world_size, device, store_path):
        result = fn(*args)
    conn.send(result)
    conn.close()


class _Ranks:
    """The spawned ranks of one ``launch``: every process still alive when
    the block ends is terminated, whatever ended it."""

    def __init__(self, procs, conns):
        self.procs, self.conns = procs, conns

    def __enter__(self) -> "_Ranks":
        for p in self.procs:
            p.start()
        return self

    def results(self, timeout: float) -> list:
        """Each rank's result in rank order; raises on the first rank that
        exits without one, or when ``timeout`` seconds pass with no news."""
        pending = dict(enumerate(self.conns))
        results = {}
        while pending:
            waits = list(pending.values()) + [self.procs[r].sentinel for r in pending]
            ready = multiprocessing.connection.wait(waits, timeout)
            if not ready:
                raise TimeoutError(f"ranks {sorted(pending)} sent nothing in {timeout} s")
            for rank, conn in list(pending.items()):
                if conn.poll():
                    results[rank] = conn.recv()
                    del pending[rank]
                elif self.procs[rank].sentinel in ready:
                    self.procs[rank].join()
                    raise RuntimeError(f"rank {rank} exited with code "
                                       f"{self.procs[rank].exitcode} and no result")
        return [results[r] for r in range(len(self.conns))]

    def __exit__(self, *exc) -> bool:
        for p in self.procs:
            p.join(0 if exc[0] is not None else 30)
            if p.is_alive():
                p.terminate()
                p.join(10)
        return False


def launch(fn: Callable, world_size: int, *args, device="cuda", threads: int = 1,
           timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` ranks and return their results
    in rank order. The ranks are spawned processes (``fn`` and ``args`` are
    pickled: ``fn`` must be importable by name) joined by a ``FileStore``
    in a temporary directory, each with ``threads`` intra-op threads (None:
    PyTorch's default). Where a launcher already set up the world
    (``RANK`` and ``WORLD_SIZE`` in the environment, ``env://``), this
    process runs ``fn`` as that rank and returns ``[its result]``."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        with ProcessGroup(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device,
                          local_rank=local):
            return [fn(*args)]
    resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        pipes = [ctx.Pipe(duplex=False) for _ in range(world_size)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, device, store, threads,
                                                      args, pipes[r][1]))
                 for r in range(world_size)]
        with _Ranks(procs, [recv for recv, _ in pipes]) as ranks:
            return ranks.results(timeout)


def make_mesh(config: MeshConfig = MeshConfig(), devices: Optional[Sequence] = None) -> Mesh:
    """Build the global 2-D (data, model) mesh over ``devices`` (global
    ranks; every rank of the world by default).

    ``shape=(-1, m)`` puts ``n_ranks // m`` ranks on the data axis. The
    default ``(-1, 1)`` is pure data parallelism; pass ``model > 1`` to
    tensor-shard the towers. Every rank of the world must call it (it makes
    the process groups)."""
    devices = list(devices if devices is not None else range(world()[1]))
    data_size, model_size = config.shape
    if model_size < 1:
        raise ValueError("model axis size must be >= 1")
    if data_size == -1:
        if len(devices) % model_size:
            raise ValueError(f"{len(devices)} devices not divisible by model={model_size}")
        data_size = len(devices) // model_size
    ranks = np.asarray(devices[: data_size * model_size]).reshape(data_size, model_size)
    return Mesh(ranks, (config.data_axis, config.model_axis))


def host_groups_of_world() -> List[List[int]]:
    """The world's ranks by host: consecutive blocks of ``LOCAL_WORLD_SIZE``
    ranks (a launcher's one process per card on a host), one host when it
    is unset."""
    size = world()[1]
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    return [list(range(i, min(i + per_host, size))) for i in range(0, size, per_host)]


def make_hybrid_mesh(config: MeshConfig = MeshConfig(),
                     host_groups: Optional[Sequence] = None) -> Mesh:
    """Multi-host (data, model) mesh with host-major rank order.

    The data axis's outer dimension crosses hosts, so within-host shards
    stay on the host's NVLink and only cross-host reductions touch the
    network; tensor parallelism (model) stays strictly within a host: its
    collectives are per layer. ``host_groups`` (one rank list per host)
    defaults to ``host_groups_of_world()``; tests pass explicit groups to
    simulate hosts."""
    if host_groups is None:
        host_groups = host_groups_of_world()
    if len(host_groups) == 1:
        return make_mesh(config, devices=host_groups[0])
    per_host = len(host_groups[0])
    if any(len(g) != per_host for g in host_groups):
        raise ValueError("hosts must contribute equal device counts")
    req_data_size, model_size = config.shape
    if model_size < 1 or per_host % model_size:
        raise ValueError(
            f"model={model_size} must divide the {per_host} devices per "
            "host (tensor parallelism must not cross hosts)"
        )
    ordered = [d for g in host_groups for d in g]
    data_size = len(ordered) // model_size
    if req_data_size not in (-1, data_size):
        # the host-major (host, local_data) factorization cannot drop ranks
        raise ValueError(
            f"hybrid mesh uses all {len(ordered)} devices: data size must "
            f"be -1 or {data_size}, got {req_data_size}"
        )
    ranks = np.asarray(ordered).reshape(data_size, model_size)
    return Mesh(ranks, (config.data_axis, config.model_axis))


class Sharding(NamedTuple):
    """A placement on ``mesh``: ``spec[i]`` names the mesh axis that dim
    ``i`` is split over (None: whole on every rank), JAX's
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Mesh
    spec: tuple

    def shard(self, array):
        """This rank's block of a global ``array`` (numpy or tensor)."""
        index = [slice(None)] * len(self.spec)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, i = self.mesh.shape[axis], self.mesh.axis_index(axis)
            if array.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(array.shape)} not divisible by "
                                 f"{axis}={n}")
            step = array.shape[dim] // n
            index[dim] = slice(i * step, (i + 1) * step)
        return array[tuple(index)]


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """Shard the leading (batch) dim over the data axis, replicate the rest."""
    return Sharding(mesh, (DATA_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch(mesh: Mesh, array):
    """This rank's slice of a global batch: its batch dim split over
    ``data``."""
    return data_sharding(mesh, np.ndim(array)).shard(array)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """bf16 compute / f32 params+accum policy (tensor-core friendly)."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    accum_dtype: str = "float32"

    @property
    def compute(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def param(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)
