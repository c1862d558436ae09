"""Sharding rules: logical parameter axes → mesh axes, on ``torch.distributed``.

Port of ``multimodal_embeddings_tpu/parallel/sharding.py``. The JAX models
annotate each kernel with logical axis names and XLA partitions them; the
port reads the same names off each ``Dense`` (by its name and
``kernel_shape``) and ``Embed`` and cuts the weights itself, Megatron-style:

* attention q/k/v project ``embed → (heads, head_dim)`` with **heads over
  model** (column-parallel: each rank computes its heads); the output
  projection reduces ``(heads, head_dim) → embed`` (row-parallel: each rank's
  partial product, then an all-reduce over ``model``);
* MLP fc1 (gate/up) shard the hidden dim over model, fc2 (down) reduces;
* the text tower's embedding shards the vocab axis (each rank looks up the
  ids in its rows, then an all-reduce); everything else is replicated.

The all-reduces are the mesh's autograd-aware ones (``core/mesh.py``),
whose backward sums the gradients of every rank's copy, as
``torch.distributed.nn.functional``'s does. So the gradients on the
ranks are those of the SUM of the ranks' losses: ``training/contrastive.py``
sums each parameter's gradient over the ranks holding a copy and divides by
the world size. Batch (data) sharding is applied to inputs, not parameters
(``core/mesh.py::shard_batch``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from multimodal_embeddings_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    Sharding,
    data_sharding,
)
from multimodal_embeddings_tpu_torch.models.mme5 import Embed
from multimodal_embeddings_tpu_torch.models.transformer import (
    Attention,
    Dense,
    GeluMLP,
    SwiGLU,
)

# logical axis name → mesh axis (None = replicate)
LOGICAL_AXIS_RULES = (
    ("embed", None),
    ("heads", MODEL_AXIS),
    ("kv_heads", MODEL_AXIS),
    ("head_dim", None),
    ("mlp", MODEL_AXIS),
    ("vocab", MODEL_AXIS),
    ("batch", DATA_AXIS),
)

# the JAX models' annotations by the module's name and its kernel's rank
_DENSE_AXES = {
    ("q", 3): ("embed", "heads", "head_dim"),
    ("k", 3): ("embed", "kv_heads", "head_dim"),
    ("v", 3): ("embed", "kv_heads", "head_dim"),
    ("o", 3): ("heads", "head_dim", "embed"),
    ("fc1", 2): ("embed", "mlp"),
    ("gate", 2): ("embed", "mlp"),
    ("up", 2): ("embed", "mlp"),
    ("fc2", 2): ("mlp", "embed"),
    ("down", 2): ("mlp", "embed"),
    ("proj", 2): ("embed", None),
}


def logical_axes(name: str, module: nn.Module) -> Optional[tuple]:
    """The logical axes of a ``Dense`` kernel (its ``kernel_shape``) or an
    ``Embed`` table, as the JAX models annotate them; None for a parameter
    they leave unannotated."""
    if isinstance(module, Embed):
        return ("vocab", "embed")
    if isinstance(module, Dense):
        return _DENSE_AXES.get((name.rsplit(".", 1)[-1], len(module.kernel_shape)))
    return None


def mesh_axes(axes: tuple) -> tuple:
    """Logical axes → mesh axes by ``LOGICAL_AXIS_RULES``."""
    rules = dict(LOGICAL_AXIS_RULES)
    return tuple(rules.get(a) for a in axes)


def weight_shard_dim(module: Dense, axes: tuple) -> Optional[int]:
    """The dim of the port's ``(in, out)`` weight that ``model`` splits: 0
    (row-parallel) when the sharded logical axis is a contraction axis, 1
    (column-parallel) when it is an output axis; None when unsharded. The
    sharded axis must lead its group, so that each rank's block is
    contiguous."""
    placed = mesh_axes(axes)
    if MODEL_AXIS not in placed:
        return None
    i = placed.index(MODEL_AXIS)
    shape, n_in, size = module.kernel_shape, 0, 1
    while size < module.weight.shape[0]:
        size *= shape[n_in]
        n_in += 1
    if i not in (0, n_in):
        raise ValueError(f"axis {axes[i]} of {shape} does not lead its group")
    return 0 if i < n_in else 1


class ColumnParallelDense(Dense):
    """This rank's columns of a ``Dense`` (and its bias): a block of the
    output. ``kernel_shape`` stays the whole kernel's, for the bridge."""

    shard_dims = {"weight": 1, "bias": 0}


class RowParallelDense(Dense):
    """This rank's rows of a ``Dense``: a partial product, summed over the
    model axis (autograd-aware), then the whole bias."""

    shard_dims = {"weight": 0, "bias": None}

    def __init__(self, dense: Dense, mesh: Mesh):
        super().__init__(1, 1, dense.bias is not None, dense.kernel_shape)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        y = self.reduce(x.to(w.dtype) @ w)
        return y if self.bias is None else y + self.bias.reshape(-1).to(w.dtype)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(y, MODEL_AXIS, grad=True)


class VocabParallelEmbed(Embed):
    """This rank's rows of an ``Embed`` table: ids outside them look up
    zeros, and the all-reduce over the model axis (autograd-aware) adds the
    ranks' rows."""

    shard_dims = {"embedding": 0}

    def __init__(self, embed: Embed, mesh: Mesh):
        super().__init__(1, 1, embed.dtype)
        self.mesh = mesh

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        rows = self.embedding.shape[0]
        lo = self.mesh.axis_index(MODEL_AXIS) * rows
        local = ids - lo
        inside = (local >= 0) & (local < rows)
        out = self.embedding[local.clamp(0, rows - 1)] * inside[..., None]
        return self.mesh.all_reduce(out, MODEL_AXIS, grad=True).to(self.dtype)


def _block(t: torch.Tensor, dim: int, n: int, i: int) -> nn.Parameter:
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible by model={n}")
    return nn.Parameter(t.detach().chunk(n, dim)[i].clone(), requires_grad=t.requires_grad)


def shard_variables(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``module``'s parameters for this rank by their logical axes, in
    place: q/k/v and fc1/gate/up column-parallel, o and fc2/down
    row-parallel, embeddings vocab-parallel, the attention modules' head
    counts divided by the model axis. With ``model`` of size 1 nothing
    changes. Returns ``module``."""
    n = mesh.shape[MODEL_AXIS]
    if n == 1:
        return module
    i = mesh.axis_index(MODEL_AXIS)
    sites = [(name, m) for name, m in module.named_modules() if logical_axes(name, m)]
    for name, m in sites:
        axes = logical_axes(name, m)
        parent_name, _, leaf = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        if isinstance(m, Embed):
            new = VocabParallelEmbed(m, mesh)
            new.embedding = _block(m.embedding, 0, n, i)
        else:
            dim = weight_shard_dim(m, axes)
            if dim is None:
                continue
            if not isinstance(parent, (Attention, GeluMLP, SwiGLU)):
                raise ValueError(f"{name}: no tensor-parallel rule for a "
                                 f"{type(parent).__name__}")
            if dim == 1:
                new = ColumnParallelDense(1, 1, m.bias is not None, m.kernel_shape)
                if m.bias is not None:
                    new.bias = _block(m.bias.reshape(-1), 0, n, i)
            else:
                new = RowParallelDense(m, mesh)
                new.bias = m.bias
            new.weight = _block(m.weight, dim, n, i)
        setattr(parent, leaf, new)
    for m in module.modules():
        if isinstance(m, Attention):
            if m.num_heads % n or m.num_kv_heads % n:
                raise ValueError(f"{m.num_heads}/{m.num_kv_heads} heads over model={n}")
            m.num_heads //= n
            m.num_kv_heads //= n
    return module


def param_shard_dims(module: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's name → the dim the model axis splits (None:
    replicated)."""
    dims = {}
    for name, p in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        dims[name] = getattr(module.get_submodule(owner), "shard_dims", {}).get(leaf)
    return dims


def unbox(variables):
    """The identity: the port's parameters carry no partitioning metadata."""
    return variables


def batch_spec(mesh: Mesh, ndim: int) -> Sharding:
    return data_sharding(mesh, ndim)
