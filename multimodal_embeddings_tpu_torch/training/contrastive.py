"""Contrastive (CLIP/mmE5-style) training for the dual encoder, in PyTorch.

Port of ``multimodal_embeddings_tpu/training/contrastive.py``: a
symmetric-InfoNCE train step built for the (data, model) mesh of
``core/mesh.py``. The batch splits over ``data``; the parameters are cut by
the logical rules of ``parallel/sharding.py`` (tensor parallel over
``model``); every rank all-gathers the embeddings (autograd-aware) and
computes the loss of the GLOBAL batch, as JAX's jitted step does.

Gradients: every collective's backward sums over the ranks, so each rank's
gradients are those of the sum of the ranks' (equal) losses. Summing a
parameter's gradient over the ranks that hold a copy (all of them for a
replicated parameter, the data axis for a tensor-parallel block) and
dividing by the world size gives the single-device gradient of the global
batch; it is not multiplied by the data-axis size.

On the card the ViT's attention runs K1 (``kernels/encoder_attention.py``)
through ``KernelAttention``: the kernel forward, a plain tensor-code
backward. The JAX trainer trains only where no Pallas kernel is on its path
(``jax.grad`` cannot linearize one): on the CPU, or a TPU below the ViT's
whole-row window.

``make_optimizer`` reproduces ``optax.chain(clip_by_global_norm,
adamw(warmup_cosine_decay_schedule))`` step for step; its traps are named
where they are implemented. Checkpoints keep JAX's ``.npz`` keys: ``p{i}``
the parameters in JAX's leaf order (sorted paths) and layout, ``o{i}``
optax's state leaves (Adam's count, μ, ν, the schedule's count), ``step``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_embeddings_tpu_torch.core.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    rank_device,
    shard_batch,
    world,
)
from multimodal_embeddings_tpu_torch.models.vision_encoder import (
    DualEncoder,
    DualEncoderConfig,
)
from multimodal_embeddings_tpu_torch.models.transformer import Dense
from multimodal_embeddings_tpu_torch.models.weights import init_random, load_jax_params
from multimodal_embeddings_tpu_torch.parallel import sharding as psharding


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.98
    grad_clip: float = 1.0


class OptState(NamedTuple):
    """optax's state of the chain, in its leaf order: Adam's update count,
    μ and ν (one tensor per parameter, in the parameters' order and
    layout), the schedule's update count."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: int


def _f32(x) -> np.float32:
    return np.float32(x)


class Optimizer:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    weight_decay=weight_decay))`` with ``schedule =
    warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
    total_steps)``, over lists of tensors, in f32 as optax computes it:
    ``init(params)``, ``update(grads, state, params) -> (updates, state)``,
    ``apply_updates``."""

    def __init__(self, config: TrainerConfig):
        if config.total_steps - config.warmup_steps <= 0:
            # optax.cosine_decay_schedule refuses it when the schedule is built
            raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                             f"decay_steps={config.total_steps - config.warmup_steps}.")
        self.config = config

    def schedule(self, count: int) -> float:
        """The learning rate of update ``count`` (from 0), in f32. Trap: the
        schedule starts at its ``init_value`` of 0, so the FIRST update has
        learning rate 0 and leaves the parameters as they were."""
        c = self.config
        peak = _f32(c.learning_rate)
        if count < c.warmup_steps:  # optax.linear_schedule(0, peak, warmup)
            frac = _f32(1) - _f32(min(max(count, 0), c.warmup_steps)) / _f32(c.warmup_steps)
            return float((_f32(0) - peak) * frac + peak)
        # optax.cosine_decay_schedule(peak, total - warmup), alpha 0
        decay = _f32(c.total_steps - c.warmup_steps)
        t = min(_f32(count - c.warmup_steps), decay)
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * t / decay, dtype=np.float32))
        return float(peak * cosine)

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(0, zeros, [z.clone() for z in zeros], 0)

    def update(self, grads: List[torch.Tensor], state: OptState, params: List[torch.Tensor],
               reduce_sq: Optional[Callable] = None) -> Tuple[List[torch.Tensor], OptState]:
        """The chain's updates and next state. ``reduce_sq`` maps the list
        of per-leaf sums of squares to their total over every rank's blocks
        (tensor parallelism); None sums them."""
        c = self.config
        sq = [(g.float() * g.float()).sum() for g in grads]
        total = reduce_sq(sq) if reduce_sq is not None else torch.stack(sq).sum()
        g_norm = torch.sqrt(total)
        # Trap: optax scales by max/‖g‖ only when ‖g‖ >= max (its trigger is
        # ‖g‖ < max), with no epsilon; torch.nn.utils.clip_grad_norm_ adds
        # 1e-6 to the norm and would not give optax's updates
        clip = not bool(g_norm < c.grad_clip)
        count = state.count + 1
        # optax's bias corrections, 1 - b**count in f32
        bc1 = float(1 - torch.tensor(c.b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(c.b2, dtype=torch.float32) ** count)
        step = -self.schedule(state.schedule_count)
        updates, mus, nus = [], [], []
        for g, mu, nu, p in zip(grads, state.mu, state.nu, params):
            g = g.float()
            if clip:
                g = (g / g_norm) * c.grad_clip
            mu = (1 - c.b1) * g + c.b1 * mu
            nu = (1 - c.b2) * (g * g) + c.b2 * nu
            # Trap: adamw's eps is 1e-8 outside the square root, and it
            # decays EVERY leaf (its mask is None), logit_scale included
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)
            u = u + c.weight_decay * p.float()
            updates.append(step * u)
            mus.append(mu)
            nus.append(nu)
        return updates, OptState(count, mus, nus, state.schedule_count + 1)

    @staticmethod
    def apply_updates(params: List[torch.Tensor], updates: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for p, u in zip(params, updates):
                p.copy_((p.float() + u).to(p.dtype))


def make_optimizer(config: TrainerConfig) -> Optimizer:
    return Optimizer(config)


def clip_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
              scale: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over the global batch. Embeddings are already
    L2-normalised, so logits = scale · cosine similarities, in f32.
    ``accuracy`` takes the first index of a tied row maximum, as
    ``jnp.argmax``."""
    logits = scale * torch.matmul(img_emb.float(), txt_emb.float().t())
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss_i = F.cross_entropy(logits, labels, reduction="none")
    loss_t = F.cross_entropy(logits.t(), labels, reduction="none")
    loss = (loss_i.mean() + loss_t.mean()) / 2
    accuracy = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy, "scale": scale.squeeze()}


class Leaf(NamedTuple):
    """A parameter as a JAX leaf: its path, the port parameter's name, the
    dim the model axis splits (None: replicated) and the layout maps
    between a whole port tensor and the JAX array."""

    path: tuple
    name: str
    shard_dim: Optional[int]
    to_jax: Callable
    from_jax: Callable


def jax_leaves(model: nn.Module) -> List[Leaf]:
    """``model``'s parameters in JAX's leaf order (sorted paths): a Dense
    weight is its kernel (reshaped to ``kernel_shape``), a conv weight its
    HWIO kernel, the rest as they are."""
    dims = psharding.param_shard_dims(model)
    leaves = []
    for name, p in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        path = tuple(owner_name.split(".")) if owner_name else ()
        if isinstance(owner, Dense) and leaf == "weight":
            shape = tuple(owner.kernel_shape)
            rows = math.prod(shape) // p.shape[1] if dims[name] != 1 else p.shape[0]
            whole = (rows, math.prod(shape) // rows)
            to_jax = lambda t, s=shape: t.reshape(s)  # noqa: E731
            from_jax = lambda a, s=whole: a.reshape(s)  # noqa: E731
            path += ("kernel",)
        elif isinstance(owner, nn.Conv2d) and leaf == "weight":
            to_jax = lambda t: t.permute(2, 3, 1, 0)  # noqa: E731
            from_jax = lambda a: a.permute(3, 2, 0, 1)  # noqa: E731
            path += ("kernel",)
        else:
            to_jax = from_jax = lambda t: t  # noqa: E731
            path += (leaf,)
        leaves.append(Leaf(path, name, dims[name], to_jax, from_jax))
    return sorted(leaves, key=lambda leaf: leaf.path)


class ContrastiveTrainer:
    """Owns model, parameters and optimizer state; ``train_step`` runs one
    mesh-aware step on the global batch.

    Parameters come from ``params`` (a JAX ``flatten_params`` dict, through
    ``models/weights.py::load_jax_params``), else ``init_random(seed)``.
    The model computes in ``dtype`` (its parameters are stored in it: the
    JAX trainer keeps f32 parameters under a bf16 compute type). On
    ``device`` (the card unless ``"cpu"``; under a mesh, this rank's
    card)."""

    def __init__(
        self,
        model_config: DualEncoderConfig = DualEncoderConfig.base(),
        trainer_config: TrainerConfig = TrainerConfig(),
        mesh: Optional[Mesh] = None,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        device="cuda",
        params: Optional[Dict[str, Any]] = None,
    ):
        self.device = rank_device(device)
        self.model_config = model_config
        self.mesh = mesh
        self.tx = make_optimizer(trainer_config)
        model = DualEncoder(model_config)
        if params is None:
            init_random(model, seed)
        else:
            load_jax_params(model.float(), params)
        if mesh is not None:
            psharding.shard_variables(model, mesh)
        self.model = model.to(device=self.device, dtype=dtype)
        self.leaves = jax_leaves(self.model)
        self.params = [self.model.get_parameter(leaf.name) for leaf in self.leaves]
        self.opt_state = self.tx.init(self.params)
        self.step = 0

    # -- the mesh ----------------------------------------------------------

    def _size(self, axis: Optional[str] = None) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.size if axis is None else self.mesh.shape[axis]

    def shard_batch(self, array):
        if self.mesh is None:
            return array
        return shard_batch(self.mesh, array)

    def _reduce_grads(self) -> None:
        """Each gradient summed over the ranks holding a copy of its
        parameter (the whole mesh, or the data axis for a tensor-parallel
        block) and divided by the world size: the global batch's gradient."""
        n = self._size()
        if n == 1:
            return
        for leaf, p in zip(self.leaves, self.params):
            axis = DATA_AXIS if leaf.shard_dim is not None else None
            self.mesh.all_reduce(p.grad, axis).div_(n)

    def _reduce_sq(self, sq: List[torch.Tensor]) -> torch.Tensor:
        """The sum of squares of the whole gradient: a tensor-parallel
        block's over the model axis, a replicated one's once."""
        sharded = [s for s, leaf in zip(sq, self.leaves) if leaf.shard_dim is not None]
        total = torch.stack(sq).sum()
        if not sharded or self._size(MODEL_AXIS) == 1:
            return total
        part = torch.stack(sharded).sum()
        return total - part + self.mesh.all_reduce(part.clone(), MODEL_AXIS)

    # -- the step ----------------------------------------------------------

    def _inputs(self, *arrays):
        """This rank's slices of the global images, token ids and mask (numpy
        or tensors) on its device."""
        dtypes = (torch.float32, torch.long, torch.long)
        return tuple(self.shard_batch(torch.as_tensor(a)).to(self.device, d)
                     for a, d in zip(arrays, dtypes))

    def _backward(self, images, token_ids, attention_mask) -> Dict[str, torch.Tensor]:
        """Loss and metrics of the global batch; leaves the global batch's
        gradient in each parameter's ``.grad``."""
        for p in self.params:
            p.grad = None
        images, token_ids, attention_mask = self._inputs(images, token_ids, attention_mask)
        with torch.enable_grad():
            img, txt, scale = self.model(images, token_ids, attention_mask)
            if self._size(DATA_AXIS) > 1:
                img = self.mesh.all_gather(img, DATA_AXIS, grad=True)
                txt = self.mesh.all_gather(txt, DATA_AXIS, grad=True)
            loss, metrics = clip_loss(img, txt, scale)
            loss.backward()
        self._reduce_grads()
        return metrics

    def value_and_grad(self, images, token_ids, attention_mask):
        """(metrics as floats, the global batch's gradient as a JAX flat dict
        ``{"params/<path>": numpy}`` of whole tensors); no update."""
        metrics = self._backward(images, token_ids, attention_mask)
        grads = self._flat([p.grad for p in self.params])
        return {k: float(v.detach()) for k, v in metrics.items()}, grads

    def train_step(self, images, token_ids, attention_mask) -> Dict[str, float]:
        metrics = self._backward(images, token_ids, attention_mask)
        grads = [p.grad for p in self.params]
        updates, self.opt_state = self.tx.update(grads, self.opt_state, self.params,
                                                 self._reduce_sq)
        self.tx.apply_updates(self.params, updates)
        self.step += 1
        return {k: float(v.detach()) for k, v in metrics.items()}

    def num_params(self) -> int:
        """The whole model's parameter count (every rank's blocks)."""
        n = self._size(MODEL_AXIS)
        return sum(p.numel() * (n if leaf.shard_dim is not None else 1)
                   for leaf, p in zip(self.leaves, self.params))

    # -- whole tensors in JAX's layout ---------------------------------------

    def _whole(self, leaf: Leaf, t: torch.Tensor) -> torch.Tensor:
        if leaf.shard_dim is None:
            return t
        return self.mesh.all_gather(t.detach(), MODEL_AXIS, dim=leaf.shard_dim)

    def _flat(self, tensors) -> Dict[str, np.ndarray]:
        return {"/".join(("params",) + leaf.path):
                leaf.to_jax(self._whole(leaf, t).detach().float().cpu()).numpy()
                for leaf, t in zip(self.leaves, tensors)}

    def _block(self, leaf: Leaf, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole port tensor."""
        if leaf.shard_dim is None:
            return whole
        n = self._size(MODEL_AXIS)
        return whole.chunk(n, leaf.shard_dim)[self.mesh.axis_index(MODEL_AXIS)]

    def jax_params(self) -> Dict[str, np.ndarray]:
        """The parameters as a JAX flat dict of whole numpy arrays."""
        return self._flat(self.params)

    def checkpoint_leaves(self) -> Dict[str, np.ndarray]:
        """JAX's ``save_trainer_checkpoint`` keys: ``p{i}`` the parameters,
        ``o{i}`` the optimizer state, ``step``."""
        flat = {}
        for i, v in enumerate(self.jax_params().values()):
            flat[f"p{i}"] = v
        state = self.opt_state
        o = [np.asarray(state.count, np.int32)]
        for moments in (state.mu, state.nu):
            o += list(self._flat(moments).values())
        o.append(np.asarray(state.schedule_count, np.int32))
        for i, v in enumerate(o):
            flat[f"o{i}"] = v
        flat["step"] = np.asarray(self.step)
        return flat

    def load_checkpoint_leaves(self, flat: Dict[str, np.ndarray]) -> None:
        """Restore from ``checkpoint_leaves``' keys, each shape checked
        against this trainer's (whole) leaf, as JAX's restore checks."""
        self.step = int(flat["step"])
        n = len(self.leaves)

        def read(key, want_shape):
            stored = flat[key]
            if tuple(stored.shape) != tuple(want_shape):
                raise ValueError(f"shape mismatch restoring {key}: "
                                 f"{stored.shape} vs {tuple(want_shape)}")
            return stored

        wholes = self.jax_params()
        shapes = [a.shape for a in wholes.values()]
        with torch.no_grad():
            for i, (leaf, p) in enumerate(zip(self.leaves, self.params)):
                a = torch.from_numpy(np.array(read(f"p{i}", shapes[i]), np.float32))
                p.copy_(self._block(leaf, leaf.from_jax(a)).to(p.dtype))
        count = int(read("o0", ()))
        moments = []
        for j in range(2):
            ms = []
            for i, leaf in enumerate(self.leaves):
                a = torch.from_numpy(np.array(read(f"o{1 + j * n + i}", shapes[i]), np.float32))
                ms.append(self._block(leaf, leaf.from_jax(a)).contiguous().to(self.device))
            moments.append(ms)
        self.opt_state = OptState(count, moments[0], moments[1], int(read(f"o{1 + 2 * n}", ())))


# ---------------------------------------------------------------------------
# Trainer checkpointing
# ---------------------------------------------------------------------------


def save_trainer_checkpoint(trainer: ContrastiveTrainer, path: str) -> None:
    """Persist params + optimizer state + step as a flat ``.npz`` in JAX's
    keys and layouts (a JAX trainer of the same config restores it). Under
    a mesh every rank takes part and rank 0 writes."""
    flat = trainer.checkpoint_leaves()
    if world()[0] == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, **flat)


def restore_trainer_checkpoint(trainer: ContrastiveTrainer, path: str) -> None:
    """Restore params + optimizer state + step in place (shape-validated
    against the trainer's whole leaves); reads a JAX trainer's file."""
    with np.load(path, allow_pickle=False) as data:
        flat = {key: data[key] for key in data.files}
    trainer.load_checkpoint_leaves(flat)
