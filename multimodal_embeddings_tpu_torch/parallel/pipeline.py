"""Pipeline parallelism over a ``stage`` axis of ranks (GPipe schedule).

Port of ``multimodal_embeddings_tpu/parallel/pipeline.py``, the scale-out
path of the Qwen2.5-VL-32B decoder stack. The layer stack is split into S
contiguous stages, stage s runs on the rank at position s of the stage
axis, and activations hop stage → stage by ``torch.distributed`` point to
point messages: with M microbatches, M + S − 1 ticks, and at each tick
every stage with a microbatch on hand runs it and sends the result on (one
``send``/``recv`` per stage per tick). The bubble fraction is
(S − 1)/(M + S − 1).

Where JAX runs every stage on every tick (padding during fill and drain,
branchless, one traced program), a rank here runs only its active ticks
and waits for its input; the last stage's outputs are broadcast to every
stage, so that each rank returns the global output, as JAX's stage-sharded
output carries it home. ``S == 1`` is a plain loop over the layers.

A stage's parameters and states are the entries of per-stage lists
(``stack_layer_params``): layer modules or state dicts, whatever
``layer_fn`` takes; a rank reads only its own stage's entry.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from multimodal_embeddings_tpu_torch.core.mesh import Mesh, world

STAGE_AXIS = "stage"


def make_pp_mesh(n_stages: int, devices: Optional[Sequence] = None) -> Mesh:
    """1-D (stage,) mesh over the first ``n_stages`` of ``devices`` (global
    ranks; every rank of the world by default). Every rank of the world
    calls it."""
    devices = list(devices if devices is not None else range(world()[1]))
    if len(devices) < n_stages:
        raise ValueError(f"need {n_stages} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_stages]), (STAGE_AXIS,))


def stack_layer_params(layer_params: Sequence, n_stages: int) -> List[list]:
    """Per-layer parameters (one entry per layer: a module or a state
    dict) as per-stage lists: the first L/S layers → stage 0, ..."""
    n_layers = len(layer_params)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [list(layer_params[s * per : (s + 1) * per]) for s in range(n_stages)]


def _stage(mesh: Mesh, stage_axis: str, stacked) -> tuple:
    n = mesh.shape[stage_axis]
    if len(stacked) != n:
        raise ValueError(f"{len(stacked)} stages of parameters for {stage_axis}={n}")
    return n, mesh.axis_index(stage_axis), mesh.axis_ranks(stage_axis), mesh.group(stage_axis)


def pipeline_apply(
    layer_fn: Callable,
    stacked_params: Sequence[list],
    x: torch.Tensor,
    *,
    mesh: Mesh,
    num_microbatches: int,
    stage_axis: str = STAGE_AXIS,
) -> torch.Tensor:
    """Run a layer stack as an S-stage GPipe pipeline over ``mesh``.

    Args:
        layer_fn: ``layer_fn(one_layer, h) -> h``, a single layer's forward
            on one microbatch, of the microbatch's shape.
        stacked_params: per-stage lists of layers (``stack_layer_params``).
        x: the global input batch ``(B, ...)``, on every rank; ``B`` must be
            divisible by ``num_microbatches``.
        mesh: a mesh with ``stage_axis`` of size S.
        num_microbatches: M; the stages are busy M/(M+S−1) of the ticks.

    Returns:
        ``(B, ...)`` output batch on every rank, microbatch order kept.
    """
    b = x.shape[0]
    m = num_microbatches
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    n, s, ranks, group = _stage(mesh, stage_axis, stacked_params)
    if n == 1:
        h = x
        for layer in stacked_params[0]:
            h = layer_fn(layer, h)
        return h
    x_mb = x.reshape(m, b // m, *x.shape[1:])
    y = torch.empty_like(x_mb)
    sends = []
    for t in range(m + n - 1):
        mb = t - s  # the microbatch this stage holds at tick t
        if not 0 <= mb < m:
            continue
        if s == 0:
            h = x_mb[mb]
        else:
            h = torch.empty_like(x_mb[0])
            dist.recv(h, src=ranks[s - 1], group=group)
        for layer in stacked_params[s]:
            h = layer_fn(layer, h)
        if s == n - 1:
            y[mb] = h
        else:
            h = h.contiguous()
            sends.append((dist.isend(h, dst=ranks[s + 1], group=group), h))
    for work, _ in sends:
        work.wait()
    dist.broadcast(y, src=ranks[-1], group=group)
    return y.reshape(b, *x.shape[1:])


def pipeline_decode_step(
    layer_fn: Callable,
    stacked_params: Sequence[list],
    state: Sequence[list],
    x: torch.Tensor,
    *,
    mesh: Mesh,
    stage_axis: str = STAGE_AXIS,
):
    """One autoregressive decode step through an S-stage pipeline.

    Decoding one token is sequential across stages (token t+1 cannot enter
    stage 0 before token t leaves the sampler), so PP decode buys fit, not
    speed: each stage holds its layers and their KV caches, and the hidden
    state passes the stage ring once.

    Args:
        layer_fn: ``layer_fn(one_layer, one_layer_state, h) -> (h,
            new_layer_state)``, e.g. a cached-attention decoder block.
        stacked_params: per-stage lists of layers.
        state: per-stage lists of per-layer states (KV caches), laid out as
            ``stacked_params``; a rank reads and replaces its stage's only.
        x: ``(B, ...)`` decode-step activations for the whole batch; each
            stage's output has its shape.

    Returns:
        ``(y, new_state)``: the last stage's output on every rank, and
        ``state`` with this stage's entry replaced by the states its layers
        returned on its one active tick (tick s of S).
    """
    n, s, ranks, group = _stage(mesh, stage_axis, stacked_params)
    # stage s's one active tick is tick s: its input arrives from stage s-1
    h = x
    if s > 0:
        h = torch.empty_like(x)
        dist.recv(h, src=ranks[s - 1], group=group)
    committed = []
    for layer, layer_state in zip(stacked_params[s], state[s]):
        h, layer_state = layer_fn(layer, layer_state, h)
        committed.append(layer_state)
    new_state = list(state)
    new_state[s] = committed
    if s < n - 1:
        dist.send(h.contiguous(), dst=ranks[s + 1], group=group)
    if n == 1:
        return h, new_state
    y = h.contiguous() if s == n - 1 else torch.empty_like(x)
    dist.broadcast(y, src=ranks[-1], group=group)
    return y, new_state
