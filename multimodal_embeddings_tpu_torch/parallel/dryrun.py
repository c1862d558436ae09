"""Rank functions of the multi-rank checks and of the dryrun twin.

``launch`` (``core/mesh.py``) pickles the function it spawns by name, so the
functions the ranks run live here, in the port, and a spawned rank imports
torch and the port only. Each takes its inputs as numpy arrays, configs
and JAX flat parameter dicts, and returns numpy results:

* ``trainer_case``: one ``ContrastiveTrainer`` on a (data, model) mesh (or
  the host-major hybrid mesh), the global batch's gradient as a JAX flat
  dict, the metrics, then one train step;
* ``pipeline_case``: ``pipeline_apply``, ``pipeline_decode_step`` and
  ``pp_greedy_generate`` over a stage mesh;
* ``dryrun``: the training and pipeline parts of
  ``__graft_entry__.py::dryrun_multichip``, a dp×tp trainer step on
  ``DualEncoderConfig.tiny()`` (tp = 2 where the world is even) and a
  4-layer pipelined stack held to the sequential one within 1e-4;
  ``scripts/torch_dryrun_multichip.py`` prints its summary line.

``run_cases`` runs a list of (function name, kwargs) in one spawn and
returns rank 0's results.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.config import MeshConfig
from multimodal_embeddings_tpu_torch.core.mesh import (
    make_hybrid_mesh,
    make_mesh,
    rank_device,
    world,
)
from multimodal_embeddings_tpu_torch.models.qwen_pp import pp_greedy_generate
from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenBlock
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.transformer import LlamaBlock
from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
from multimodal_embeddings_tpu_torch.models.weights import init_random, load_jax_params
from multimodal_embeddings_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipeline_apply,
    pipeline_decode_step,
    stack_layer_params,
)
from multimodal_embeddings_tpu_torch.training.contrastive import (
    ContrastiveTrainer,
    TrainerConfig,
)


def trainer_case(model_config, trainer_config, shape, batch, params=None,
                 host_groups=None, device="cpu") -> dict:
    """A trainer on ``MeshConfig(shape=shape)`` (host-major over
    ``host_groups`` when given): {"ranks": the mesh's ranks, "metrics",
    "grads": the global batch's gradient (JAX flat, whole tensors), "step":
    the metrics of one train step after it, "leaves": the checkpoint's
    leaves after that step (whole tensors), "num_params"}."""
    config = MeshConfig(shape=shape)
    mesh = (make_mesh(config) if host_groups is None
            else make_hybrid_mesh(config, host_groups=host_groups))
    trainer = ContrastiveTrainer(model_config, trainer_config, mesh=mesh, device=device,
                                 params=params)
    metrics, grads = trainer.value_and_grad(*batch)
    step = trainer.train_step(*batch)
    return {"ranks": mesh.ranks.tolist(), "metrics": metrics, "grads": grads, "step": step,
            "leaves": trainer.checkpoint_leaves(), "num_params": trainer.num_params()}


def _llama_stack(block_args: dict, layers: List[Dict[str, np.ndarray]]) -> list:
    stack = []
    for flat in layers:
        block = LlamaBlock(**block_args)
        load_jax_params(block, flat)
        stack.append(block)
    return stack


def _qwen_stack(text_config, layers: List[Dict[str, np.ndarray]]) -> list:
    stack = []
    for flat in layers:
        block = QwenBlock(text_config, torch.float32)
        load_jax_params(block, flat)
        stack.append(block)
    return stack


def pipeline_case(kind: str, n_stages: int, **kw) -> Optional[dict]:
    """One pipeline check over ``make_pp_mesh(n_stages)`` (None on a rank
    outside it):

    * ``"apply"``: ``pipeline_apply`` of a LlamaBlock stack (``block_args``,
      JAX ``layers``) on ``x`` in ``microbatches`` → {"out"};
    * ``"qwen_prefill"``: the same over QwenBlocks with plain 1-D rotary
      tables ``cos``/``sin`` → {"out"};
    * ``"decode"``: ``steps`` cached decode steps of a QwenBlock stack, the
      inputs ``hs`` and tables ``tables`` given → {"outs", "caches"} (this
      rank's stage's caches);
    * ``"generate"``: ``pp_greedy_generate`` of ``config`` from JAX
      ``params`` → {"tokens"}."""
    mesh = make_pp_mesh(n_stages)
    if mesh.coords is None:
        return None
    with torch.inference_mode():
        if kind == "apply":
            stacked = stack_layer_params(_llama_stack(kw["block_args"], kw["layers"]), n_stages)
            out = pipeline_apply(lambda layer, h: layer(h), stacked, torch.from_numpy(kw["x"]),
                                 mesh=mesh, num_microbatches=kw["microbatches"])
            return {"out": out.numpy()}
        if kind == "qwen_prefill":
            cos, sin = torch.from_numpy(kw["cos"]), torch.from_numpy(kw["sin"])
            stacked = stack_layer_params(_qwen_stack(kw["text_config"], kw["layers"]), n_stages)
            out = pipeline_apply(lambda layer, h: layer(h, cos, sin)[0], stacked,
                                 torch.from_numpy(kw["x"]), mesh=mesh,
                                 num_microbatches=kw["microbatches"])
            return {"out": out.numpy()}
        if kind == "decode":
            stacked = stack_layer_params(_qwen_stack(kw["text_config"], kw["layers"]), n_stages)
            b, max_len = kw["batch"], kw["max_len"]
            cfg = kw["text_config"]
            shape = (b, max_len, cfg.kv_heads, cfg.head_dim)
            state = [[(torch.zeros(shape), torch.zeros(shape)) for _ in stage]
                     for stage in stacked]
            outs = []
            slots = torch.arange(max_len)
            for pos, (h, (cos, sin)) in enumerate(zip(kw["hs"], kw["tables"])):
                mask = (slots <= pos)[None, None, None, :]
                index = (torch.arange(b), torch.full((b,), pos))
                cos, sin = torch.from_numpy(cos), torch.from_numpy(sin)

                def layer_fn(layer, cache, hh, cos=cos, sin=sin, mask=mask, index=index):
                    return layer(hh, cos, sin, mask=mask, cache=cache, index=index)

                y, state = pipeline_decode_step(layer_fn, stacked, state, torch.from_numpy(h),
                                                mesh=mesh)
                outs.append(y.numpy())
            stage = mesh.axis_index("stage")
            caches = [(k.numpy(), v.numpy()) for k, v in state[stage]]
            return {"outs": outs, "caches": caches, "stage": stage}
        if kind == "generate":
            tokens = pp_greedy_generate(kw["config"], kw["params"], kw["prompt"], mesh=mesh,
                                        n_stages=n_stages, max_new_tokens=kw["max_new_tokens"],
                                        images=kw.get("images"), device="cpu")
            return {"tokens": tokens}
    raise ValueError(f"unknown pipeline case {kind!r}")


def run_cases(cases: List[tuple]) -> list:
    """Every ``(name, kwargs)`` of ``cases`` on this rank, in order, as
    ``{name}(**kwargs)`` of this module; the results of every case, each
    rank's list (``launch`` returns them all)."""
    return [globals()[name](**kwargs) for name, kwargs in cases]


def dryrun(device: str = "cpu") -> dict:
    """The training and pipeline parts of the JAX dryrun on this world:
    {"mesh", "params", "loss", "pp_stages", "pp_max_err"}; raises if the
    loss is not finite or the pipeline is off the sequential stack by 1e-4
    or more."""
    _, n = world()
    model_par = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(MeshConfig(shape=(n // model_par, model_par)))
    trainer = ContrastiveTrainer(DualEncoderConfig.tiny(),
                                 TrainerConfig(warmup_steps=1, total_steps=10),
                                 mesh=mesh, device=device)
    batch = max(8, n)
    size = trainer.model_config.vision.image_size
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    ids, mask = ByteTokenizer().encode_batch([f"sample text {i}" for i in range(batch)],
                                             trainer.model_config.text.max_len)
    metrics = trainer.train_step(images, ids, mask)
    if not np.isfinite(metrics["loss"]):
        raise RuntimeError(f"non-finite loss {metrics}")

    # PP: the same ranks as pipeline stages, a 4-layer decoder stack
    n_stages = next(s for s in (4, 2, 1) if s <= n)
    dev = rank_device(device)
    layers = []
    for seed in range(4):
        block = LlamaBlock(64, 4, 2, 16, 128)
        layers.append(init_random(block, seed).to(dev))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 8, 64)).astype(np.float32))
    x = x.to(dev)
    pp_mesh = make_pp_mesh(n_stages)
    with torch.inference_mode():
        ref = x
        for block in layers:
            ref = block(ref)
        out = ref
        if pp_mesh.coords is not None:
            out = pipeline_apply(lambda layer, h: layer(h), stack_layer_params(layers, n_stages),
                                 x, mesh=pp_mesh, num_microbatches=4)
    err = float((out - ref).abs().max())
    if not err < 1e-4:
        raise RuntimeError(f"pipeline != sequential (max err {err})")
    return {"mesh": dict(mesh.shape), "params": trainer.num_params(), "loss": metrics["loss"],
            "pp_stages": n_stages, "pp_max_err": err}
