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
* ``store_case``: ``sharded_masked_topk`` and ``Collection.set_mesh``
  over a data mesh of the first ranks;
* ``embedder_case``: ``MultimodalEmbedder(mesh=)``'s image embeddings;
* ``batch_case``: ``build_fused_batch_fn`` / ``build_split_batch_fn`` over
  a (data, model) mesh;
* ``dryrun``: ``__graft_entry__.py::dryrun_multichip`` on this world: a
  dp×tp trainer step on ``DualEncoderConfig.tiny()`` (tp = 2 where the
  world is even), a 4-layer pipelined stack held to the sequential one
  within 1e-4, the serving checks (the fused batch over every rank against
  the page function per page, < 1e-4; tiny mmE5 tensor-parallel over
  (N/2, 2) against the unsharded embedder, < 2e-5, and the dp×tp split
  batch against the split page function, < 1e-4; the hybrid mesh on two
  simulated host groups) and the data-parallel parse (tokens EQUAL to the
  single-device ones); ``scripts/torch_dryrun_multichip.py`` prints its
  summary line.

``run_cases`` runs a list of (function name, kwargs) in one spawn and
returns rank 0's results.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig, MeshConfig
from multimodal_embeddings_tpu_torch.core.mesh import (
    make_hybrid_mesh,
    make_mesh,
    rank_device,
    world,
)
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
from multimodal_embeddings_tpu_torch.models.qwen_pp import pp_greedy_generate
from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenBlock, QwenVLConfig, greedy_generate
from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
from multimodal_embeddings_tpu_torch.models.transformer import LlamaBlock
from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
from multimodal_embeddings_tpu_torch.models.weights import init_random, load_jax_params
from multimodal_embeddings_tpu_torch.models.weights import build_qwen
from multimodal_embeddings_tpu_torch.parallel.pipeline import (
    make_pp_mesh,
    pipeline_apply,
    pipeline_decode_step,
    stack_layer_params,
)
from multimodal_embeddings_tpu_torch.pipeline.fused import (
    build_fused_batch_fn,
    build_fused_page_fn,
    build_split_batch_fn,
    build_split_page_fn,
)
from multimodal_embeddings_tpu_torch.store.embedding_store import (
    Collection,
    sharded_masked_topk,
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


def _first_ranks_mesh(shape):
    """A (data, model) mesh of ``shape`` over the world's first ranks (every
    rank calls this; the rest get a mesh without a place in it)."""
    return make_mesh(MeshConfig(shape=tuple(shape)),
                     devices=list(range(int(np.prod(shape)))))


def store_case(data: int, corpus=None, queries=None, mask=None, k: int = 0, path=None,
               name=None, n_results: int = 0, where=None) -> Optional[dict]:
    """Over a data mesh of ``data`` ranks (None outside it): with
    ``corpus``, ``sharded_masked_topk`` → {"sims", "idx"}; with ``path``,
    the collection ``name`` there queried by ``queries`` after
    ``set_mesh`` and after ``set_mesh(None)`` → {"sharded", "single"}."""
    mesh = _first_ranks_mesh((data, 1))
    if mesh.coords is None:
        return None
    if corpus is not None:
        sims, idx = sharded_masked_topk(corpus, queries, mask, k, mesh, "data", device="cpu")
        return {"sims": sims.numpy(), "idx": idx.numpy()}
    col = Collection(path, name, device="cpu")
    col.set_mesh(mesh)
    sharded = col.query(queries, n_results=n_results, where=where)
    col.set_mesh(None)
    return {"sharded": sharded, "single": col.query(queries, n_results=n_results, where=where)}


def embedder_case(shape, config: EmbedderConfig, model_config, images, batch_size: int,
                  params=None) -> Optional[np.ndarray]:
    """``MultimodalEmbedder(config, mesh=)`` over a mesh of ``shape`` (None
    outside it), its parameters from JAX ``params`` (else seed 0) → the
    image embeddings of ``images`` (N, D)."""
    mesh = _first_ranks_mesh(shape)
    if mesh.coords is None:
        return None
    emb = MultimodalEmbedder(config, model_config=model_config, device="cpu", params=params,
                             mesh=mesh)
    return np.asarray(emb.get_image_embeddings(list(images), batch_size=batch_size))


def batch_case(build: str, shape, pages, page_hw, num_regions: int, detector_config,
               detector_params, embedder_config, model_config, embedder_params,
               embed_chunk: int = 8, letterbox: bool = False) -> Optional[list]:
    """``build_{build}_batch_fn`` over a (data, model) mesh of ``shape``
    (None outside it; the embedder tensor-sharded where model > 1), f32 on
    the CPU, the detector's and the embedder's parameters JAX flat dicts →
    the PageResult's fields as numpy arrays."""
    mesh = _first_ranks_mesh(shape)
    if mesh.coords is None:
        return None
    detector = LayoutDetector(detector_config, dtype=torch.float32, device="cpu",
                              params=detector_params)
    embedder = MultimodalEmbedder(embedder_config, model_config=model_config, device="cpu",
                                  params=embedder_params, mesh=mesh if shape[1] > 1 else None)
    if build == "fused":
        fn = build_fused_batch_fn(detector, embedder, page_hw, num_regions, mesh=mesh,
                                  letterbox=letterbox)
    else:
        fn = build_split_batch_fn(detector, embedder, page_hw, num_regions, embed_chunk,
                                  letterbox=letterbox, mesh=mesh)
    return [x.numpy() for x in fn(pages)]


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
            "pp_stages": n_stages, "pp_max_err": err, **_dryrun_serving(n, device),
            **_dryrun_parse(n, device)}


def _max_err(a, b) -> float:
    return float((torch.as_tensor(a).float().cpu() - torch.as_tensor(b).float().cpu())
                 .abs().max())


def _dryrun_serving(n: int, device: str) -> dict:
    """The serving part of the JAX dryrun on this world of ``n`` ranks:

    1. ``build_fused_batch_fn`` over a (n, 1) mesh, n pages, against
       ``build_fused_page_fn`` per page (< 1e-4);
    2. where n is even, a tiny mmE5 embedder tensor-sharded over (n/2, 2)
       against the unsharded one (< 2e-5), and the dp×tp split batch on
       n/2 pages against ``build_split_page_fn`` per page (< 1e-4);
    3. where n ≥ 4 is even, the hybrid mesh on two simulated host groups."""
    dev = rank_device(device)
    mesh = make_mesh(MeshConfig(shape=(n, 1)))
    detector = LayoutDetector(
        DetectorConfig(image_size=128, variant="n", grid_configs=(), max_detections=32),
        dtype=torch.float32, device=dev)
    siglip = MultimodalEmbedder(EmbedderConfig(family="siglip", dtype="float32"),
                                model_config=DualEncoderConfig.tiny(), device=dev)
    page_hw = (256, 200)
    batch_fn = build_fused_batch_fn(detector, siglip, page_hw, num_regions=4, mesh=mesh)
    page_fn = build_fused_page_fn(detector, siglip, page_hw, num_regions=4)
    pages = np.random.default_rng(0).integers(0, 255, (n, *page_hw, 3)).astype(np.uint8)
    got = batch_fn(pages)
    for b in range(n):
        err = _max_err(got.embeddings[b], page_fn(torch.from_numpy(pages[b]).to(dev)).embeddings)
        if not err < 1e-4:
            raise RuntimeError(f"dp-sharded fused page {b} != single-device ({err})")
    out = {"serving_dp_pages": n, "mme5_tp_max_err": None, "dp_tp_split_max_err": None,
           "hybrid_mesh": None}
    if n % 2 == 0:
        tp_mesh = make_mesh(MeshConfig(shape=(n // 2, 2)))
        cfg = EmbedderConfig(family="mme5", dtype="float32")
        sharded = MultimodalEmbedder(cfg, model_config=MllamaConfig.tiny(), device=dev,
                                     mesh=tp_mesh)
        plain = MultimodalEmbedder(cfg, model_config=MllamaConfig.tiny(), device=dev)
        img = np.full((40, 40, 3), 77, np.uint8)
        tp_err = _max_err(sharded.get_image_embeddings([img] * 2, batch_size=2),
                          plain.get_image_embeddings([img] * 2, batch_size=2))
        if not tp_err < 2e-5:
            raise RuntimeError(f"tp-sharded mme5 != single-device ({tp_err})")
        dp = n // 2
        split_batch = build_split_batch_fn(detector, sharded, page_hw, num_regions=4,
                                           embed_chunk=4, mesh=tp_mesh)
        split_page = build_split_page_fn(detector, plain, page_hw, num_regions=4, embed_chunk=4)
        got2 = split_batch(pages[:dp])
        sp_err = max(_max_err(got2.embeddings[b],
                              split_page(torch.from_numpy(pages[b]).to(dev)).embeddings)
                     for b in range(dp))
        if not sp_err < 1e-4:
            raise RuntimeError(f"dp×tp split serving != single-device ({sp_err})")
        out.update(mme5_tp_max_err=tp_err, dp_tp_split_max_err=sp_err)
    if n >= 4 and n % 2 == 0:
        half = n // 2
        hybrid = make_hybrid_mesh(MeshConfig(shape=(-1, 2)),
                                  host_groups=[list(range(half)), list(range(half, n))])
        out["hybrid_mesh"] = dict(hybrid.shape)
    return out


def _dryrun_parse(n: int, device: str) -> dict:
    """The data-parallel parse of the JAX dryrun: tiny Qwen2.5-VL tokens of
    n pages with the batch over a (n, 1) mesh (``DocumentParser(dp_mesh=)``'s
    generate) EQUAL to the single-device batched decode."""
    from multimodal_embeddings_tpu_torch.analysis.doc_parser import DocumentParser

    mesh = make_mesh(MeshConfig(shape=(n, 1)))
    model = build_qwen(QwenVLConfig.tiny(), torch.float32, rank_device(device), seed=0)
    rng = np.random.default_rng(0)
    ids = np.ones((n, 12), np.int32)
    ids[:, 3:7] = model.config.image_pad_id  # 2x2 merged grid at 56px
    imgs = rng.random((n, 56, 56, 3)).astype(np.float32)
    want = greedy_generate(model, ids, imgs, max_new_tokens=4)
    parser = DocumentParser(model, ByteTokenizer(), dp_mesh=mesh, device=rank_device(device))
    got = parser._dp_generate(ids, imgs, 4)
    if not np.array_equal(got, want):
        raise RuntimeError("dp parse != single-device tokens")
    return {"dp_parse_pages": n, "dp_parse_token_equal": True}
