"""Document-parsing CLI: page image → "QwenVL HTML" with data-bbox
attributes, plus the notebook's two post-processing artifacts.

Port of ``multimodal_embeddings_tpu/cli/parse.py`` with the same flags,
sizes and artifacts: per page ``<stem>.qwen.html`` (raw), ``<stem>.clean.html``
and, with ``--draw_bbox``, ``<stem>_bbox.jpg``; ``parse_index.json`` for the
run. ``--weights`` reads a JAX package ``.npz`` or ``.safetensors`` checkpoint
through the weight bridge; without it the model runs synthetic weights from seed 0.
``--device`` (default ``cuda``) picks the device; the model computes in
bf16 on the card and in f32 on the CPU.

    python -m multimodal_embeddings_tpu_torch.cli.parse --input_folder pages \\
        --output_folder out --size tiny --device cpu --max_new_tokens 8

``--continuous`` parses the whole queue in one call through the continuously
refilled decoder (``DocumentParser.parse_continuous``): ``--batch_size``
rows, refilled at ``--chunk``-step boundaries. With ``--skip_errors`` a page
that cannot be opened or decoded yields no output and the others stay in
that decoder.

    python -m multimodal_embeddings_tpu_torch.cli.parse --input_folder pages \\
        --output_folder out --size tiny --device cpu --max_new_tokens 8 \\
        --continuous --batch_size 2 --chunk 4

``--data_parallel N`` shards the batched parse over N ranks (pages on the
batch dim, the weights on every rank, ``--batch_size`` raised to N at
least); ``--pipeline_parallel N`` pipelines the decoder stack over N stage
ranks (``models/qwen_pp.py``; N must divide the decoder's layers). Either
way ``main`` spawns the N ranks itself (``core/mesh.py::launch``: one card a
rank over NCCL, gloo ranks under ``--device cpu``), or, started by a
launcher that set ``RANK``/``WORLD_SIZE`` (``torchrun --nproc_per_node N``),
joins that world as its rank. Rank 0 alone writes the outputs and logs; they
are byte for byte those of a single-device run. The two are mutually
exclusive, and ``--continuous`` takes neither, as in JAX.

    python -m multimodal_embeddings_tpu_torch.cli.parse --input_folder pages \\
        --output_folder out --size tiny --device cpu --max_new_tokens 8 \\
        --batch_size 2 --data_parallel 2
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
import os

import torch
import torch.distributed as dist

from multimodal_embeddings_tpu_torch.config import MeshConfig
from multimodal_embeddings_tpu_torch.core.mesh import (
    launch,
    make_mesh,
    quiet_other_ranks,
    rank_device,
    visible_devices,
    world,
)
from multimodal_embeddings_tpu_torch.io.images import get_image_paths
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = logging.getLogger("multimodal_embeddings_tpu_torch.cli.parse")

SIZES = (
    "tiny", "tiny-int8", "3b", "3b-int8", "3b-int4", "7b", "7b-int8",
    "32b", "32b-int8", "32b-int4",
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Parse pages into QwenVL HTML with data-bbox attributes"
    )
    parser.add_argument("--input_folder", default="newspaper_images")
    parser.add_argument("--output_folder", default="6_parsed_html")
    parser.add_argument("--size", choices=SIZES, default="3b")
    parser.add_argument("--weights", default=None, help="JAX package checkpoint (npz/safetensors)")
    parser.add_argument("--image_size", type=int, default=448)
    parser.add_argument("--max_new_tokens", type=int, default=1024)
    parser.add_argument("--dynamic_resolution", action="store_true",
                        help="Qwen2.5-VL native-aspect smart_resize grids")
    parser.add_argument("--max_pixels", type=int, default=None)
    parser.add_argument(
        "--pipeline_parallel",
        type=int,
        default=1,
        help="pipeline the decoder stack over this many chips (GPipe ring, "
        "models/qwen_pp.py) — the 32B notebook flagship serves at int8 + 4 "
        "stages ~ 10GB/chip, or int4 (the notebook's literal 4-bit storage "
        "class) + 2 stages ~ 11GB/chip; layer count must divide evenly",
    )
    parser.add_argument(
        "--data_parallel",
        type=int,
        default=1,
        help="shard batched parsing over this many chips (mesh data axis: "
        "pages shard on the batch dim, weights replicate, one SPMD "
        "generate program) — compose with --batch_size >= N for per-chip "
        "batching; mutually exclusive with --pipeline_parallel",
    )
    parser.add_argument("--batch_size", type=int, default=1,
                        help="pages per generate call (DocumentParser.parse_batch)")
    parser.add_argument(
        "--continuous",
        action="store_true",
        help="continuous batching (models/qwen_serve.py): keep "
        "--batch_size decoder rows busy with per-row EOS exit + page "
        "refill at --chunk-step boundaries — wall tracks the MEAN page "
        "length instead of each wave's max (parse_batch); tokens "
        "identical to per-page parse",
    )
    parser.add_argument(
        "--chunk",
        type=int,
        default=64,
        help="decode steps per refill boundary in --continuous mode",
    )
    parser.add_argument("--draw_bbox", action="store_true")
    parser.add_argument("--skip_errors", action="store_true",
                        help="log-and-continue on per-page failures")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def make_config(size: str):
    from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig

    return {
        "tiny": QwenVLConfig.tiny,
        "tiny-int8": lambda: dataclasses.replace(QwenVLConfig.tiny(), quantize=True),
        "3b": QwenVLConfig.qwen25_vl_3b,
        "3b-int8": QwenVLConfig.qwen25_vl_3b_int8,
        "3b-int4": QwenVLConfig.qwen25_vl_3b_int4,
        "7b": QwenVLConfig.qwen25_vl_7b,
        "7b-int8": QwenVLConfig.qwen25_vl_7b_int8,
        "32b": QwenVLConfig.qwen25_vl_32b,
        "32b-int8": QwenVLConfig.qwen25_vl_32b_int8,
        "32b-int4": QwenVLConfig.qwen25_vl_32b_int4,
    }[size]()


def check_scaleout(size: str, pipeline_parallel: int, data_parallel: int, continuous: bool,
                   device) -> None:
    """JAX's refusals of the parse meshes, with JAX's words and in JAX's
    order."""
    if data_parallel > 1:
        if pipeline_parallel > 1:
            raise SystemExit(
                "--data_parallel and --pipeline_parallel are mutually "
                "exclusive (dp replicates the weight tree; pp exists "
                "because it does not fit)"
            )
        if visible_devices(device) < data_parallel:
            raise SystemExit(
                f"--data_parallel {data_parallel}: only "
                f"{visible_devices(device)} devices visible"
            )
    if pipeline_parallel > 1:
        layers = make_config(size).text.layers
        if layers % pipeline_parallel:
            raise SystemExit(
                f"--pipeline_parallel {pipeline_parallel} must divide the "
                f"{layers}-layer decoder evenly"
            )
        if visible_devices(device) < pipeline_parallel:
            raise SystemExit(
                f"--pipeline_parallel {pipeline_parallel}: only "
                f"{visible_devices(device)} devices visible"
            )
    if continuous and (pipeline_parallel > 1 or data_parallel > 1):
        raise SystemExit(
            "--continuous schedules one device's rows; compose scale-out "
            "by sharding the page list across chips instead"
        )


def make_document_parser(
    size: str,
    weights: str | None,
    image_size: int,
    dynamic_resolution: bool,
    max_pixels: int | None,
    pipeline_parallel: int = 1,
    data_parallel: int = 1,
    device="cuda",
):
    """The parser of ``size`` on ``device``; under ``data_parallel`` or
    ``pipeline_parallel`` above 1 it is this rank's, on its mesh (every rank
    of a world of that size builds it)."""
    from multimodal_embeddings_tpu_torch.analysis.doc_parser import DocumentParser
    from multimodal_embeddings_tpu_torch.models.tokenizer import ByteTokenizer
    from multimodal_embeddings_tpu_torch.models.weights import build_qwen
    from multimodal_embeddings_tpu_torch.parallel.pipeline import make_pp_mesh

    scaled = data_parallel > 1 or pipeline_parallel > 1
    dev = rank_device(device) if scaled else resolve_device(device)
    config = make_config(size)
    if size.startswith("tiny"):
        image_size = min(image_size, 56)
    unit = config.vision.patch_size * config.vision.merge_size
    image_size = max(unit, (image_size // unit) * unit)
    compute = torch.bfloat16 if dev.type == "cuda" else torch.float32
    if not weights:
        logger.warning("document parser (%s) running with seeded synthetic weights "
                       "(no checkpoint configured)", size)
    model = build_qwen(config, compute, dev, seed=0, weights_path=weights)
    dp_mesh = make_mesh(MeshConfig(shape=(data_parallel, 1))) if data_parallel > 1 else None
    pp_mesh = make_pp_mesh(pipeline_parallel) if pipeline_parallel > 1 else None
    return DocumentParser(model, ByteTokenizer(), image_size=image_size,
                          dynamic_resolution=dynamic_resolution, max_pixels=max_pixels,
                          pp_mesh=pp_mesh,
                          pp_stages=pipeline_parallel if pipeline_parallel > 1 else None,
                          dp_mesh=dp_mesh, device=dev)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_scaleout(args.size, args.pipeline_parallel, args.data_parallel, args.continuous,
                   args.device)
    ranks = max(args.pipeline_parallel, args.data_parallel)
    if ranks > 1 and not dist.is_initialized():
        # by its importable name, which a spawned rank unpickles
        module = importlib.import_module("multimodal_embeddings_tpu_torch.cli.parse")
        return launch(module.run, ranks, args, device=args.device, timeout=None)[0]
    return run(args)


def run(args) -> int:
    """The parse of ``args`` on this process (this rank, under a mesh: rank
    0 alone writes the outputs and logs)."""
    from multimodal_embeddings_tpu_torch.analysis.doc_parser import (
        clean_and_format_html,
        draw_bbox,
        extract_bbox_elements,
    )

    quiet_other_ranks()
    writer = world()[0] == 0
    paths = get_image_paths(args.input_folder)
    if not paths:
        logger.error("no images in %s", args.input_folder)
        return 1
    if writer:
        os.makedirs(args.output_folder, exist_ok=True)
    parser_obj = make_document_parser(
        args.size, args.weights, args.image_size, args.dynamic_resolution, args.max_pixels,
        pipeline_parallel=args.pipeline_parallel, data_parallel=args.data_parallel,
        device=args.device,
    )
    if args.data_parallel > 1 and args.batch_size < args.data_parallel:
        args.batch_size = args.data_parallel  # one page per chip minimum
    n_done = 0
    index = []
    # continuous mode schedules the WHOLE queue in one call — refill
    # happens across what would otherwise be wave boundaries
    batch = len(paths) if args.continuous else max(1, args.batch_size)
    for start in range(0, len(paths), batch):
        chunk = paths[start : start + batch]
        parsed = _parse_chunk(parser_obj, chunk, batch, args)
        if not writer:
            continue
        for path, result in zip(chunk, parsed):
            stem = os.path.splitext(os.path.basename(path))[0]
            if result is None:
                continue
            html, in_h, in_w = result
            raw_path = os.path.join(args.output_folder, f"{stem}.qwen.html")
            with open(raw_path, "w") as f:
                f.write(html)
            with open(os.path.join(args.output_folder, f"{stem}.clean.html"), "w") as f:
                f.write(clean_and_format_html(html))
            n_boxes = len(extract_bbox_elements(html))
            if args.draw_bbox:
                draw_bbox(path, in_w, in_h, html,
                          os.path.join(args.output_folder, f"{stem}_bbox.jpg"))
            index.append({
                "image_path": path,
                "input_width": in_w,
                "input_height": in_h,
                "n_bbox_elements": n_boxes,
                "html": os.path.basename(raw_path),
            })
            n_done += 1
            logger.info("parsed %s: %d bbox elements", stem, n_boxes)
    if writer:
        with open(os.path.join(args.output_folder, "parse_index.json"), "w") as f:
            json.dump(index, f, indent=2)
    logger.info("parsed %d/%d pages", n_done, len(paths))
    return 0


def _parse_chunk(parser_obj, chunk, batch, args):
    """One chunk of pages; with ``--skip_errors`` a failing batch is retried
    page by page and a failing page yields None. Under ``--continuous`` the
    chunk is the whole queue, and a page that cannot be opened or decoded
    yields None inside the continuous decoder (no per-page retry)."""
    def one(path):
        return parser_obj.parse(path, max_new_tokens=args.max_new_tokens)

    if args.continuous:
        return parser_obj.parse_continuous(
            chunk, max_new_tokens=args.max_new_tokens, batch=max(1, args.batch_size),
            chunk=args.chunk, skip_errors=args.skip_errors)
    run = (lambda: parser_obj.parse_batch(chunk, max_new_tokens=args.max_new_tokens)
           ) if batch > 1 else (lambda: [one(chunk[0])])
    if not args.skip_errors:
        return run()
    return _guarded(run, lambda: [_guarded(lambda p=p: one(p), lambda: None) for p in chunk])


def _guarded(fn, fallback):
    """``fn()``, or ``fallback()`` when it raises (the CLI's --skip_errors
    contract; the kernels' wrappers themselves never fall back)."""
    import contextlib

    result = []
    with contextlib.suppress(Exception):
        result.append(fn())
    if result:
        return result[0]
    logger.error("parse failed; skipped")
    return fallback()


if __name__ == "__main__":
    raise SystemExit(main())
