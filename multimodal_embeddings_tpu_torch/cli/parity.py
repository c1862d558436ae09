"""Parity-measurement CLI: bbox IoU / embedding cosine vs a reference tree,
and golden-activation dumps and their comparison.

Port of ``multimodal_embeddings_tpu/cli/parity.py`` with the same four
modes, flags, headline JSON and exit codes (``acts-compare`` exits 1 on a
divergence), plus ``--device`` (``cuda`` by default) for the modes that
build a model or open a store. Models compute in bf16 on the card and in
f32 on the CPU.

    python -m multimodal_embeddings_tpu_torch.cli.parity acts-dump \\
        --family detector --variant n --imgsz 64 --out ours.json --device cpu
    python -m multimodal_embeddings_tpu_torch.cli.parity acts-compare \\
        theirs.json ours.json
    python -m multimodal_embeddings_tpu_torch.cli.parity boxes ref_dir cand_dir
    python -m multimodal_embeddings_tpu_torch.cli.parity embeddings ref_db cand_db \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json

import torch

from multimodal_embeddings_tpu_torch.analysis.parity import (
    compare_detection_dirs,
    compare_embedding_stores,
)
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = get_logger("cli.parity")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Measure parity vs a reference")
    sub = parser.add_subparsers(dest="mode", required=True)

    boxes = sub.add_parser("boxes", help="bbox IoU parity between JSON dirs")
    boxes.add_argument("reference_dir")
    boxes.add_argument("candidate_dir")
    boxes.add_argument("--iou_floor", type=float, default=0.5)
    boxes.add_argument("--class_agnostic", action="store_true")
    boxes.add_argument("--out", default=None, help="write full JSON report here")

    emb = sub.add_parser("embeddings", help="cosine parity between stores")
    emb.add_argument("reference_db")
    emb.add_argument("candidate_db")
    emb.add_argument("--out", default=None)
    emb.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    dump = sub.add_parser(
        "acts-dump",
        help="golden-activation dump: deterministic probe -> per-layer "
        "statistics JSON (first-contact checkpoint validation; the torch "
        "side of the comparison is scripts/hf_activation_dump.py)",
    )
    dump.add_argument(
        "--family", choices=("detector", "mme5", "qwen"), required=True
    )
    dump.add_argument("--out", required=True)
    dump.add_argument("--checkpoint", default=None, help="ported weights (npz/safetensors)")
    dump.add_argument("--seed", type=int, default=0)
    dump.add_argument(
        "--size",
        choices=("tiny", "2b", "11b", "3b", "7b", "32b"),
        default="tiny",
        help="architecture size: mme5 takes tiny/2b/11b, qwen takes "
        "tiny/3b/7b/32b (checkpoint runs want the real size; the tiny "
        "default keeps checkpoint-less self-tests cheap)",
    )
    dump.add_argument("--variant", default="m", help="detector YOLO variant")
    dump.add_argument("--imgsz", type=int, default=1024)
    dump.add_argument(
        "--taps", default=None, help="regex restricting dumped module paths"
    )
    dump.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    comp = sub.add_parser(
        "acts-compare", help="layer-by-layer comparison of two dumps"
    )
    comp.add_argument("reference_json")
    comp.add_argument("candidate_json")
    comp.add_argument("--rtol", type=float, default=1e-2)
    comp.add_argument("--atol", type=float, default=1e-4)
    comp.add_argument(
        "--map",
        dest="name_map",
        default=None,
        help="JSON file mapping reference layer names to candidate names "
        "(for torch-side dumps whose module paths differ)",
    )
    comp.add_argument("--out", default=None)
    return parser


def _acts_dump(args) -> dict:
    from multimodal_embeddings_tpu_torch.analysis import activations as acts

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.family == "detector":
        from multimodal_embeddings_tpu_torch.config import DetectorConfig
        from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector

        detector = LayoutDetector(
            DetectorConfig(
                variant=args.variant,
                image_size=args.imgsz,
                weights_path=args.checkpoint,
            ),
            dtype=dtype,
            device=device,
        )
        trace = acts.detector_trace(detector, seed=args.seed, taps=args.taps)
    elif args.family == "qwen":
        from multimodal_embeddings_tpu_torch.models.qwen_vl import QwenVLConfig
        from multimodal_embeddings_tpu_torch.models.weights import build_qwen

        config = {
            "tiny": QwenVLConfig.tiny,
            "3b": QwenVLConfig.qwen25_vl_3b,
            "7b": QwenVLConfig.qwen25_vl_7b,
            "32b": QwenVLConfig.qwen25_vl_32b,
        }[args.size]()
        unit = config.vision.patch_size * config.vision.merge_size
        model = build_qwen(config, dtype, device, seed=0, weights_path=args.checkpoint)
        trace = acts.qwen_trace(
            model, image_size=unit * 2, seed=args.seed, taps=args.taps,
        )
    else:
        from multimodal_embeddings_tpu_torch.config import EmbedderConfig
        from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
        from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig

        model_config = {
            "tiny": MllamaConfig.tiny,
            "2b": MllamaConfig.mme5_2b,
            "11b": MllamaConfig.mme5_11b,
        }[args.size]()
        embedder = MultimodalEmbedder(
            EmbedderConfig(
                family="mme5",
                dtype="bfloat16" if dtype == torch.bfloat16 else "float32",
                weights_path=args.checkpoint,
            ),
            model_config=model_config,
            device=device,
        )
        trace = acts.mme5_trace(embedder, seed=args.seed, taps=args.taps)
    acts.save_trace(trace, args.out)
    return {
        "layers": len(trace["layers"]),
        "out": args.out,
        "output_shape": (trace.get("output") or {}).get("shape"),
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "acts-dump":
        print(json.dumps(_acts_dump(args)))
        return 0
    if args.mode == "acts-compare":
        from multimodal_embeddings_tpu_torch.analysis import activations as acts

        name_map = None
        if args.name_map:
            with open(args.name_map) as f:
                name_map = json.load(f)
        summary = acts.compare_traces(
            acts.load_trace(args.reference_json),
            acts.load_trace(args.candidate_json),
            rtol=args.rtol,
            atol=args.atol,
            name_map=name_map,
        )
        headline = {
            "ok": summary["ok"],
            "layers_compared": summary["layers_compared"],
            "layers_ok": summary["layers_ok"],
            "first_divergent": summary["first_divergent"],
            "output_ok": summary.get("output_ok"),
        }
        print(json.dumps(headline))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=2)
                f.write("\n")
            logger.info("full report: %s", args.out)
        return 0 if summary["ok"] else 1
    if args.mode == "boxes":
        summary = compare_detection_dirs(
            args.reference_dir,
            args.candidate_dir,
            iou_floor=args.iou_floor,
            class_aware=not args.class_agnostic,
        )
        headline = {
            "pages": summary["pages"],
            "mean_matched_iou": round(summary["mean_matched_iou"], 6),
            "recall": round(summary["recall"], 6),
            "precision": round(summary["precision"], 6),
        }
    else:
        from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

        resolve_device(args.device)
        _, ref = initialize_db(args.reference_db, device=args.device)
        _, cand = initialize_db(args.candidate_db, device=args.device)
        summary = compare_embedding_stores(ref, cand)
        headline = {
            "count": summary["count"],
            "mean_cosine": round(summary["mean_cosine"], 6),
            "min_cosine": round(summary["min_cosine"], 6),
        }
    print(json.dumps(headline))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        logger.info("full report: %s", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
