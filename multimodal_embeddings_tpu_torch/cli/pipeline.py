"""Single-process numbered-pipeline CLI with content-hash caching.

Port of ``multimodal_embeddings_tpu/cli/pipeline.py``: the same flags and exit
codes, plus ``--device`` (``cuda`` by default; asking for it where there is
none raises).

The modern replacement for chaining six OS processes through ``run.sh``:
all stages run in one process (models stay loaded), and unchanged stages
are skipped by input/config fingerprint (``pipeline/runner.py``).
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.pipeline.runner import (
    PipelineRunner,
    numbered_pipeline_stages,
)

logger = get_logger("cli.pipeline")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Run the full numbered pipeline (stages 0-5) with caching"
    )
    parser.add_argument("input_folder", nargs="?", default="newspaper_images")
    parser.add_argument("--sensitivity", type=float, default=0.5)
    parser.add_argument("--edge_threshold", type=int, default=10)
    parser.add_argument("--iou_threshold", type=float, default=0.5)
    parser.add_argument("--min_margin_percent", type=float, default=0.2)
    parser.add_argument("--min_confidence", type=float, default=0.3)
    parser.add_argument("--imgsz", type=int, default=1024)
    parser.add_argument("--variant", default="m", choices=list("nsmblx"))
    parser.add_argument("--grid_configs", default="2x2,3x3,4x4")
    parser.add_argument("--force", action="store_true", help="ignore the cache")
    parser.add_argument("--allow_missing_images", action="store_true")
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default) or cpu; asking for cuda where there is none raises",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    stages = numbered_pipeline_stages(
        args.input_folder,
        sensitivity=args.sensitivity,
        edge_threshold=args.edge_threshold,
        iou_threshold=args.iou_threshold,
        min_margin_percent=args.min_margin_percent,
        min_confidence=args.min_confidence,
        imgsz=args.imgsz,
        variant=args.variant,
        grid_configs=args.grid_configs,
        require_images=not args.allow_missing_images,
        device=args.device,
    )
    results = PipelineRunner().run(stages, force=args.force)
    logger.info("pipeline results: %s", results)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
