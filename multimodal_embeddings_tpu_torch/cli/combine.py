"""Stage-3 CLI: combine per-grid detections into one box set per page.

Port of ``multimodal_embeddings_tpu/cli/combine.py``: the same flags and exit
codes. The stage runs on the host, so it takes no ``--device``.

Mirrors ``python 3_combine_grids.py --input_folder ... --output_folder ...``
(``3_combine_grids.py:403-411``).
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.pipeline.stages import run_combine_stage

logger = get_logger("cli.combine")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Combine bounding boxes from different grid patterns"
    )
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--iou_threshold", type=float, default=0.5)
    parser.add_argument("--viz_alpha", type=float, default=0.3)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = run_combine_stage(
        args.input_folder,
        args.output_folder,
        iou_threshold=args.iou_threshold,
        viz_alpha=args.viz_alpha,
    )
    logger.info(
        "stage 3 complete: %d pages combined, %d skipped", stats.processed, stats.skipped
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
