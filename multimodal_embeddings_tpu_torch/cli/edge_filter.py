"""Stage-2 CLI: filter boxes touching internal grid edges.

Port of ``multimodal_embeddings_tpu/cli/edge_filter.py``: the same flags and exit
codes. The stage runs on the host, so it takes no ``--device``.

Mirrors ``python 2_edge_box_filter.py --input_folder ... --output_folder ...``
(``2_edge_box_filter.py:668-680``).
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.pipeline.stages import run_edge_filter_stage

logger = get_logger("cli.edge_filter")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Filter bounding boxes that touch internal grid edges"
    )
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--edge_threshold", type=int, default=10)
    parser.add_argument("--viz_alpha", type=float, default=0.3)
    parser.add_argument("--skip_errors", action="store_true")
    parser.add_argument(
        "--process_grids",
        action="store_true",
        help="accepted for reference-CLI compatibility; grid-info JSONs in the "
        "main json/ folder are always processed",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = run_edge_filter_stage(
        args.input_folder,
        args.output_folder,
        threshold=args.edge_threshold,
        viz_alpha=args.viz_alpha,
        skip_errors=args.skip_errors,
    )
    logger.info(
        "stage 2 complete: %d processed, %d errors", stats.processed, stats.errors
    )
    return 0 if stats.errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
