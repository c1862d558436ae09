"""Stage-5 CLI: detect text-column centers per page.

Port of ``multimodal_embeddings_tpu/cli/columns.py``: the same flags and exit
codes. The stage runs on the host, so it takes no ``--device``.

Mirrors ``python 5_detect_column_centers.py`` (``5_detect_column_centers.py:541-590``).
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.pipeline.stages import run_columns_stage

logger = get_logger("cli.columns")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Detect text-column centers")
    parser.add_argument("--input_folder", required=True, help="combined-bbox folder")
    parser.add_argument("--median_folder", required=True, help="median-width folder")
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--min_confidence", type=float, default=0.3)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = run_columns_stage(
        args.input_folder,
        args.median_folder,
        args.output_folder,
        min_confidence=args.min_confidence,
    )
    logger.info(
        "stage 5 complete: %d processed, %d skipped, %d errors",
        stats.processed,
        stats.skipped,
        stats.errors,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
