"""Stage-4 CLI: extract the median plain_text box width per page.

Port of ``multimodal_embeddings_tpu/cli/medians.py``: the same flags and exit
codes. The stage runs on the host, so it takes no ``--device``.

Mirrors ``python 4_extract_median_widths.py`` (``4_extract_median_widths.py:227-233``).
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.pipeline.stages import run_median_stage

logger = get_logger("cli.medians")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Extract median width of plain_text boxes")
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--min_margin_percent", type=float, default=0.2)
    parser.add_argument(
        "--allow_missing_images",
        action="store_true",
        help="emit median JSON even when the page scan is not on disk "
        "(the reference silently skips such pages)",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stats = run_median_stage(
        args.input_folder,
        args.output_folder,
        min_margin_percent=args.min_margin_percent,
        require_image=not args.allow_missing_images,
    )
    logger.info(
        "stage 4 complete: %d processed, %d skipped, %d errors",
        stats.processed,
        stats.skipped,
        stats.errors,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
