"""Stage-0 CLI: orientation/deskew correction.

Port of ``multimodal_embeddings_tpu/cli/orientation.py``: the same flags and exit
codes, plus ``--device`` (``cuda`` by default; asking for it where there is
none raises).

Mirrors ``python 0_orientation.py <input_folder> <output_folder>``
(``0_orientation.py:326-388``) including ``--sensitivity``, ``--batch-size``,
``--no-advanced`` and ``--debug``.
"""

from __future__ import annotations

import argparse
import logging

from multimodal_embeddings_tpu_torch.io.images import get_image_paths
from multimodal_embeddings_tpu_torch.io.logging_setup import configure, get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.pipeline.orientation import batch_correct_orientation

logger = get_logger("cli.orientation")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Correct image orientation/skew")
    parser.add_argument("input_folder")
    parser.add_argument("output_folder")
    parser.add_argument("--sensitivity", type=float, default=0.5)
    parser.add_argument(
        "--batch-size",
        type=int,
        default=8,
        help="accepted for reference-CLI compatibility (processing is "
        "per-image; the page program batches its views internally)",
    )
    parser.add_argument("--no-advanced", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default) or cpu; asking for cuda where there is none raises",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    if args.debug:
        configure(level=logging.DEBUG)
    paths = get_image_paths(args.input_folder)
    if not paths:
        logger.error("no images found in %s", args.input_folder)
        return 1
    logger.info("correcting orientation for %d images", len(paths))
    results = batch_correct_orientation(
        paths,
        args.output_folder,
        sensitivity_threshold=args.sensitivity,
        advanced_detection=not args.no_advanced,
        device=args.device,
    )
    rotated = sum(1 for r in results if r.rotated)
    logger.info("stage 0 complete: %d images, %d rotated", len(results), rotated)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
