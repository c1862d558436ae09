"""Stage-1 CLI: DocLayout-YOLO detection with multi-grid tiling.

Port of ``multimodal_embeddings_tpu/cli/detect.py``: the same flags and exit
codes, plus ``--device`` (``cuda`` by default; asking for it where there is
none raises).

Mirrors ``python 1_doclayout_bboxes.py --input_folder ... --output_folder ...
--grid_configs 2x2,3x3,4x4`` (``1_doclayout_bboxes.py:682-707``).
"""

from __future__ import annotations

import argparse
import re
from typing import Tuple

from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.pipeline.detect import run_detect_stage

logger = get_logger("cli.detect")

# one "RxC" entry: what ``int()`` takes on each side of the "x" (blanks,
# a sign, digits with single underscores), where JAX catches int's
# ValueError
_INT = r"\s*[+-]?\d+(?:_\d+)*\s*"
_GRID = re.compile(rf"({_INT})x({_INT})")


def parse_grid_configs(grid_str: str) -> Tuple[Tuple[int, int], ...]:
    """'2x2,3x3' → ((2,2),(3,3)); invalid entries are skipped with a warning
    (reference behavior, ``1_doclayout_bboxes.py:656-680``)."""
    configs = []
    for part in grid_str.split(","):
        part = part.strip()
        if not part:
            continue
        match = _GRID.fullmatch(part)
        if match is None:
            logger.warning("invalid grid config %r skipped", part)
            continue
        configs.append((int(match[1]), int(match[2])))
    return tuple(configs)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Document layout detection")
    parser.add_argument("--input_folder", required=True)
    parser.add_argument("--output_folder", required=True)
    parser.add_argument("--conf_threshold", type=float, default=0.1)
    parser.add_argument("--iou_threshold", type=float, default=0.45)
    parser.add_argument("--imgsz", type=int, default=1024)
    parser.add_argument("--grid_configs", default="2x2,3x3,4x4")
    parser.add_argument("--overlap", type=float, default=20.0)
    parser.add_argument("--weights", default=None, help="detector checkpoint path")
    parser.add_argument("--variant", default="m", choices=list("nsmblx"))
    parser.add_argument("--skip_errors", action="store_true")
    parser.add_argument("--no_cell_images", action="store_true")
    parser.add_argument("--no_viz", action="store_true")
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default) or cpu; asking for cuda where there is none raises",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    config = DetectorConfig(
        image_size=args.imgsz,
        conf_threshold=args.conf_threshold,
        iou_threshold=args.iou_threshold,
        grid_configs=parse_grid_configs(args.grid_configs),
        overlap_percentage=args.overlap,
        weights_path=args.weights,
        variant=args.variant,
    )
    stats = run_detect_stage(
        args.input_folder,
        args.output_folder,
        config=config,
        save_cell_images=not args.no_cell_images,
        save_visualizations=not args.no_viz,
        skip_errors=args.skip_errors,
        device=args.device,
    )
    logger.info(
        "stage 1 complete: %d pages, %d errors", stats.processed, stats.errors
    )
    return 0 if stats.errors == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
