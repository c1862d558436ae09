"""Pipeline stages 2-5: JSON-to-JSON geometry passes.

Port of ``multimodal_embeddings_tpu/pipeline/stages.py``: every function is
a copy of the JAX function of the same name (``tests/test_torch_stages.py``
holds the sources equal and the output trees byte-identical), but where the
JAX stage catches an exception per file. The package keeps no ``try``: that
file's host work (JSON reads and writes, host float64 math, drawing) runs
in a ``Held`` block (``utils/errors.py``) and the stage logs the same line,
counts the same ``StageStats`` and writes the same tree. Stages 2-5 run on
the host only.

Each stage is a pure-ish function over input/output folders that emits the
reference's exact JSON artifacts (schemas in ``io/json_io.py``). The batch
pipeline composes them in one process instead of the reference's six
OS processes chained by ``run.sh:60-70``; per-stage CLIs in ``cli/`` keep
the original invocation surface.

Host float64 math is used for JSON emission (bit-compatible); the padded
device ops in ``ops/`` are the page program's batch path.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_embeddings_tpu_torch.analysis import visualization as viz
from multimodal_embeddings_tpu_torch.io.images import image_size
from multimodal_embeddings_tpu_torch.io.json_io import (
    columns_dict,
    combined_regions_dict,
    filtered_regions_dict,
    load_json,
    median_width_dict,
    save_json,
)
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.ops.columns import find_column_centers
from multimodal_embeddings_tpu_torch.ops.edge_filter import internal_edge_mask_np
from multimodal_embeddings_tpu_torch.ops.nms import greedy_nms_host
from multimodal_embeddings_tpu_torch.ops.widths import (
    bin_widths,
    median_from_bins,
    plain_text_widths,
)
from multimodal_embeddings_tpu_torch.utils.errors import Held

logger = get_logger("stages")


@dataclasses.dataclass
class StageStats:
    processed: int = 0
    errors: int = 0
    skipped: int = 0


def _json_files(folder: str) -> List[str]:
    paths = []
    for root, _, files in os.walk(folder):
        for file in files:
            if file.endswith(".json"):
                paths.append(os.path.join(root, file))
    return sorted(paths)


def _cell_bounds(cell_coordinates, width: float = 0.0, height: float = 0.0) -> tuple:
    """Missing x_end/y_end default to the PAGE dims (the reference's
    ``.get('x_end', image_width)`` at 2_edge_box_filter.py:65-66 — a 0
    default would mark every edge internal and drop all boxes)."""
    if isinstance(cell_coordinates, dict):
        return (
            cell_coordinates.get("x_start", 0),
            cell_coordinates.get("y_start", 0),
            cell_coordinates.get("x_end", width),
            cell_coordinates.get("y_end", height),
        )
    return tuple(cell_coordinates)


def _page_size_for_grid(grid_info: Dict) -> Optional[tuple]:
    """(width, height) of the page a grid-info JSON refers to.

    Prefers the image header; falls back to the exact cell extents (the last
    row/column cells are clamped to the page, so ``max(x_end), max(y_end)``
    equal the page dimensions — lets the stage run when original page scans
    are absent).
    """
    path = grid_info.get("image_path") or grid_info.get("original_image_path")
    if path and os.path.exists(path):
        return image_size(path)
    cells = grid_info.get("cells", [])
    if not cells:
        return None
    xs, ys = [], []
    for cell in cells:
        x0, y0, x1, y1 = _cell_bounds(cell["cell_coordinates"], 0.0, 0.0)
        xs.append(x1)
        ys.append(y1)
    return max(xs), max(ys)


# ---------------------------------------------------------------------------
# Stage 2 — edge-box filter
# ---------------------------------------------------------------------------


def edge_filter_regions(regions: Dict, threshold: float = 10.0) -> Dict:
    """Filter one regions dict (no-op for non-grid images,
    ``2_edge_box_filter.py:92-146``)."""
    if "cell_coordinates" not in regions:
        return regions
    width = regions["image_size"]["width"]
    height = regions["image_size"]["height"]
    bounds = _cell_bounds(regions["cell_coordinates"], width, height)
    boxes = np.asarray(regions["boxes"], dtype=np.float64).reshape(-1, 4)
    remove = internal_edge_mask_np(boxes, bounds, width, height, threshold)
    keep = [i for i in range(len(regions["boxes"])) if not remove[i]]
    return filtered_regions_dict(regions, keep)


def edge_filter_grid_info(grid_info: Dict, threshold: float = 10.0) -> Optional[Dict]:
    """Filter every cell of a grid-info JSON on ``boxes_original``
    (``2_edge_box_filter.py:148-237``). Preserves the reference's output key
    order quirk (original_image_path, cells, grid_config)."""
    size = _page_size_for_grid(grid_info)
    if size is None:
        logger.warning("cannot determine page size for grid info")
        return None
    width, height = size

    out: Dict = {"original_image_path": grid_info["original_image_path"], "cells": []}
    if "grid_config" in grid_info:
        out["grid_config"] = grid_info["grid_config"]

    for cell in grid_info["cells"]:
        bounds = _cell_bounds(cell["cell_coordinates"], width, height)
        boxes = np.asarray(
            cell["regions"]["boxes_original"], dtype=np.float64
        ).reshape(-1, 4)
        remove = internal_edge_mask_np(boxes, bounds, width, height, threshold)
        keep = [i for i in range(boxes.shape[0]) if not remove[i]]
        regions = cell["regions"]
        out["cells"].append(
            {
                "cell_path": cell["cell_path"],
                "cell_json_path": cell["cell_json_path"],
                "cell_coordinates": cell["cell_coordinates"],
                "row": cell.get("row", 0),
                "col": cell.get("col", 0),
                "regions": {
                    "boxes": [regions["boxes"][i] for i in keep],
                    "boxes_original": [regions["boxes_original"][i] for i in keep],
                    "classes": [regions["classes"][i] for i in keep],
                    "scores": [regions["scores"][i] for i in keep],
                    "class_names": [regions["class_names"][i] for i in keep],
                },
            }
        )
    return out


def run_edge_filter_stage(
    input_folder: str,
    output_folder: str,
    threshold: int = 10,
    viz_alpha: float = 0.3,
    skip_errors: bool = True,
) -> StageStats:
    """Stage-2 batch driver over ``input_folder/json`` (falls back to the
    folder itself)."""
    stats = StageStats()
    json_folder = os.path.join(input_folder, "json")
    if not os.path.isdir(json_folder):
        json_folder = input_folder
    out_json = os.path.join(output_folder, "json")
    out_viz = os.path.join(output_folder, "visualizations")
    os.makedirs(out_json, exist_ok=True)
    os.makedirs(out_viz, exist_ok=True)

    for json_path in _json_files(json_folder):
        with Held() as held:
            done = _edge_filter_file(json_path, out_json, out_viz, threshold, viz_alpha)
        if held.error is not None:  # continue-on-error contract
            stats.errors += 1
            logger.error("stage2 failed on %s: %s", os.path.basename(json_path), held.error)
            if not skip_errors:
                raise held.error
        elif done:
            stats.processed += 1
        else:
            stats.errors += 1
    return stats


def _edge_filter_file(
    json_path: str, out_json: str, out_viz: str, threshold: int, viz_alpha: float
) -> bool:
    """Stage 2 on one JSON (the body of the JAX stage's ``try``); False
    where the page size of a grid-info JSON cannot be found."""
    data = load_json(json_path)
    basename = os.path.splitext(os.path.basename(json_path))[0]
    if "cells" in data and ("grid_config" in data or "grid_info" in data):
        filtered = edge_filter_grid_info(data, threshold)
        if filtered is None:
            return False
        save_json(filtered, os.path.join(out_json, os.path.basename(json_path)))
        image_path = filtered["original_image_path"]
        if os.path.exists(image_path):
            boxes, classes, scores, names = [], [], [], []
            for cell in filtered["cells"]:
                regions = cell["regions"]
                boxes.extend(regions["boxes_original"])
                classes.extend(regions["classes"])
                scores.extend(regions["scores"])
                names.extend(regions["class_names"])
            viz.visualize_regions(
                image_path,
                {
                    "boxes": boxes,
                    "classes": classes,
                    "scores": scores,
                    "class_names": names,
                },
                os.path.join(out_viz, f"{basename}_filtered_viz.jpg"),
                alpha=viz_alpha,
            )
    else:
        filtered = edge_filter_regions(data, threshold)
        save_json(filtered, os.path.join(out_json, os.path.basename(json_path)))
        image_path = filtered.get("original_image_path") or filtered.get(
            "image_path"
        )
        if image_path and os.path.exists(image_path):
            viz.visualize_regions(
                image_path,
                filtered,
                os.path.join(out_viz, f"{basename}_filtered_viz.jpg"),
                alpha=viz_alpha,
                use_original_coords="boxes_original" in filtered,
            )
    return True


# ---------------------------------------------------------------------------
# Stage 3 — cross-grid combine
# ---------------------------------------------------------------------------


def group_jsons_by_image(input_folder: str) -> Dict[str, List[str]]:
    """Group stage-2 JSONs by page base name; base (non-grid) JSON first
    (``3_combine_grids.py:140-198``)."""
    groups: Dict[str, List[str]] = {}
    json_folder = os.path.join(input_folder, "json")
    if not os.path.isdir(json_folder):
        json_folder = input_folder

    for grid_json in sorted(glob.glob(os.path.join(json_folder, "*_grid_*.json"))):
        base = os.path.basename(grid_json).split("_grid_")[0]
        groups.setdefault(base, []).append(grid_json)
    for json_file in sorted(glob.glob(os.path.join(json_folder, "*.json"))):
        name = os.path.basename(json_file)
        if "_grid_" not in name and "_combined" not in name:
            base = os.path.splitext(name)[0]
            groups.setdefault(base, []).insert(0, json_file)
    return groups


def combine_image_jsons(
    json_paths: Sequence[str], iou_threshold: float = 0.5
) -> Optional[Dict]:
    """Concatenate all views' boxes then greedy class-aware NMS
    (``3_combine_grids.py:200-293``). Exact host math."""
    all_boxes: List = []
    all_scores: List = []
    all_classes: List = []
    all_names: List = []
    image_path = None
    image_size_dict = None

    for json_path in json_paths:
        with Held() as held:
            data = load_json(json_path)
        if held.error is not None:
            logger.error("error reading %s: %s", json_path, held.error)
            continue
        if "cells" in data:
            if not image_path and "original_image_path" in data:
                image_path = data["original_image_path"]
            for cell in data["cells"]:
                regions = cell.get("regions", {})
                if "boxes_original" in regions:
                    all_boxes.extend(regions["boxes_original"])
                    all_scores.extend(regions["scores"])
                    all_classes.extend(regions["classes"])
                    all_names.extend(regions["class_names"])
        elif "boxes" in data:
            if not image_path and "image_path" in data:
                image_path = data["image_path"]
            if not image_size_dict and "image_size" in data:
                image_size_dict = data["image_size"]
            boxes = data["boxes_original"] if "boxes_original" in data else data["boxes"]
            all_boxes.extend(boxes)
            all_scores.extend(data["scores"])
            all_classes.extend(data["classes"])
            all_names.extend(data["class_names"])

    if not all_boxes:
        return None

    keep = greedy_nms_host(
        np.asarray(all_boxes, dtype=np.float64),
        np.asarray(all_scores, dtype=np.float64),
        np.asarray(all_classes, dtype=np.float64),
        iou_threshold,
    )
    return combined_regions_dict(
        image_path=image_path,
        image_size=image_size_dict,
        iou_threshold=iou_threshold,
        boxes=[all_boxes[i] for i in keep],
        classes=[all_classes[i] for i in keep],
        scores=[all_scores[i] for i in keep],
        class_names=[all_names[i] for i in keep],
        source_jsons=list(json_paths),
    )


def run_combine_stage(
    input_folder: str,
    output_folder: str,
    iou_threshold: float = 0.5,
    viz_alpha: float = 0.3,
) -> StageStats:
    stats = StageStats()
    out_json = os.path.join(output_folder, "json")
    out_viz = os.path.join(output_folder, "visualizations")
    os.makedirs(out_json, exist_ok=True)
    os.makedirs(out_viz, exist_ok=True)

    groups = group_jsons_by_image(input_folder)
    if not groups:
        logger.error("no JSON files found in %s", input_folder)
        return stats

    for base, json_paths in groups.items():
        combined = combine_image_jsons(json_paths, iou_threshold)
        if combined is None:
            stats.skipped += 1
            continue
        save_json(combined, os.path.join(out_json, f"{base}_combined.json"))
        image_path = combined["image_path"]
        if image_path and os.path.exists(image_path):
            viz.visualize_regions(
                image_path,
                combined,
                os.path.join(out_viz, f"{base}_combined_viz.jpg"),
                alpha=viz_alpha,
            )
        stats.processed += 1
    return stats


# ---------------------------------------------------------------------------
# Stage 4 — median text width
# ---------------------------------------------------------------------------


def median_width_for_json(json_path: str, min_margin_percent: float = 0.2):
    """(image_path, median_width, page_width, page_height) for one combined
    JSON (``4_extract_median_widths.py:103-147``)."""
    data = load_json(json_path)
    image_path = data.get("image_path", "")
    size = data.get("image_size") or {}
    page_width = size.get("width", 0)
    page_height = size.get("height", 0)
    widths = plain_text_widths(data.get("boxes", []), data.get("class_names", []))
    median = median_from_bins(bin_widths(widths, min_margin_percent, page_width))
    return image_path, median, page_width, page_height


def run_median_stage(
    input_folder: str,
    output_folder: str,
    min_margin_percent: float = 0.2,
    require_image: bool = True,
) -> StageStats:
    """Stage-4 batch driver. ``require_image=False`` emits JSON even when the
    page scan is absent (the reference silently skips such pages,
    ``4_extract_median_widths.py:270``)."""
    stats = StageStats()
    json_folder = input_folder
    if not os.path.isdir(json_folder) or not glob.glob(
        os.path.join(json_folder, "*.json")
    ):
        json_folder = os.path.join(input_folder, "json")
    out_json = os.path.join(output_folder, "json")
    out_viz = os.path.join(output_folder, "visualizations")
    os.makedirs(out_json, exist_ok=True)
    os.makedirs(out_viz, exist_ok=True)

    for json_path in sorted(glob.glob(os.path.join(json_folder, "*.json"))):
        base = os.path.splitext(os.path.basename(json_path))[0]
        with Held() as held:
            image_path, median, page_w, page_h = median_width_for_json(
                json_path, min_margin_percent
            )
        if held.error is not None:
            logger.error("stage4 failed on %s: %s", base, held.error)
            stats.errors += 1
            continue
        image_exists = bool(image_path) and os.path.exists(image_path)
        if not image_exists and require_image:
            stats.skipped += 1
            continue
        result = median_width_dict(image_path, median, page_w, page_h)
        save_json(result, os.path.join(out_json, f"{base}_median_width.json"))
        if image_exists:
            viz.visualize_median_width(
                image_path, median, os.path.join(out_viz, f"{base}_median_width.jpg")
            )
        stats.processed += 1
    return stats


# ---------------------------------------------------------------------------
# Stage 5 — column centers
# ---------------------------------------------------------------------------


def find_matching_median_json(layout_json_path: str, median_folder: str) -> Optional[str]:
    """Fuzzy layout→median filename match (``5_detect_column_centers.py:480-539``):
    exact suffix swap first, then progressively looser stem matches."""
    base = os.path.splitext(os.path.basename(layout_json_path))[0]
    median_json = os.path.join(median_folder, f"{base}_median_width.json")
    if os.path.exists(median_json):
        return median_json
    if base.endswith("_combined"):
        stem = base[: -len("_combined")]
        candidate = os.path.join(median_folder, f"{stem}_combined_median_width.json")
        if os.path.exists(candidate):
            return candidate
        candidate = os.path.join(median_folder, f"{stem}_median_width.json")
        if os.path.exists(candidate):
            return candidate
    matches = sorted(glob.glob(os.path.join(median_folder, f"{base[:40]}*_median_width.json")))
    if matches:
        return matches[0]
    stem = base.split(".")[0]
    matches = sorted(glob.glob(os.path.join(median_folder, f"{stem}*_median_width.json")))
    return matches[0] if matches else None


def columns_for_page(
    layout_json_path: str,
    median_json_path: str,
    min_confidence: float = 0.3,
) -> Optional[Dict]:
    """Column analysis for one page (``5_detect_column_centers.py:336-448``)."""
    layout = load_json(layout_json_path)
    median_data = load_json(median_json_path)
    median_width = median_data.get("median_width", 0)
    if median_width <= 0:
        return None

    image_path = layout.get("image_path", "")
    size = layout.get("image_size") or {}
    if isinstance(size, dict):
        page_w, page_h = size.get("width", 0), size.get("height", 0)
    elif isinstance(size, (list, tuple)) and len(size) >= 2:
        page_w, page_h = size[0], size[1]
    else:
        page_w = page_h = 0
    if page_w <= 0 or page_h <= 0:
        page_w = median_data.get("page_width", 0)
        page_h = median_data.get("page_height", 0)
    if page_w <= 0 or page_h <= 0:
        return None

    boxes = layout.get("boxes", [])
    names = layout.get("class_names", [])
    scores = layout.get("scores", [1.0] * len(boxes))
    centers, widths = find_column_centers(
        boxes, names, scores, page_w, page_h, median_width, min_confidence
    )
    if not centers:
        return None
    return columns_dict(image_path, page_w, page_h, median_width, centers, widths)


def run_columns_stage(
    input_folder: str,
    median_folder: str,
    output_folder: str,
    min_confidence: float = 0.3,
) -> StageStats:
    stats = StageStats()
    json_folder = os.path.join(input_folder, "json")
    if not os.path.isdir(json_folder):
        json_folder = input_folder
    median_json_folder = os.path.join(median_folder, "json")
    if not os.path.isdir(median_json_folder):
        median_json_folder = median_folder

    out_json = os.path.join(output_folder, "json")
    out_viz = os.path.join(output_folder, "visualizations")
    out_debug = os.path.join(output_folder, "visualizations_debug")
    os.makedirs(out_json, exist_ok=True)
    os.makedirs(out_viz, exist_ok=True)
    os.makedirs(out_debug, exist_ok=True)

    for layout_path in sorted(glob.glob(os.path.join(json_folder, "*.json"))):
        base = os.path.splitext(os.path.basename(layout_path))[0]
        median_path = find_matching_median_json(layout_path, median_json_folder)
        if median_path is None:
            stats.skipped += 1
            continue
        with Held() as held:
            result = columns_for_page(layout_path, median_path, min_confidence)
        if held.error is not None:
            logger.error("stage5 failed on %s: %s", base, held.error)
            stats.errors += 1
            continue
        if result is None:
            stats.skipped += 1
            continue
        save_json(result, os.path.join(out_json, f"{base}_columns.json"))
        image_path = result["image_path"]
        if image_path and os.path.exists(image_path):
            viz.visualize_columns(
                image_path,
                result["column_centers"],
                result["column_widths"],
                result["median_width"],
                os.path.join(out_viz, f"{base}_columns.jpg"),
            )
            viz.visualize_columns(
                image_path,
                result["column_centers"],
                result["column_widths"],
                result["median_width"],
                os.path.join(out_debug, f"{base}_columns_debug.jpg"),
                debug=True,
            )
        stats.processed += 1
    return stats
