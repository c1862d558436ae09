"""JSON schemas and byte-compatible writers: a copy of
``multimodal_embeddings_tpu/io/json_io.py`` (``tests/test_torch_serve.py``
holds the two sources equal).

All stage outputs are written with ``json.dump(obj, f, indent=2)`` over
native Python types, matching the reference writers exactly
(``1_doclayout_bboxes.py:469-470``, ``3_combine_grids.py:442-443``,
``4_extract_median_widths.py:283-285``, ``5_detect_column_centers.py:437-439``)
so that identical values produce identical bytes.

Canonical *regions dict* schema (``1_doclayout_bboxes.py:227-235``)::

    {image_path, image_size: {width, height}, parameters,
     boxes: [[x1,y1,x2,y2]...], classes: [float...], scores: [float...],
     class_names: [str...]}

Grid-info schema (``1_doclayout_bboxes.py:552-647``)::

    {original_image_path, grid_config: {rows, cols, overlap_percentage},
     cells: [{cell_path, cell_json_path, cell_coordinates, row, col,
              regions: {boxes, boxes_original, classes, scores, class_names}}]}
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class NumpyJSONEncoder(json.JSONEncoder):
    """Converts NumPy scalars/arrays to native types
    (mirrors ``5_detect_column_centers.py:32-42``)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.bool_):
            return bool(obj)
        return super().default(obj)


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(obj: Any, path: str) -> None:
    """Reference-compatible writer: ``indent=2``, default separators."""
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, cls=NumpyJSONEncoder)


def _pyfloat_boxes(boxes: Sequence[Sequence[float]]) -> List[List[float]]:
    return [[float(v) for v in box] for box in boxes]


def regions_dict(
    image_path: str,
    width: int,
    height: int,
    parameters: Dict[str, Any],
    boxes: Sequence[Sequence[float]],
    classes: Sequence[float],
    scores: Sequence[float],
    class_names: Sequence[str],
) -> Dict[str, Any]:
    """Build a canonical regions dict with reference field order."""
    return {
        "image_path": image_path,
        "image_size": {"width": int(width), "height": int(height)},
        "parameters": parameters,
        "boxes": _pyfloat_boxes(boxes),
        "classes": [float(c) for c in classes],
        "scores": [float(s) for s in scores],
        "class_names": list(class_names),
    }


def filtered_regions_dict(regions: Dict[str, Any], keep: Sequence[int]) -> Dict[str, Any]:
    """Index-select a regions dict preserving the reference's field order and
    optional pass-through fields (``2_edge_box_filter.py:122-146``)."""
    out = {
        "image_path": regions["image_path"],
        "image_size": regions["image_size"],
        "parameters": regions["parameters"],
        "boxes": [regions["boxes"][i] for i in keep],
        "classes": [regions["classes"][i] for i in keep],
        "scores": [regions["scores"][i] for i in keep],
        "class_names": [regions["class_names"][i] for i in keep],
    }
    if "boxes_original" in regions:
        out["boxes_original"] = [regions["boxes_original"][i] for i in keep]
    if "cell_coordinates" in regions:
        out["cell_coordinates"] = regions["cell_coordinates"]
    if "original_image_path" in regions:
        out["original_image_path"] = regions["original_image_path"]
    if "grid_info" in regions:
        out["grid_info"] = regions["grid_info"]
    return out


def combined_regions_dict(
    image_path: Optional[str],
    image_size: Optional[Dict[str, int]],
    iou_threshold: float,
    boxes: Sequence[Sequence[float]],
    classes: Sequence[float],
    scores: Sequence[float],
    class_names: Sequence[str],
    source_jsons: Sequence[str],
) -> Dict[str, Any]:
    """Stage-3 combined schema (``3_combine_grids.py:282-291``)."""
    return {
        "image_path": image_path,
        "image_size": image_size,
        "parameters": {"iou_threshold": iou_threshold},
        "boxes": list(boxes),
        "classes": list(classes),
        "scores": list(scores),
        "class_names": list(class_names),
        "source_jsons": list(source_jsons),
    }


def median_width_dict(
    image_path: str, median_width: float, page_width: int, page_height: int
) -> Dict[str, Any]:
    """Stage-4 schema (``4_extract_median_widths.py:273-281``)."""
    return {
        "image_path": image_path,
        "median_width": median_width,
        "page_width": page_width,
        "page_height": page_height,
        "width_ratio": median_width / page_width if page_width > 0 else 0,
    }


def columns_dict(
    image_path: str,
    page_width: int,
    page_height: int,
    median_width: float,
    column_centers: Sequence[float],
    column_widths: Sequence[float],
) -> Dict[str, Any]:
    """Stage-5 schema (``5_detect_column_centers.py:425-435``)."""
    return {
        "image_path": image_path,
        "page_width": page_width,
        "page_height": page_height,
        "median_width": median_width,
        "column_centers": [float(x) for x in column_centers],
        "column_widths": [float(x) for x in column_widths],
        "num_columns": len(column_centers),
    }
