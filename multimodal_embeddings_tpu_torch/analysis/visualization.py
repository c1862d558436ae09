"""Host-side visualization artifacts: ``draw_regions``,
``visualize_regions``, ``visualize_median_width``, ``visualize_columns`` and
``region_comparison_composite`` of
``multimodal_embeddings_tpu/analysis/visualization.py``, the same drawing
calls (``tests/test_torch_stages.py`` and ``tests/test_torch_analysis.py``
hold the files they write equal). cv2 is found by
``io/images.py::cv2_module`` and imported only where a function draws;
without it each function logs JAX's warning and returns False.

Produces the same artifact types as the reference (bbox overlays with
class-colored fills and labels, median-width line, column-center overlay,
region comparison composites — ``visualization.py:51-259``,
``1_doclayout_bboxes.py:273-343``, ``4_extract_median_widths.py:153-225``,
``5_detect_column_centers.py:226-335``). Drawing is not perf-critical and
stays on the host with cv2.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from multimodal_embeddings_tpu_torch.config import ID_TO_NAMES
from multimodal_embeddings_tpu_torch.io.images import cv2_module, load_image_bgr, save_image_bgr
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.utils.colormap import colormap

logger = get_logger("viz")


def _require_cv2() -> bool:
    if cv2_module() is None:
        logger.warning("cv2 unavailable; skipping visualization")
        return False
    return True


def draw_regions(
    image: np.ndarray,
    boxes: Sequence[Sequence[float]],
    classes: Sequence[float],
    scores: Sequence[float],
    class_names: Sequence[str],
    alpha: float = 0.3,
) -> np.ndarray:
    """Class-colored filled overlay + outline + score label per box."""
    cv2 = cv2_module()
    cmap = colormap(n=len(ID_TO_NAMES))
    overlay = image.copy()
    outlined = image.copy()
    for box, cls, score, name in zip(boxes, classes, scores, class_names):
        x0, y0, x1, y1 = (int(v) for v in box)
        color = tuple(int(c) for c in cmap[int(cls) % len(cmap)])
        cv2.rectangle(overlay, (x0, y0), (x1, y1), color, -1)
        cv2.rectangle(outlined, (x0, y0), (x1, y1), color, 2)
        text = f"{name}: {score:.3f}"
        (tw, th), baseline = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.7, 2)
        cv2.rectangle(outlined, (x0, y0 - th - baseline), (x0 + tw, y0), color, -1)
        cv2.putText(
            outlined, text, (x0, y0 - 5), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2
        )
    return cv2.addWeighted(overlay, alpha, outlined, 1 - alpha, 0)


def visualize_regions(
    image_path: str,
    regions: Dict,
    output_path: str,
    alpha: float = 0.3,
    use_original_coords: bool = False,
) -> bool:
    """Regions-dict overlay (``1_doclayout_bboxes.py:273-343``)."""
    if not _require_cv2():
        return False
    if not regions.get("boxes"):
        logger.warning("no regions to visualize for %s", os.path.basename(image_path))
        return False
    image = load_image_bgr(image_path)
    if image is None:
        logger.error("failed to load image for visualization: %s", image_path)
        return False
    boxes = regions["boxes_original"] if (use_original_coords and "boxes_original" in regions) else regions["boxes"]
    out = draw_regions(
        image, boxes, regions["classes"], regions["scores"], regions["class_names"], alpha
    )
    save_image_bgr(output_path, out)
    return True


def visualize_median_width(
    image_path: str, median_width: float, output_path: str
) -> bool:
    """Red centered line at 3/4 page height + label
    (``4_extract_median_widths.py:153-225``)."""
    if not _require_cv2():
        return False
    cv2 = cv2_module()
    image = load_image_bgr(image_path)
    if image is None:
        return False
    height, width = image.shape[:2]
    line_y = int(height * 0.75)
    x0 = int((width - median_width) / 2)
    x1 = int(x0 + median_width)
    thickness = max(3, int(height / 200))
    cv2.line(image, (x0, line_y), (x1, line_y), (0, 0, 255), thickness)

    label = f"Median width: {median_width:.1f} px"
    font_scale = max(0.7, height / 2000)
    label_thickness = max(1, int(height / 500))
    (tw, th), baseline = cv2.getTextSize(
        label, cv2.FONT_HERSHEY_SIMPLEX, font_scale, label_thickness
    )
    tx, ty = int((width - tw) / 2), line_y - 20
    cv2.rectangle(image, (tx - 10, ty - th - 10), (tx + tw + 10, ty + 10), (255, 255, 255), -1)
    cv2.putText(
        image, label, (tx, ty), cv2.FONT_HERSHEY_SIMPLEX, font_scale, (0, 0, 255), label_thickness
    )
    save_image_bgr(output_path, image)
    return True


def visualize_columns(
    image_path: str,
    column_centers: Sequence[float],
    column_widths: Sequence[float],
    median_width: float,
    output_path: str,
    debug: bool = False,
) -> bool:
    """Vertical center lines + translucent column spans
    (``5_detect_column_centers.py:226-335``)."""
    if not _require_cv2():
        return False
    cv2 = cv2_module()
    image = load_image_bgr(image_path)
    if image is None:
        return False
    height, width = image.shape[:2]
    overlay = image.copy()
    thickness = max(3, int(height / 300))
    for center, col_width in zip(column_centers, column_widths):
        cx = int(center)
        half = int(col_width / 2)
        cv2.rectangle(
            overlay, (max(0, cx - half), 0), (min(width, cx + half), height), (0, 200, 0), -1
        )
        cv2.line(image, (cx, 0), (cx, height), (0, 0, 255), thickness)
    alpha = 0.12 if debug else 0.25
    image = cv2.addWeighted(overlay, alpha, image, 1 - alpha, 0)
    label = f"{len(column_centers)} columns, median width {median_width:.0f}px"
    cv2.putText(
        image,
        label,
        (20, max(40, int(height * 0.03))),
        cv2.FONT_HERSHEY_SIMPLEX,
        max(0.7, height / 2000),
        (0, 0, 255),
        max(2, int(height / 500)),
    )
    save_image_bgr(output_path, image)
    return True


def region_comparison_composite(
    source_image_path: str,
    target_image_path: str,
    source_box: Sequence[float],
    target_box: Sequence[float],
    score: float,
    output_path: str,
    banner: Optional[str] = None,
) -> bool:
    """Side-by-side page composite with region outlines and a score banner
    (``visualization.py:154-259``)."""
    if not _require_cv2():
        return False
    cv2 = cv2_module()
    a = load_image_bgr(source_image_path)
    b = load_image_bgr(target_image_path)
    if a is None or b is None:
        return False

    target_h = 1200
    def _scale(img):
        s = target_h / img.shape[0]
        return cv2.resize(img, (int(img.shape[1] * s), target_h)), s

    a, sa = _scale(a)
    b, sb = _scale(b)

    for img, box, s in ((a, source_box, sa), (b, target_box, sb)):
        x0, y0, x1, y1 = (int(v * s) for v in box)
        cv2.rectangle(img, (x0, y0), (x1, y1), (0, 0, 255), 3)

    gap = 16
    banner_h = 60
    canvas = np.full(
        (target_h + banner_h, a.shape[1] + b.shape[1] + gap, 3), 255, np.uint8
    )
    canvas[banner_h:, : a.shape[1]] = a
    canvas[banner_h:, a.shape[1] + gap :] = b
    text = banner or f"similarity: {score:.4f}"
    cv2.putText(
        canvas, text, (12, 42), cv2.FONT_HERSHEY_SIMPLEX, 1.2, (0, 0, 0), 2
    )
    save_image_bgr(output_path, canvas)
    return True
