"""LayoutDetector: the detection engine, in PyTorch.

Port of ``multimodal_embeddings_tpu/models/detector.py::LayoutDetector``:
the DocLayout-YOLO network of a ``DetectorConfig`` with parameters from a
JAX flat dict, a JAX ``.npz``/``.safetensors`` checkpoint
(``config.weights_path``) or a
seed, in ``dtype`` on ``device`` (the card unless the caller asks for the
CPU; asking for the card where there is none raises).
``config.pallas_convs``/``pallas_mode`` route the GL-CRM stages through the
3×3 conv kernel (K5), whose folded biases stay f32. The page program
(``pipeline/fused.py``) runs ``model`` over all views of a page as one
batch.

The host API is the reference contract: ``detect_batch`` (images
letterboxed on the host by one bilinear resize, ``_letterbox_host``, then
one forward with decode and NMS), ``detect_regions`` (a page's regions dict,
cached as ``{stem}_conf{c}_iou{i}.json`` under ``cache_dir``) and
``detect_page_multigrid`` (the page and every grid cell in one batch; with
``config.device_letterbox`` the views are letterboxed on the device by
``letterbox_views_matmul``, one view layout cached per page shape).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.config import ID_TO_NAMES, DetectorConfig
from multimodal_embeddings_tpu_torch.io.images import load_image_rgb
from multimodal_embeddings_tpu_torch.io.json_io import load_json, regions_dict, save_json
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import Flat, load_params, resolve_device
from multimodal_embeddings_tpu_torch.models.yolo import DocLayoutYOLO
from multimodal_embeddings_tpu_torch.models.yolo_decode import (
    decode_predictions,
    scale_boxes_to_original,
)
from multimodal_embeddings_tpu_torch.ops.grid import GridCell, grid_cells, translate_boxes
from multimodal_embeddings_tpu_torch.ops.image import (
    letterbox_views_matmul,
    resize_bilinear_host,
)

logger = get_logger("detector")


def _letterbox_host(
    image: np.ndarray, size: int, pad_value: float = 114.0
) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize onto a ``size``×``size`` float32 canvas
    with centred gray padding; returns ``(canvas, scale, (top, left))``.
    One bilinear resize with half-pixel centres (``resize_bilinear_host``)
    where the JAX function takes cv2's ``INTER_LINEAR``, or JAX's
    ``resize_bilinear`` without cv2."""
    h, w = image.shape[:2]
    scale = min(size / h, size / w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear_host(image, new_h, new_w)
    canvas = np.full((size, size, 3), pad_value, np.float32)
    top = (size - new_h) // 2
    left = (size - new_w) // 2
    canvas[top : top + new_h, left : left + new_w] = resized
    return canvas, scale, (top, left)


class LayoutDetector:
    def __init__(
        self,
        config: DetectorConfig = DetectorConfig(),
        num_classes: int = 10,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        params: Optional[Flat] = None,
        cache_dir: Optional[str] = None,
    ):
        self.config = config
        self.num_classes = num_classes
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        model = DocLayoutYOLO(num_classes, config.variant, config.glcrm,
                              config.pallas_convs, config.pallas_mode)
        load_params(model, seed, params, config.weights_path)
        f32 = {name: p.detach().clone() for name, p in model.named_parameters()
               if name in model.kernel_bias_names()}
        self.model = model.to(self.device, dtype, memory_format=torch.channels_last).eval()
        for name, p in self.model.named_parameters():
            if name in f32:  # K5's folded biases stay f32
                p.data = f32[name].to(self.device)
        self._views_layouts: Dict[Tuple[int, int], tuple] = {}

    @torch.inference_mode()
    def _forward(self, images: torch.Tensor):
        """(B, S, S, 3) pixels in [0, 255] on the device → padded
        detections, decoded and NMS'd."""
        cfg = self.config
        return decode_predictions(
            self.model((images / 255.0).to(self.dtype)),
            max_det=cfg.max_detections,
            conf_threshold=cfg.conf_threshold,
            iou_threshold=cfg.iou_threshold,
        )

    def _views_layout(self, height: int, width: int):
        """Per page shape: the views' slice bounds, their letterbox metas and
        the grid cells (cached)."""
        key = (height, width)
        if key not in self._views_layouts:
            bounds = [(0, 0, width, height)]
            cells_by_grid: Dict[Tuple[int, int], List[GridCell]] = {}
            for rows, cols in self.config.grid_configs:
                cells = grid_cells(width, height, rows, cols, self.config.overlap_percentage)
                cells_by_grid[(rows, cols)] = cells
                bounds.extend(cell.slice_bounds for cell in cells)
            size = self.config.image_size
            metas = []
            for x0, y0, x1, y1 in bounds:
                gh, gw = y1 - y0, x1 - x0
                scale = min(size / gh, size / gw)
                new_h, new_w = int(round(gh * scale)), int(round(gw * scale))
                metas.append((scale, ((size - new_h) // 2, (size - new_w) // 2)))
            self._views_layouts[key] = (metas, bounds, cells_by_grid)
        return self._views_layouts[key]

    # -- core batched API ---------------------------------------------------

    def detect_batch(
        self, images: Sequence[np.ndarray]
    ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Detection on a list of HxWx3 uint8/float RGB arrays, letterboxed
        on the host and run as one batch; per image (boxes_xyxy in original
        coordinates, classes, scores), NMS'd, in score-descending order."""
        size = self.config.image_size
        batch = np.zeros((len(images), size, size, 3), np.float32)
        metas = []
        for i, img in enumerate(images):
            canvas, scale, pad = _letterbox_host(np.asarray(img, np.float32), size)
            batch[i] = canvas
            metas.append((scale, pad, img.shape[:2]))
        det = self._forward(torch.from_numpy(batch).to(self.device))
        return self._postprocess_views(det, metas)

    @staticmethod
    def _postprocess_views(det, metas):
        """Model outputs → per-view (boxes_original, classes, scores);
        ``metas[i] = (scale, (pad_top, pad_left), (h, w))``."""
        boxes = det.boxes.cpu().numpy().astype(np.float64)
        scores = det.scores.cpu().numpy().astype(np.float64)
        classes = det.classes.cpu().numpy()
        valid = det.valid.cpu().numpy()

        results = []
        for i, (scale, pad, hw) in enumerate(metas):
            mask = valid[i]
            b = scale_boxes_to_original(boxes[i][mask], scale, pad, hw)
            results.append((b, classes[i][mask].astype(np.float64), scores[i][mask]))
        return results

    # -- reference-contract API --------------------------------------------

    def _cache_path(self, image_path: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        stem = os.path.splitext(os.path.basename(image_path))[0]
        return os.path.join(
            self.cache_dir,
            f"{stem}_conf{self.config.conf_threshold}_iou{self.config.iou_threshold}.json",
        )

    def _regions(self, path: str, shape, detection) -> Dict:
        boxes, classes, scores = detection
        return regions_dict(
            image_path=path,
            width=shape[1],
            height=shape[0],
            parameters={
                "conf_threshold": self.config.conf_threshold,
                "iou_threshold": self.config.iou_threshold,
            },
            boxes=boxes.tolist(),
            classes=classes.tolist(),
            scores=scores.tolist(),
            class_names=[ID_TO_NAMES[int(c)] for c in classes],
        )

    def detect_regions(self, image_path: str) -> Optional[Dict]:
        """Single-image regions dict with result caching
        (``doclayout_detector.py:99-163`` contract)."""
        cache = self._cache_path(image_path)
        if cache and os.path.exists(cache):
            logger.info("cache hit: %s", os.path.basename(cache))
            return load_json(cache)

        image = load_image_rgb(image_path)
        (detection,) = self.detect_batch([image])
        regions = self._regions(image_path, image.shape, detection)
        if cache:
            save_json(regions, cache)
        return regions

    def detect_page_multigrid(
        self, image_path: str, image: Optional[np.ndarray] = None
    ) -> Tuple[Dict, List[Tuple[Tuple[int, int], List[GridCell], List[Dict]]]]:
        """Detect the full page plus every grid view in ONE device batch.

        Returns ``(full_page_regions, per_grid)`` where ``per_grid`` is a list
        of ``((rows, cols), cells, cell_regions)`` with cell regions in the
        reference's cell-JSON layout (local boxes + ``boxes_original``).
        ``image`` (uint8 RGB) skips the decode."""
        if image is None:
            image = load_image_rgb(image_path)
        height, width = image.shape[:2]
        grids: List[Tuple[int, int]] = list(self.config.grid_configs)

        if self.config.device_letterbox:
            # the page uploaded once; every view sliced and letterboxed on
            # the device
            lb_metas, bounds, cells_by_grid = self._views_layout(height, width)
            page = torch.from_numpy(np.ascontiguousarray(image)).to(self.device)
            with torch.inference_mode():
                views, _ = letterbox_views_matmul(page.float(), bounds, self.config.image_size)
            det = self._forward(views)
            metas = [
                (scale, pad, (y1 - y0, x1 - x0))
                for (scale, pad), (x0, y0, x1, y1) in zip(lb_metas, bounds)
            ]
            detections = self._postprocess_views(det, metas)
            view_shapes = [(y1 - y0, x1 - x0, image.shape[2]) for (x0, y0, x1, y1) in bounds]
        else:
            views: List[np.ndarray] = [image]
            cells_by_grid = {}
            for rows, cols in grids:
                cells = grid_cells(width, height, rows, cols, self.config.overlap_percentage)
                cells_by_grid[(rows, cols)] = cells
                for cell in cells:
                    x0, y0, x1, y1 = cell.slice_bounds
                    views.append(image[y0:y1, x0:x1])
            detections = self.detect_batch(views)
            view_shapes = [v.shape for v in views]

        full_regions = self._regions(image_path, image.shape, detections[0])
        per_grid = []
        idx = 1
        for rows, cols in grids:
            cells = cells_by_grid[(rows, cols)]
            cell_regions = []
            for cell in cells:
                regions = self._regions(image_path, view_shapes[idx], detections[idx])
                regions["cell_coordinates"] = cell.coordinates
                regions["original_image_path"] = image_path
                regions["boxes_original"] = translate_boxes(regions["boxes"], cell)
                regions["grid_info"] = {
                    "rows": rows,
                    "cols": cols,
                    "row": cell.row,
                    "col": cell.col,
                }
                cell_regions.append(regions)
                idx += 1
            per_grid.append(((rows, cols), cells, cell_regions))
        return full_regions, per_grid
