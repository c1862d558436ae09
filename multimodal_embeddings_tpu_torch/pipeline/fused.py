"""The page program: page in → boxes and region embeddings out.

Port of ``multimodal_embeddings_tpu/pipeline/fused.py``. Per page, on the
device:

1. all views (full page + every grid cell) as static slices resized by
   interpolation-matrix products (``ops/image.py``);
2. the detector over all views as one batch, DFL decode and per-view
   padded NMS (``models/yolo_decode.py``);
3. per-view boxes to page coordinates, the internal-edge filter, the
   class-aware cross-view NMS over the strongest candidates, and the top-K
   regions by score;
4. the K regions cropped from the full page and embedded: by the ViT tower
   (siglip), or CLIP-normalised and embedded single-tile by the mmE5 model
   with the prompt (mme5).

PyTorch runs eagerly, so the JAX package's program-shaping arguments
(``closure_weights``, ``embed_closure``, ``auto_layouts``) and its XLA cost
analysis have no counterpart. The letterboxed views, the mme5 family's
decoupled ``text_chunk`` and 4-tile ``embed_tiles`` paths and the multi-page
batch functions are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.mllama_processor import IMAGE_MEAN, IMAGE_STD
from multimodal_embeddings_tpu_torch.models.yolo_decode import (
    decode_predictions,
    top_k,
)
from multimodal_embeddings_tpu_torch.ops.edge_filter import internal_edge_mask
from multimodal_embeddings_tpu_torch.ops.grid import grid_cells
from multimodal_embeddings_tpu_torch.ops.image import (
    crop_and_resize_mxu,
    extract_views_matmul,
)
from multimodal_embeddings_tpu_torch.ops.nms import nms_padded


class PageResult(NamedTuple):
    boxes: torch.Tensor  # (K, 4) page-coordinate xyxy
    scores: torch.Tensor  # (K,)
    classes: torch.Tensor  # (K,) int32
    valid: torch.Tensor  # (K,) bool
    embeddings: torch.Tensor  # (K, D) L2-normalised region embeddings


def view_slice_bounds_for_page(
    width: int, height: int, grids: Sequence[Tuple[int, int]], overlap: float
) -> list:
    """Integer pixel bounds ``(x0, y0, x1, y1)`` per view: the full page,
    then every grid cell."""
    bounds = [(0, 0, width, height)]
    for rows, cols in grids:
        for cell in grid_cells(width, height, rows, cols, overlap):
            bounds.append(cell.slice_bounds)
    return bounds


def build_fused_detect_fn(
    detector: LayoutDetector,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    emb_size: int = 448,
    letterbox: bool = False,
    edge_filter: bool = True,
    candidate_cap: int = 4,
    combine_iou: float = 0.5,
):
    """``fn(page_uint8) → (boxes, scores, classes, valid, crops)`` of the
    top ``num_regions`` regions, without the embedding forward; the page is
    ``(H, W, 3)`` uint8 on the detector's device.

    ``edge_filter`` drops grid-cell boxes within 10 px of an internal cell
    edge before the cross-view NMS; ``candidate_cap`` bounds that NMS at
    ``cap·num_regions`` candidates (≤ 0: all view boxes). Pixels ride in
    bf16 through the resampling, as in the JAX package's default."""
    if letterbox:
        raise NotImplementedError("letterboxed views are not ported yet")
    height, width = page_hw
    cfg = detector.config
    view_bounds = view_slice_bounds_for_page(
        width, height, cfg.grid_configs, cfg.overlap_percentage
    )
    det_size = cfg.image_size
    dev = detector.device

    # per-view affine from detector-input pixels back to page pixels
    vb = np.asarray(view_bounds, np.float32)
    sx = torch.from_numpy((vb[:, 2] - vb[:, 0]) / det_size).to(dev)[:, None]
    sy = torch.from_numpy((vb[:, 3] - vb[:, 1]) / det_size).to(dev)[:, None]
    ox = torch.from_numpy(vb[:, 0]).to(dev)[:, None]
    oy = torch.from_numpy(vb[:, 1]).to(dev)[:, None]
    cells = torch.from_numpy(vb).to(dev)
    page_size = torch.tensor([float(width), float(height)], device=dev)

    @torch.inference_mode()
    def detect_and_crop(page: torch.Tensor):
        pagef = page.to(torch.bfloat16)
        view_imgs = (
            extract_views_matmul(pagef, view_bounds, det_size, dtype=torch.bfloat16)
            / 255.0
        )
        det = decode_predictions(
            detector.model(view_imgs),
            max_det=cfg.max_detections,
            conf_threshold=cfg.conf_threshold,
            iou_threshold=cfg.iou_threshold,
        )
        b = det.boxes  # (V, M, 4) detector-input pixels
        view_page_boxes = torch.stack(
            [b[..., 0] * sx + ox, b[..., 1] * sy + oy,
             b[..., 2] * sx + ox, b[..., 3] * sy + oy],
            dim=-1,
        )
        valid = det.valid
        if edge_filter:
            valid = valid & ~internal_edge_mask(
                view_page_boxes, cells, page_size, threshold=10.0
            )
        page_boxes = view_page_boxes.reshape(-1, 4)
        flat_scores = torch.where(valid, det.scores, -1.0).reshape(-1)
        flat_classes = det.classes.reshape(-1)

        # class-aware cross-view NMS (IoU combine_iou) over the strongest
        # candidates, then the top num_regions survivors
        n_all = flat_scores.shape[0]
        n_cand = n_all if candidate_cap <= 0 else min(candidate_cap * num_regions, n_all)
        cand_scores, cand_idx = top_k(flat_scores, n_cand)
        cand_boxes = page_boxes[cand_idx]
        cand_classes = flat_classes[cand_idx]
        keep, order = nms_padded(
            cand_boxes, cand_scores, cand_classes, cand_scores > 0,
            iou_threshold=combine_iou, class_aware=True,
        )
        kept_scores = torch.where(keep, cand_scores[order], -1.0)
        top_scores, sel = top_k(kept_scores, num_regions)
        sel_orig = order[sel]
        top_boxes = cand_boxes[sel_orig]
        crops = (
            crop_and_resize_mxu(
                pagef, top_boxes, out_size=emb_size, compute_dtype=torch.bfloat16
            )
            / 255.0
        )
        return top_boxes, top_scores, cand_classes[sel_orig], top_scores > 0, crops

    return detect_and_crop


def build_fused_page_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    letterbox: bool = False,
    edge_filter: bool = True,
):
    """``fn(page_uint8) → PageResult``: detect, crop, and embed all
    ``num_regions`` crops in one call."""
    detect_and_crop = build_fused_detect_fn(
        detector, page_hw, num_regions, embedder.image_size,
        letterbox=letterbox, edge_filter=edge_filter,
    )

    def fn(page: torch.Tensor) -> PageResult:
        boxes, scores, classes, valid, crops = detect_and_crop(page)
        return PageResult(boxes, scores, classes, valid, embedder.encode_image(crops))

    return fn


def build_split_page_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    embed_chunk: int = 8,
    letterbox: bool = False,
    edge_filter: bool = True,
):
    """``fn(page_uint8) → PageResult``: one detect+crop call, then the
    crops embedded ``embed_chunk`` at a time (the serving split; the
    headline runs ``embed_chunk = num_regions``, the mme5 page 8). The two
    halves are exposed as ``fn.detect(page)`` and ``fn.embed(crops)``; the
    mme5 family normalises crops with the CLIP mean and std first."""
    if num_regions % embed_chunk:
        raise ValueError(f"embed_chunk {embed_chunk} must divide {num_regions}")
    detect_fn = build_fused_detect_fn(
        detector, page_hw, num_regions, embedder.image_size,
        letterbox=letterbox, edge_filter=edge_filter,
    )
    normalise = embedder.config.family == "mme5"
    mean = torch.tensor(IMAGE_MEAN, device=embedder.device)
    std = torch.tensor(IMAGE_STD, device=embedder.device)

    def embed_chunk_fn(crops: torch.Tensor) -> torch.Tensor:
        if normalise:
            crops = (crops - mean.to(crops.dtype)) / std.to(crops.dtype)
        return embedder.encode_image(crops)

    def embed(crops: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            embed_chunk_fn(crops[i : i + embed_chunk])
            for i in range(0, num_regions, embed_chunk)
        ])

    def fn(page: torch.Tensor) -> PageResult:
        boxes, scores, classes, valid, crops = detect_fn(page)
        return PageResult(boxes, scores, classes, valid, embed(crops))

    fn.detect = detect_fn
    fn.embed = embed
    return fn
