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
   (siglip), or CLIP-normalised and embedded by the mmE5 model with the
   prompt (mme5): single-tile crops by default, or with ``embed_tiles=4``
   crops at twice the tile size split into the (2, 2) tile canvas
   (``tile_crops_2x2``).

``build_split_page_fn(text_chunk=N)`` decouples the mmE5 model's two
halves: the vision tower runs ``embed_chunk`` crops at a time, the states
are concatenated on the device, and the text stack runs ``N`` crops at a
time over them.

Step 1 squeezes each view to the detector's square input, or with
``letterbox=True`` (the serving CLI's default) letterboxes it on a 114-gray
canvas (``letterbox_views_matmul``), as in the JAX package: the page in
bf16, the canvas in f32, then bf16 ``/255``.

``build_fused_batch_fn`` and ``build_split_batch_fn`` run a batch of B
pages: PyTorch has no ``vmap`` program to build, so the page batch is
folded into the leading dimension of each device call: the detector runs
the B·V views in one call, then each page's selection and crops, and the
embedder runs chunk i of every page as one call of B·chunk crops (the
fused batch: all B·K crops at once). With a ``mesh`` the pages are sharded
over its data axis, one contiguous block a rank; every rank holds its own
copy of the weights (a model-sharded embedder keeps its shard), and the
results are all-gathered, so every rank returns the whole batch's result.

PyTorch runs eagerly, so the JAX package's program-shaping arguments
(``closure_weights``, ``embed_closure``, ``auto_layouts``) and its XLA cost
analysis have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.core.mesh import DATA_AXIS, shard_batch
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
from multimodal_embeddings_tpu_torch.models.mllama_processor import (
    IMAGE_MEAN,
    IMAGE_STD,
    aspect_ratio_to_id,
)
from multimodal_embeddings_tpu_torch.models.yolo_decode import (
    decode_predictions,
    top_k,
)
from multimodal_embeddings_tpu_torch.ops.edge_filter import internal_edge_mask
from multimodal_embeddings_tpu_torch.ops.grid import grid_cells
from multimodal_embeddings_tpu_torch.ops.image import (
    crop_and_resize_mxu,
    extract_views_matmul,
    letterbox_views_matmul,
)
from multimodal_embeddings_tpu_torch.ops.nms import nms_padded


class PageResult(NamedTuple):
    boxes: torch.Tensor  # (K, 4) page-coordinate xyxy
    scores: torch.Tensor  # (K,)
    classes: torch.Tensor  # (K,) int32
    valid: torch.Tensor  # (K,) bool
    embeddings: torch.Tensor  # (K, D) L2-normalised region embeddings


def view_boxes_for_page(
    width: int, height: int, grids: Sequence[Tuple[int, int]], overlap: float
) -> np.ndarray:
    """Static (V, 4) xyxy view rectangles: full page + every grid cell."""
    boxes = [[0.0, 0.0, float(width), float(height)]]
    for rows, cols in grids:
        for cell in grid_cells(width, height, rows, cols, overlap):
            boxes.append([cell.x_start, cell.y_start, cell.x_end, cell.y_end])
    return np.asarray(boxes, np.float32)


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
    resize_dtype=torch.bfloat16,
    combine_iou: float = 0.5,
    return_candidates: bool = False,
):
    """``fn(page_uint8) → (boxes, scores, classes, valid, crops)`` of the
    top ``num_regions`` regions, without the embedding forward; the page is
    ``(H, W, 3)`` uint8 on the detector's device.

    ``letterbox`` letterboxes each view instead of squeezing it;
    ``edge_filter`` drops grid-cell boxes within 10 px of an internal cell
    edge before the cross-view NMS; ``candidate_cap`` bounds that NMS at
    ``cap·num_regions`` candidates (≤ 0: all view boxes). The page is cast
    to ``resize_dtype`` (bf16 by default, as in the JAX package) before the
    views are resampled and the regions cropped; the views enter the
    detector in bf16 whatever that type. ``combine_iou`` is the cross-view
    NMS's IoU threshold. ``return_candidates=True`` makes ``fn`` return the
    set that NMS sees instead, ``(cand_boxes, cand_scores, cand_classes)``
    after the edge filter and the candidate top-k (the serve-vs-exact
    parity tools' tap). ``fn.batch(pages)`` takes a (B, H, W, 3) batch: the
    detector runs its B·V views in one call, and every output gains a
    leading page dim."""
    height, width = page_hw
    cfg = detector.config
    view_bounds = view_slice_bounds_for_page(
        width, height, cfg.grid_configs, cfg.overlap_percentage
    )
    det_size = cfg.image_size
    dev = detector.device

    # per-view affine from detector-input pixels back to page pixels:
    # squeeze → scale (w/S, h/S), offset (x0, y0); letterbox → scale 1/s,
    # offset (x0 − left/s, y0 − top/s) at the host letterbox's (s, top, left)
    vb = np.asarray(view_bounds, np.float32)
    if letterbox:
        affine = []
        for x0, y0, x1, y1 in view_bounds:
            gh, gw = y1 - y0, x1 - x0
            s = min(det_size / gh, det_size / gw)
            new_h, new_w = int(round(gh * s)), int(round(gw * s))
            top, left = (det_size - new_h) // 2, (det_size - new_w) // 2
            affine.append((1.0 / s, 1.0 / s, x0 - left / s, y0 - top / s))
        sx, sy, ox, oy = np.asarray(affine, np.float32).T
    else:
        sx, sy = (vb[:, 2] - vb[:, 0]) / det_size, (vb[:, 3] - vb[:, 1]) / det_size
        ox, oy = vb[:, 0], vb[:, 1]
    sx, sy, ox, oy = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)[:, None]
                      for a in (sx, sy, ox, oy))
    cells = torch.from_numpy(vb).to(dev)
    page_size = torch.tensor([float(width), float(height)], device=dev)

    def views_of(pagef: torch.Tensor) -> torch.Tensor:
        if letterbox:
            return (letterbox_views_matmul(pagef, view_bounds, det_size)[0].to(torch.bfloat16)
                    / 255.0)
        return extract_views_matmul(pagef, view_bounds, det_size, dtype=torch.bfloat16) / 255.0

    def select_and_crop(pagef, det_boxes, det_scores, det_classes, det_valid):
        """One page's V views' detections → its top regions and crops."""
        b = det_boxes  # (V, M, 4) detector-input pixels
        view_page_boxes = torch.stack(
            [b[..., 0] * sx + ox, b[..., 1] * sy + oy,
             b[..., 2] * sx + ox, b[..., 3] * sy + oy],
            dim=-1,
        )
        valid = det_valid
        if edge_filter:
            valid = valid & ~internal_edge_mask(
                view_page_boxes, cells, page_size, threshold=10.0
            )
        page_boxes = view_page_boxes.reshape(-1, 4)
        flat_scores = torch.where(valid, det_scores, -1.0).reshape(-1)
        flat_classes = det_classes.reshape(-1)

        # class-aware cross-view NMS (IoU combine_iou) over the strongest
        # candidates, then the top num_regions survivors
        n_all = flat_scores.shape[0]
        n_cand = n_all if candidate_cap <= 0 else min(candidate_cap * num_regions, n_all)
        cand_scores, cand_idx = top_k(flat_scores, n_cand)
        cand_boxes = page_boxes[cand_idx]
        cand_classes = flat_classes[cand_idx]
        if return_candidates:
            return cand_boxes, cand_scores, cand_classes
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

    @torch.inference_mode()
    def detect_and_crop_batch(pages: torch.Tensor):
        """(B, H, W, 3) uint8 pages → each output with a leading page dim:
        the detector runs all B·V views in one call, then each page's
        selection and crops."""
        pagesf = pages.to(resize_dtype)
        views = [views_of(p) for p in pagesf]
        n_views = views[0].shape[0]
        det = decode_predictions(
            detector.model(torch.cat(views) if len(views) > 1 else views[0]),
            max_det=cfg.max_detections,
            conf_threshold=cfg.conf_threshold,
            iou_threshold=cfg.iou_threshold,
        )
        per_page = [
            select_and_crop(pagef, *(x[i * n_views : (i + 1) * n_views] for x in det))
            for i, pagef in enumerate(pagesf)
        ]
        return tuple(torch.stack(field) for field in zip(*per_page))

    def detect_and_crop(page: torch.Tensor):
        return tuple(x[0] for x in detect_and_crop_batch(page[None]))

    detect_and_crop.batch = detect_and_crop_batch
    return detect_and_crop


def tile_crops_2x2(crops: torch.Tensor, tile: int) -> torch.Tensor:
    """(K, 2·tile, 2·tile, C) → (K, 4, tile, tile, C) in the Mllama
    processor's row-major tile order (``mllama_processor.preprocess_image``:
    canvas.reshape(th, tile, tw, tile, 3).transpose(0, 2, 1, 3, 4))."""
    k, h, w, c = crops.shape
    assert h == 2 * tile and w == 2 * tile, (h, w, tile)
    t = crops.reshape(k, 2, tile, 2, tile, c)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(k, 4, tile, tile, c)


def _region_embed_fn(embedder, num_regions, embed_chunk, embed_tiles, text_chunk=0):
    """``embed(crops) → (num_regions, D)`` of the page's crops (``[0, 1]``
    pixels), ``embed_chunk`` crops a call (0: all in one). The mme5 family
    CLIP-normalises the crops first and, at ``embed_tiles=4``, feeds each
    crop's (2, 2) tile canvas with its aspect-ratio id and a tile mask of
    ones; ``text_chunk`` runs the vision tower at ``embed_chunk`` crops and
    the text stack at ``text_chunk`` crops over the concatenated states."""
    family = embedder.config.family
    if embed_tiles not in (1, 4):
        raise ValueError(f"embed_tiles must be 1 or 4, got {embed_tiles}")
    if embed_tiles == 4 and family != "mme5":
        raise ValueError("embed_tiles=4 requires the tiled mme5 family")
    if text_chunk and family != "mme5":
        raise ValueError("text_chunk decouples the Mllama vision/text stacks: mme5 only")
    embed_chunk = embed_chunk or num_regions
    for name, chunk in (("embed_chunk", embed_chunk), ("text_chunk", text_chunk)):
        if chunk and num_regions % chunk:
            raise ValueError(f"{name} {chunk} must divide {num_regions}")
    embed_one = embedder.encode_image
    if family == "mme5":
        dev = embedder.device
        mean, std = torch.tensor(IMAGE_MEAN, device=dev), torch.tensor(IMAGE_STD, device=dev)
        ar_id = aspect_ratio_to_id((2, 2), embedder.model_config.vision.max_tiles) \
            if embed_tiles == 4 else None

        def normalise(crops):
            crops = (crops - mean.to(crops.dtype)) / std.to(crops.dtype)
            return crops if embed_tiles == 1 else tile_crops_2x2(crops, embedder.image_size)

        def tile_args(n):
            """(aspect-ratio ids, tile mask) of n (2, 2) canvases; none for
            single tiles (the tower's key-prefix route)."""
            if embed_tiles == 1:
                return ()
            return (torch.full((n,), ar_id, dtype=torch.long, device=dev),
                    torch.ones(n, 4, dtype=torch.long, device=dev))

        def embed_one(crops):
            return embedder.encode_tiles(normalise(crops), *tile_args(crops.shape[0]))

    def chunks(x, size):
        return [x[i : i + size] for i in range(0, num_regions, size)]

    def embed(crops: torch.Tensor) -> torch.Tensor:
        if not text_chunk:
            return torch.cat([embed_one(c) for c in chunks(crops, embed_chunk)])
        states = torch.cat([embedder.vision_states(normalise(c), *tile_args(c.shape[0]))
                            for c in chunks(crops, embed_chunk)])
        # vision_mask None: every tile of a page crop is real
        return torch.cat([embedder.embed_vision_states(s) for s in chunks(states, text_chunk)])

    def embed_batch(crops: torch.Tensor) -> torch.Tensor:
        """(B, K, ...) crops of B pages → (B, K, D): chunk i of every page
        in one call of B·chunk crops, pages outermost."""
        b = crops.shape[0]
        return torch.cat([embed_one(crops[:, i : i + embed_chunk].flatten(0, 1)).unflatten(0, (b, -1))
                          for i in range(0, num_regions, embed_chunk)], dim=1)

    embed.batch = embed_batch
    return embed


def build_fused_page_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    embed_chunk: int = 0,
    letterbox: bool = False,
    edge_filter: bool = True,
    embed_tiles: int = 1,
):
    """``fn(page_uint8) → PageResult``: detect, crop, and embed all
    ``num_regions`` crops, ``embed_chunk`` at a time (0: all in one call;
    otherwise it must divide ``num_regions``). ``embed_tiles=4`` (mme5
    only) crops each region at twice the tile size and feeds the tower its
    (2, 2) tile canvas. The eager port runs one program either way, so this
    is ``build_split_page_fn`` with its chunk."""
    return build_split_page_fn(detector, embedder, page_hw, num_regions, embed_chunk,
                               letterbox, edge_filter, embed_tiles)


def build_split_page_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    embed_chunk: int = 8,
    letterbox: bool = False,
    edge_filter: bool = True,
    embed_tiles: int = 1,
    text_chunk: int = 0,
):
    """``fn(page_uint8) → PageResult``: one detect+crop call, then the
    crops embedded ``embed_chunk`` at a time (0: all at once; the headline
    runs ``embed_chunk = num_regions``, the mme5 page 8). The two halves are
    exposed as ``fn.detect(page)`` and ``fn.embed(crops)``; the mme5 family
    normalises crops with the CLIP mean and std first.
    ``embed_tiles=4`` as in ``build_fused_page_fn``; ``text_chunk=N`` (mme5
    only, N dividing ``num_regions``) runs the text stack N crops at a time
    over the vision states of all the page's crops."""
    embed = _region_embed_fn(embedder, num_regions, embed_chunk, embed_tiles, text_chunk)
    detect_fn = build_fused_detect_fn(
        detector, page_hw, num_regions, embedder.image_size * (2 if embed_tiles == 4 else 1),
        letterbox=letterbox, edge_filter=edge_filter,
    )

    def fn(page: torch.Tensor) -> PageResult:
        boxes, scores, classes, valid, crops = detect_fn(page)
        return PageResult(boxes, scores, classes, valid, embed(crops))

    fn.detect = detect_fn
    fn.embed = embed
    return fn


def _batch_fn(detect, embed_batch, device, mesh):
    """``fn(pages (B, H, W, C) uint8, a tensor or numpy) → PageResult`` with
    a leading page dim on every field; over ``mesh``, this rank's block of
    the pages, the results gathered over its data axis."""

    def batched(pages) -> PageResult:
        boxes, scores, classes, valid, crops = detect.batch(torch.as_tensor(pages).to(device))
        return PageResult(boxes, scores, classes, valid, embed_batch(crops))

    if mesh is None:
        fn = batched
    else:

        def gather(x: torch.Tensor) -> torch.Tensor:
            if x.dtype == torch.bool:  # gloo gathers no bool
                return mesh.all_gather(x.to(torch.uint8), DATA_AXIS).bool()
            return mesh.all_gather(x, DATA_AXIS)

        def fn(pages) -> PageResult:
            return PageResult(*map(gather, batched(shard_batch(mesh, pages))))

    fn.detect = detect.batch
    fn.embed = embed_batch
    return fn


def build_fused_batch_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    mesh=None,
    letterbox: bool = False,
    edge_filter: bool = True,
):
    """Multi-page variant of ``build_fused_page_fn``: a page batch through
    one detector call over all its views and one embedder call over all its
    crops, optionally sharded over the mesh's data axis (the multi-card
    serving path: each rank processes its block of pages).

    Returns ``fn(pages_uint8 (B, H, W, C)) -> PageResult`` with leading
    batch dims on every field; ``fn.detect`` and ``fn.embed`` are its two
    halves."""
    embed = _region_embed_fn(embedder, num_regions, 0, 1)
    detect = build_fused_detect_fn(detector, page_hw, num_regions, embedder.image_size,
                                   letterbox=letterbox, edge_filter=edge_filter)
    return _batch_fn(detect, embed.batch, detector.device, mesh)


def build_split_batch_fn(
    detector: LayoutDetector,
    embedder: MultimodalEmbedder,
    page_hw: Tuple[int, int],
    num_regions: int = 48,
    embed_chunk: int = 8,
    letterbox: bool = False,
    edge_filter: bool = True,
    mesh=None,
):
    """Data-parallel variant of the two-half split: a page BATCH runs the
    detect+crop half at once, then each region chunk of every page runs as
    one embedder call (``crops[:, i:i+embed_chunk]``, B·chunk crops) — with
    a ``mesh`` every rank serves its own pages (the reference's per-GPU
    round-robin, ``deprecated_package/embedder.py:190-224``). This is the
    multi-card serving shape for the PARITY embedder: an 11B int8 tree
    fills much of one card, so scaling is one page per card over the data
    axis rather than intra-page parallelism.

    Returns ``fn(pages_uint8 (B, H, W, C)) -> PageResult`` with leading
    batch dims. Per-page results equal ``build_split_page_fn`` (the
    single-page split) within the batched calls' reassociation tolerance."""
    family = embedder.config.family
    if family not in ("mme5", "siglip"):
        raise ValueError(f"unsupported split-batch family: {family}")
    assert num_regions % embed_chunk == 0, (num_regions, embed_chunk)
    embed = _region_embed_fn(embedder, num_regions, embed_chunk, 1)
    detect = build_fused_detect_fn(detector, page_hw, num_regions, embedder.image_size,
                                   letterbox=letterbox, edge_filter=edge_filter)
    return _batch_fn(detect, embed.batch, detector.device, mesh)
