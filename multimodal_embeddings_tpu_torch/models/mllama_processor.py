"""Mllama image processor: constants, aspect-ratio ids and the host tiling.

Verbatim copies from ``multimodal_embeddings_tpu/models/mllama_processor.py``
(held equal by ``tests/test_torch_mme5.py`` and
``tests/test_torch_embedder.py``): the CLIP normalisation the page program
applies to its crops, the aspect-ratio enumeration that sizes the vision
tower's tile tables (``(w, h)`` with ``w·h ≤ max_tiles``, width-major; id =
index + 1, 0 pads), and ``preprocess_image``, which resizes an image
(bilinear) onto the best-fitting canvas of up to ``max_tiles`` tiles, pads
it bottom/right with zeros, normalises it and splits it row-major into a
tile stack with its aspect-ratio id and tile mask. NumPy and PIL, on the
host, once per image.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

TILE_SIZE = 560
MAX_TILES = 4

# CLIP normalization constants (the Mllama preprocessor_config values)
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def get_all_supported_aspect_ratios(max_tiles: int = MAX_TILES) -> List[Tuple[int, int]]:
    """All (tiles_w, tiles_h) arrangements with tiles_w*tiles_h <= max_tiles."""
    out = []
    for width in range(1, max_tiles + 1):
        for height in range(1, max_tiles + 1):
            if width * height <= max_tiles:
                out.append((width, height))
    return out


def num_aspect_ratio_ids(max_tiles: int = MAX_TILES) -> int:
    """Size of the aspect-ratio embedding tables (ids are 1-based; 0 pads)."""
    return len(get_all_supported_aspect_ratios(max_tiles)) + 1


def aspect_ratio_to_id(aspect_ratio: Tuple[int, int], max_tiles: int = MAX_TILES) -> int:
    return get_all_supported_aspect_ratios(max_tiles).index(tuple(aspect_ratio)) + 1


def get_optimal_tiled_canvas(
    image_height: int,
    image_width: int,
    max_tiles: int = MAX_TILES,
    tile_size: int = TILE_SIZE,
) -> Tuple[int, int]:
    """Best (tiles_w, tiles_h) arrangement for an image: prefer the least
    upscaling (smallest scale >= 1) else the least downscaling (largest
    scale < 1); among ties, the smallest canvas area."""
    arrangements = get_all_supported_aspect_ratios(max_tiles)
    scales = []
    for tw, th in arrangements:
        canvas_w, canvas_h = tw * tile_size, th * tile_size
        scales.append(min(canvas_w / image_width, canvas_h / image_height))
    upscales = [s for s in scales if s >= 1]
    selected_scale = min(upscales) if upscales else max(s for s in scales)
    best = None
    for (tw, th), s in zip(arrangements, scales):
        if s != selected_scale:
            continue
        area = tw * th * tile_size * tile_size
        if best is None or area < best[0]:
            best = (area, (tw, th))
    return best[1]


def get_image_size_fit_to_canvas(
    image_height: int,
    image_width: int,
    canvas_height: int,
    canvas_width: int,
    tile_size: int = TILE_SIZE,
) -> Tuple[int, int]:
    """Target (height, width) preserving aspect ratio within the canvas,
    with each side at least one tile's worth of target before clamping."""
    target_width = int(np.clip(image_width, tile_size, canvas_width))
    target_height = int(np.clip(image_height, tile_size, canvas_height))
    scale_h = target_height / image_height
    scale_w = target_width / image_width
    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.floor(image_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.floor(image_width * scale_h), target_width)
    return new_height, new_width


@dataclasses.dataclass
class TiledImage:
    tiles: np.ndarray  # (max_tiles, tile, tile, 3) float32, normalized
    aspect_ratio_id: int
    num_tiles: int
    aspect_ratio: Tuple[int, int]  # (tiles_w, tiles_h)

    @property
    def tile_mask(self) -> np.ndarray:
        mask = np.zeros(self.tiles.shape[0], np.int32)
        mask[: self.num_tiles] = 1
        return mask


def _resize_bilinear(image: np.ndarray, height: int, width: int) -> np.ndarray:
    from PIL import Image

    pil = Image.fromarray(image.astype(np.uint8))
    return np.asarray(pil.resize((width, height), Image.BILINEAR), np.float32)


def preprocess_image(
    image: np.ndarray,
    max_tiles: int = MAX_TILES,
    tile_size: int = TILE_SIZE,
    mean: Sequence[float] = IMAGE_MEAN,
    std: Sequence[float] = IMAGE_STD,
) -> TiledImage:
    """uint8 HWC image → normalized tile stack + aspect-ratio metadata."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    h, w = image.shape[:2]
    tiles_w, tiles_h = get_optimal_tiled_canvas(h, w, max_tiles, tile_size)
    canvas_h, canvas_w = tiles_h * tile_size, tiles_w * tile_size
    new_h, new_w = get_image_size_fit_to_canvas(h, w, canvas_h, canvas_w, tile_size)
    resized = _resize_bilinear(image, new_h, new_w)
    canvas = np.zeros((canvas_h, canvas_w, 3), np.float32)
    canvas[:new_h, :new_w] = resized
    canvas = canvas / 255.0
    canvas = (canvas - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    # split row-major into tiles: (th, tile, tw, tile, 3) → (th*tw, ...)
    tiled = canvas.reshape(tiles_h, tile_size, tiles_w, tile_size, 3)
    tiled = tiled.transpose(0, 2, 1, 3, 4).reshape(
        tiles_h * tiles_w, tile_size, tile_size, 3
    )
    num = tiles_h * tiles_w
    out = np.zeros((max_tiles, tile_size, tile_size, 3), np.float32)
    out[:num] = tiled
    return TiledImage(
        tiles=out,
        aspect_ratio_id=aspect_ratio_to_id((tiles_w, tiles_h), max_tiles),
        num_tiles=num,
        aspect_ratio=(tiles_w, tiles_h),
    )
