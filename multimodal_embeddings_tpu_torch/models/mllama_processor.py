"""Mllama image-processor constants and aspect-ratio ids.

Verbatim copies from ``multimodal_embeddings_tpu/models/mllama_processor.py``
(held equal by ``tests/test_torch_mme5.py``): the CLIP normalisation the
page program applies to its crops, and the aspect-ratio enumeration that
sizes the vision tower's tile tables (``(w, h)`` with ``w·h ≤ max_tiles``,
width-major; id = index + 1, 0 pads). The host tiling
(``preprocess_image``) is not ported yet.
"""

from __future__ import annotations

from typing import List, Tuple

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
