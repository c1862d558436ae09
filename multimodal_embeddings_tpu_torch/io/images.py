"""Image helpers on the host.

Copies of the functions of the same names in
``multimodal_embeddings_tpu/io/images.py`` and of ``IMAGE_EXTENSIONS`` from
its ``config``: that module imports the JAX package's ``config``, so only the
functions are copied, with PIL imported where an image is opened or resized
(``tests/test_torch_serve.py`` and ``tests/test_torch_embedder.py`` hold
them equal). ``validate_image`` suppresses PIL's error where the JAX
function catches it: the package keeps no ``try``.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Tuple

import numpy as np

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".webp", ".tiff", ".tif", ".bmp")


def get_image_paths(input_folder: str) -> List[str]:
    """Recursive, extension-filtered, sorted discovery
    (``1_doclayout_bboxes.py:345-364``)."""
    image_paths = []
    for root, _, files in os.walk(input_folder):
        for file in files:
            ext = os.path.splitext(file)[1].lower()
            if ext in IMAGE_EXTENSIONS:
                image_paths.append(os.path.join(root, file))
    return sorted(image_paths)


def validate_image(image_path: str) -> bool:
    """PIL verify (``image_utils.py:26-35``)."""
    from PIL import Image

    valid = False
    with contextlib.suppress(Exception):
        with Image.open(image_path) as img:
            img.verify()
        valid = True
    return valid


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 HxWx3 RGB (model input convention)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without full decode."""
    from PIL import Image

    with Image.open(path) as img:
        return img.size


def resize_image_if_needed(img, max_dim: int = 8000):
    """LANCZOS downscale when either side exceeds ``max_dim``
    (``image_utils.py:37-53``, ``embedder.py:110-114``)."""
    from PIL import Image

    width, height = img.size
    if width <= max_dim and height <= max_dim:
        return img
    scale = min(max_dim / width, max_dim / height)
    new_size = (int(width * scale), int(height * scale))
    return img.resize(new_size, Image.LANCZOS)
