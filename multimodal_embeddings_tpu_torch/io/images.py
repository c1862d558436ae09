"""Image helpers on the host.

Copies of the functions of the same names in
``multimodal_embeddings_tpu/io/images.py``, which takes ``IMAGE_EXTENSIONS``
from the package's ``config`` as this one does, with PIL imported where an
image is opened or resized
(``tests/test_torch_serve.py``, ``tests/test_torch_embedder.py`` and
``tests/test_torch_stages.py`` hold them equal). ``validate_image``
suppresses PIL's error where the JAX function catches it: the package keeps
no ``try``.

``load_image_bgr``, ``load_image_gray`` and ``save_image_bgr`` take cv2
where it is installed and PIL otherwise, as the JAX module does; cv2 is
found by ``importlib.util.find_spec`` (``cv2_module``) and imported only
where an image is read or written.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
from typing import List, Optional, Tuple

import numpy as np

from multimodal_embeddings_tpu_torch.config import IMAGE_EXTENSIONS


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


def cv2_module():
    """The cv2 module where it is installed, else None (the JAX module's
    ``cv2`` global: cv2 when it imports, PIL otherwise)."""
    if importlib.util.find_spec("cv2") is None:
        return None
    return importlib.import_module("cv2")


def load_image_bgr(path: str) -> Optional[np.ndarray]:
    """uint8 HxWx3 BGR (cv2 convention used by the reference viz/rotation)."""
    cv2 = cv2_module()
    if cv2 is not None:
        return cv2.imread(path)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"))
    return img[:, :, ::-1].copy()


def load_image_rgb(path: str) -> np.ndarray:
    """uint8 HxWx3 RGB (model input convention)."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_image_gray(path: str) -> Optional[np.ndarray]:
    cv2 = cv2_module()
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def save_image_bgr(path: str, image: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2 = cv2_module()
    if cv2 is not None:
        cv2.imwrite(path, image)
    else:
        from PIL import Image

        Image.fromarray(image[:, :, ::-1]).save(path)


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
