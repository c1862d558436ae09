"""Image helpers on the host.

``resize_image_if_needed`` is a verbatim copy of the function of the same
name in ``multimodal_embeddings_tpu/io/images.py`` (that module imports the
JAX package's ``config``, so only the function is copied, with PIL
imported where the image is resized; ``tests/test_torch_embedder.py``
holds the two equal).
"""

from __future__ import annotations


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
