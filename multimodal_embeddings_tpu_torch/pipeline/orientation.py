"""Stage 0 — orientation / deskew correction.

Port of ``multimodal_embeddings_tpu/pipeline/orientation.py``. Behavioral
contract (``0_orientation.py:203-324``): per image, estimate skew; if no
reliable estimate or |angle| below the sensitivity threshold, copy the file
unchanged; otherwise rotate with an expanding (no-crop) bound and save. An
image that cannot be read or written falls back to copying the original.

The estimator is the projection-profile scan on the card (``ops/skew.py``)
and the rotation is ``ops/image.py::rotate_bound`` on the card, rounded to
uint8 on the host as the JAX stage does. Tesseract OSD is an optional host
fallback, used only when ``pytesseract`` is installed (found by
``importlib.util.find_spec``). The package keeps no ``try``: reading and
writing the image are held (``utils/errors.py``) and logged as the JAX
stage logs a failed rotation; a failure on the card stops the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os
import shutil
import time
from typing import List, Optional

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.io.images import (
    load_image_bgr,
    save_image_bgr,
    validate_image,
)
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker
from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.ops.image import rotate_bound
from multimodal_embeddings_tpu_torch.ops.skew import detect_skew
from multimodal_embeddings_tpu_torch.utils.errors import Held

logger = get_logger("orientation")


def detect_skew_tesseract(image_path: str) -> Optional[float]:
    """Optional Tesseract OSD fallback (``0_orientation.py:98-129``).
    Returns None when pytesseract/tesseract are unavailable."""
    if importlib.util.find_spec("pytesseract") is None:
        return None
    import pytesseract
    from PIL import Image
    from pytesseract import Output

    angle = None
    with contextlib.suppress(Exception):
        results = pytesseract.image_to_osd(
            np.asarray(Image.open(image_path).convert("RGB")), output_type=Output.DICT
        )
        angle = float(results["rotate"])
    return angle


@dataclasses.dataclass
class OrientationResult:
    image_path: str
    output_path: str
    angle: Optional[float]
    rotated: bool


class OrientationCorrector:
    """Per-image deskew with the reference's decision ladder, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        output_folder: Optional[str] = None,
        sensitivity_threshold: float = 0.5,
        advanced_detection: bool = True,
        use_tesseract_fallback: bool = True,
        device="cuda",
    ):
        self.output_folder = output_folder
        self.sensitivity_threshold = sensitivity_threshold
        self.advanced_detection = advanced_detection
        self.use_tesseract_fallback = use_tesseract_fallback
        self.device = resolve_device(device)
        if output_folder:
            os.makedirs(output_folder, exist_ok=True)

    def detect(self, image_path: str) -> Optional[float]:
        angle = None
        if self.advanced_detection:
            image = load_image_bgr(image_path)
            if image is not None:
                angle = detect_skew(image[:, :, ::-1], device=self.device)
        if angle is None and self.use_tesseract_fallback:
            angle = detect_skew_tesseract(image_path)
        return angle

    def rotate(self, image_path: str, output_path: str, angle: float) -> Optional[Exception]:
        """Rotate the image by ``angle`` on the card and save it; returns
        what reading or writing it raised (None on success)."""
        with Held() as read:
            pixels = torch.from_numpy(load_image_bgr(image_path))
        if read.error is not None:
            return read.error
        with torch.inference_mode():
            rotated = rotate_bound(pixels.to(self.device), angle).cpu().numpy()
        rotated = np.clip(rotated, 0, 255).astype(np.uint8)
        with Held() as write:
            save_image_bgr(output_path, rotated)
        return write.error

    def correct_orientation(self, image_path: str) -> OrientationResult:
        output_path = image_path
        if self.output_folder:
            output_path = os.path.join(
                self.output_folder, os.path.basename(image_path)
            )

        if not validate_image(image_path):
            logger.error("invalid image: %s", image_path)
            return OrientationResult(image_path, image_path, None, False)

        angle = self.detect(image_path)

        def copy_through():
            if self.output_folder and output_path != image_path:
                shutil.copy2(image_path, output_path)

        if angle is None:
            logger.info("no significant skew: %s", os.path.basename(image_path))
            copy_through()
            return OrientationResult(image_path, output_path, None, False)

        if abs(angle) < self.sensitivity_threshold:
            logger.info(
                "skew %.3f° below threshold %.3f°: %s",
                angle,
                self.sensitivity_threshold,
                os.path.basename(image_path),
            )
            copy_through()
            return OrientationResult(image_path, output_path, angle, False)

        error = self.rotate(image_path, output_path, angle)
        if error is None:
            logger.info(
                "corrected %s by %.3f°", os.path.basename(image_path), angle
            )
            return OrientationResult(image_path, output_path, angle, True)
        logger.error("rotation failed for %s: %s", image_path, error)
        copy_through()
        return OrientationResult(image_path, output_path, angle, False)


def batch_correct_orientation(
    image_paths: List[str],
    output_folder: Optional[str],
    sensitivity_threshold: float = 0.5,
    advanced_detection: bool = True,
    progress: Optional[ProgressTracker] = None,
    device="cuda",
) -> List[OrientationResult]:
    """Batch driver with resume support (``0_orientation.py:283-324``,
    progress integration as in ``orientation_corrector.py:203-212``)."""
    corrector = OrientationCorrector(
        output_folder=output_folder,
        sensitivity_threshold=sensitivity_threshold,
        advanced_detection=advanced_detection,
        device=device,
    )
    results = []
    start = time.time()
    for i, path in enumerate(image_paths):
        if progress is not None and progress.is_completed(path):
            logger.info("skipping completed: %s", os.path.basename(path))
            continue
        results.append(corrector.correct_orientation(path))
        if progress is not None:
            progress.mark_completed(path)
        if (i + 1) % 10 == 0 or i + 1 == len(image_paths):
            logger.info("orientation progress: %d/%d", i + 1, len(image_paths))
    elapsed = time.time() - start
    logger.info(
        "orientation batch done: %d images in %.1fs (%.2f img/s)",
        len(results),
        elapsed,
        len(results) / elapsed if elapsed > 0 else 0.0,
    )
    return results
