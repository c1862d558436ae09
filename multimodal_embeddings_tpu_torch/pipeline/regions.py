"""Whole-image and region embed-and-store processors.

Port of ``multimodal_embeddings_tpu/pipeline/regions.py`` (the reference's
``image_processor.py`` and ``region_processor.py``), with the same ids and
metadata: region ids ``region_{image_stem}_{i}`` with fields
``{parent_image, parent_image_name, region_index, region_type,
region_class_id, region_score, box:"x1,y1,x2,y2", box_normalized,
area_percentage, width, height, is_region:True}``
(``region_processor.py:79,95-113``); whole images carry
``{image_name, image_path, processed_time, is_region:False}``
(``image_processor.py:203-208``). ``crop_box_with_padding`` and
``region_metadata`` are verbatim copies (``tests/test_torch_serve.py``).

The package keeps no ``try``: ``RegionProcessor.process_regions`` does not
catch a page's failure as the JAX loop does, so a page that fails stops the
loop with its error.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from multimodal_embeddings_tpu_torch.config import REGION_TYPES_TO_PROCESS
from multimodal_embeddings_tpu_torch.io.images import load_image_rgb
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker

logger = get_logger("regions")


def crop_box_with_padding(
    image: np.ndarray, box: Sequence[float], padding: int = 5
) -> np.ndarray:
    """Padded region crop clipped to the page
    (``doclayout_detector.py:165-194``)."""
    h, w = image.shape[:2]
    x1 = max(0, int(box[0]) - padding)
    y1 = max(0, int(box[1]) - padding)
    x2 = min(w, int(box[2]) + padding)
    y2 = min(h, int(box[3]) + padding)
    return image[y1:y2, x1:x2]


def region_metadata(
    image_path: str,
    index: int,
    box: Sequence[float],
    class_id: float,
    class_name: str,
    score: float,
    page_width: int,
    page_height: int,
) -> Dict:
    x1, y1, x2, y2 = (float(v) for v in box)
    area_pct = ((x2 - x1) * (y2 - y1)) / (page_width * page_height) * 100.0
    return {
        "parent_image": os.path.abspath(image_path),
        "parent_image_name": os.path.basename(image_path),
        "region_index": index,
        "region_type": class_name,
        "region_class_id": float(class_id),
        "region_score": float(score),
        "box": f"{x1},{y1},{x2},{y2}",
        "box_normalized": (
            f"{x1 / page_width},{y1 / page_height},"
            f"{x2 / page_width},{y2 / page_height}"
        ),
        "area_percentage": area_pct,
        "width": x2 - x1,
        "height": y2 - y1,
        "is_region": True,
    }


class RegionProcessor:
    """Detect → crop → embed → upsert per page (``region_processor.py:25-158``)."""

    def __init__(
        self,
        detector,
        embedder,
        collection,
        output_folder: str = "output",
        region_types: Sequence[str] = REGION_TYPES_TO_PROCESS,
        region_batch_size: int = 48,
        save_crops: bool = True,
        progress: Optional[ProgressTracker] = None,
    ):
        self.detector = detector
        self.embedder = embedder
        self.collection = collection
        self.output_folder = output_folder
        self.region_types = set(region_types)
        self.region_batch_size = region_batch_size
        self.save_crops = save_crops
        self.progress = progress
        self.region_images_folder = os.path.join(output_folder, "region_images")
        os.makedirs(self.region_images_folder, exist_ok=True)

    def process_image_regions(self, image_path: str) -> int:
        """Returns the number of regions stored for this page."""
        stem = os.path.splitext(os.path.basename(image_path))[0]
        if self.progress is not None and self.progress.is_completed(image_path):
            logger.info("regions already processed: %s", stem)
            return 0

        regions = self.detector.detect_regions(image_path)
        if not regions or not regions["boxes"]:
            logger.warning("no regions detected for %s", stem)
            if self.progress is not None:
                self.progress.mark_completed(image_path)
            return 0

        image = load_image_rgb(image_path)
        page_h, page_w = image.shape[:2]

        selected = [
            i
            for i, name in enumerate(regions["class_names"])
            if name in self.region_types
        ]
        if not selected:
            if self.progress is not None:
                self.progress.mark_completed(image_path)
            return 0

        ids, metadatas, crops = [], [], []
        for i in selected:
            box = regions["boxes"][i]
            crop = crop_box_with_padding(image, box)
            if crop.size == 0:
                continue
            name = regions["class_names"][i]
            ids.append(f"region_{stem}_{i}")
            metadatas.append(
                region_metadata(
                    image_path,
                    i,
                    box,
                    regions["classes"][i],
                    name,
                    regions["scores"][i],
                    page_w,
                    page_h,
                )
            )
            crops.append(crop)
            if self.save_crops:
                from PIL import Image

                Image.fromarray(crop).save(
                    os.path.join(
                        self.region_images_folder, f"{stem}_region{i}_{name}.png"
                    )
                )

        stored = 0
        for start in range(0, len(crops), self.region_batch_size):
            chunk_crops = crops[start : start + self.region_batch_size]
            chunk_ids = ids[start : start + self.region_batch_size]
            chunk_meta = metadatas[start : start + self.region_batch_size]
            embeddings = self.embedder.get_image_embeddings(
                chunk_crops, batch_size=self.region_batch_size
            )
            ok = [
                (i, e, m)
                for i, e, m in zip(chunk_ids, embeddings, chunk_meta)
                if e is not None
            ]
            if ok:
                self.collection.upsert(
                    ids=[x[0] for x in ok],
                    embeddings=[x[1] for x in ok],
                    metadatas=[x[2] for x in ok],
                )
                stored += len(ok)

        if self.progress is not None:
            self.progress.mark_completed(image_path)
        logger.info("stored %d regions for %s", stored, stem)
        return stored

    def process_regions(self, image_paths: Sequence[str]) -> int:
        total = 0
        for path in image_paths:
            total += self.process_image_regions(path)
        return total


class ImageProcessor:
    """Whole-page embed-and-store with three-level dedup
    (``image_processor.py:19-280``: progress tracker, DB existence check,
    recompute)."""

    def __init__(
        self,
        embedder,
        collection,
        progress: Optional[ProgressTracker] = None,
    ):
        self.embedder = embedder
        self.collection = collection
        self.progress = progress

    def process_image(self, image_path: str, force: bool = False) -> bool:
        image_name = os.path.basename(image_path)
        if not force:
            if self.progress is not None and self.progress.is_completed(image_path):
                return True
            existing = self.collection.get(ids=[image_name], include=("embeddings",))
            if existing["ids"] and existing.get("embeddings") and existing["embeddings"][0]:
                if self.progress is not None:
                    self.progress.mark_completed(image_path)
                return True

        embeddings = self.embedder.get_image_embeddings([image_path], batch_size=1)
        if embeddings[0] is None:
            logger.error("failed to embed %s", image_name)
            return False
        self.collection.upsert(
            ids=[image_name],
            embeddings=[embeddings[0]],
            metadatas=[
                {
                    "image_name": image_name,
                    "image_path": os.path.abspath(image_path),
                    "processed_time": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "is_region": False,
                }
            ],
        )
        if self.progress is not None:
            self.progress.mark_completed(image_path)
        return True

    def process_images(self, image_paths: Sequence[str], batch_size: int = 16) -> int:
        """Batched variant: embeds un-cached pages in chunks
        (``image_processor.py:116-280``)."""
        todo = []
        for path in image_paths:
            name = os.path.basename(path)
            if self.progress is not None and self.progress.is_completed(path):
                continue
            existing = self.collection.get(ids=[name], include=("embeddings",))
            if existing["ids"] and existing.get("embeddings") and existing["embeddings"][0]:
                if self.progress is not None:
                    self.progress.mark_completed(path)
                continue
            todo.append(path)

        done = 0
        for start in range(0, len(todo), batch_size):
            chunk = todo[start : start + batch_size]
            embeddings = self.embedder.get_image_embeddings(chunk, batch_size=batch_size)
            ids, embs, metas, completed = [], [], [], []
            for path, emb in zip(chunk, embeddings):
                if emb is None:
                    continue
                ids.append(os.path.basename(path))
                embs.append(emb)
                metas.append(
                    {
                        "image_name": os.path.basename(path),
                        "image_path": os.path.abspath(path),
                        "processed_time": time.strftime("%Y-%m-%d %H:%M:%S"),
                        "is_region": False,
                    }
                )
                completed.append(path)
            if ids:
                self.collection.upsert(ids=ids, embeddings=embs, metadatas=metas)
                if self.progress is not None:
                    self.progress.mark_many(completed)
                done += len(ids)
            logger.info(
                "whole-image embedding: %d/%d", min(start + batch_size, len(todo)), len(todo)
            )
        return done
