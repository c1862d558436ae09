"""Stage 1 — DocLayout detection with multi-grid tiling.

Port of ``multimodal_embeddings_tpu/pipeline/detect.py``. Emits the
reference's exact artifact layout (``1_doclayout_bboxes.py:446-654``):

* ``json/{base}.json`` — full-page regions dict
* ``visualizations/{base}_viz.jpg``
* per grid ``grid_{r}x{c}/{images,json,visualizations,visualizations_original_coords}``
  with per-cell images/JSON/viz
* ``json/{base}_grid_{r}x{c}.json`` — the grid-info JSON consumed by stages 2-3

Every view of a page (1 full + all grid cells) runs as ONE batched forward
on the card via ``LayoutDetector.detect_page_multigrid``.
``process_page`` and ``write_page_artifacts`` are copies of the JAX
functions (``tests/test_torch_pipeline.py`` holds the sources equal).
``run_detect_stage`` keeps JAX's three-stage pipeline (decode on
``io/prefetch.py``'s thread, the forward on the main thread, the artifacts
on one ordered writer thread) and its sequential form (``prefetch=False``).
The package keeps no ``try``: a page that cannot be decoded fails on the
prefetch worker, whose future holds the error, and the writer's future holds
an artifact error; both are logged and counted as JAX counts them. The
forward is never guarded: a failure on the card stops the run.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from multimodal_embeddings_tpu_torch.analysis import visualization as viz
from multimodal_embeddings_tpu_torch.config import DetectorConfig
from multimodal_embeddings_tpu_torch.io.images import (
    get_image_paths,
    load_image_bgr,
    load_image_rgb,
    save_image_bgr,
)
from multimodal_embeddings_tpu_torch.io.json_io import save_json
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.prefetch import Prefetcher
from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
from multimodal_embeddings_tpu_torch.pipeline.stages import StageStats
from multimodal_embeddings_tpu_torch.utils.errors import Held

logger = get_logger("detect")


def process_page(
    detector: LayoutDetector,
    image_path: str,
    output_folder: str,
    save_cell_images: bool = True,
    save_visualizations: bool = True,
    image: Optional[np.ndarray] = None,
    bgr: Optional[np.ndarray] = None,
) -> bool:
    """Detect one page (device) then write its artifact tree (host)."""
    full_regions, per_grid = detector.detect_page_multigrid(image_path, image=image)
    write_page_artifacts(
        image_path,
        output_folder,
        full_regions,
        per_grid,
        overlap_percentage=detector.config.overlap_percentage,
        save_cell_images=save_cell_images,
        save_visualizations=save_visualizations,
        bgr=bgr,
    )
    return True


def write_page_artifacts(
    image_path: str,
    output_folder: str,
    full_regions: dict,
    per_grid,
    overlap_percentage: float,
    save_cell_images: bool = True,
    save_visualizations: bool = True,
    bgr: Optional[np.ndarray] = None,
) -> bool:
    """Pure-host artifact writer for one detected page (JSONs, cell
    images, visualizations) — split from the device detect so the
    pipelined stage driver can overlap it with the next page's forward."""
    base, ext = os.path.splitext(os.path.basename(image_path))
    json_folder = os.path.join(output_folder, "json")
    viz_folder = os.path.join(output_folder, "visualizations")
    os.makedirs(json_folder, exist_ok=True)
    os.makedirs(viz_folder, exist_ok=True)

    save_json(full_regions, os.path.join(json_folder, f"{base}.json"))
    if save_visualizations:
        viz.visualize_regions(
            image_path, full_regions, os.path.join(viz_folder, f"{base}_viz.jpg")
        )

    if save_cell_images:
        bgr = bgr if bgr is not None else load_image_bgr(image_path)
    else:
        bgr = None

    for (rows, cols), cells, cell_regions in per_grid:
        grid_folder = os.path.join(output_folder, f"grid_{rows}x{cols}")
        g_images = os.path.join(grid_folder, "images")
        g_json = os.path.join(grid_folder, "json")
        g_viz = os.path.join(grid_folder, "visualizations")
        g_viz_orig = os.path.join(grid_folder, "visualizations_original_coords")
        for d in (g_images, g_json, g_viz, g_viz_orig):
            os.makedirs(d, exist_ok=True)

        grid_info = {
            "original_image_path": image_path,
            "grid_config": {
                "rows": rows,
                "cols": cols,
                "overlap_percentage": overlap_percentage,
            },
            "cells": [],
        }

        for cell, regions in zip(cells, cell_regions):
            cell_name = f"{base}_row{cell.row}_col{cell.col}{ext}"
            cell_path = os.path.join(g_images, cell_name)
            cell_json_path = os.path.join(g_json, cell_name.replace(ext, ".json"))

            if save_cell_images and bgr is not None:
                x0, y0, x1, y1 = cell.slice_bounds
                save_image_bgr(cell_path, bgr[y0:y1, x0:x1])

            regions = dict(regions)
            regions["image_path"] = cell_path
            save_json(regions, cell_json_path)

            if save_visualizations and save_cell_images and os.path.exists(cell_path):
                viz.visualize_regions(
                    cell_path,
                    regions,
                    os.path.join(g_viz, cell_name.replace(ext, "_viz.jpg")),
                )
                viz.visualize_regions(
                    image_path,
                    regions,
                    os.path.join(
                        g_viz_orig, cell_name.replace(ext, "_original_viz.jpg")
                    ),
                    use_original_coords=True,
                )

            grid_info["cells"].append(
                {
                    "cell_path": cell_path,
                    "cell_json_path": cell_json_path,
                    "cell_coordinates": cell.coordinates,
                    "row": cell.row,
                    "col": cell.col,
                    "regions": {
                        "boxes": regions["boxes"],
                        "boxes_original": regions["boxes_original"],
                        "classes": regions["classes"],
                        "scores": regions["scores"],
                        "class_names": regions["class_names"],
                    },
                }
            )

        if grid_info["cells"]:
            save_json(
                grid_info,
                os.path.join(json_folder, f"{base}_grid_{rows}x{cols}.json"),
            )
    return True


def run_detect_stage(
    input_folder: str,
    output_folder: str,
    config: DetectorConfig = DetectorConfig(),
    detector: Optional[LayoutDetector] = None,
    save_cell_images: bool = True,
    save_visualizations: bool = True,
    skip_errors: bool = True,
    prefetch: bool = True,
    device="cuda",
) -> StageStats:
    """Stage-1 batch driver; builds ``LayoutDetector(config)`` on ``device``
    unless a detector is given."""
    stats = StageStats()
    paths = get_image_paths(input_folder)
    if not paths:
        logger.error("no images in %s", input_folder)
        return stats
    if detector is None:
        detector = LayoutDetector(config, device=device)

    def decode(path: str):
        """Host decode for page N+1 runs on the prefetch thread while the
        device detects page N (same functions as the in-line path, so
        artifacts are byte-identical — test-locked)."""
        rgb = load_image_rgb(path)
        page_bgr = load_image_bgr(path) if save_cell_images else None
        return rgb, page_bgr

    def write(path: str, full_regions, per_grid, page_bgr) -> None:
        write_page_artifacts(
            path,
            output_folder,
            full_regions,
            per_grid,
            overlap_percentage=detector.config.overlap_percentage,
            save_cell_images=save_cell_images,
            save_visualizations=save_visualizations,
            bgr=page_bgr,
        )

    def note(path: str, error: Optional[BaseException]) -> None:
        """Count one page (continue-on-error contract)."""
        if error is None:
            stats.processed += 1
            logger.info("detected %s", os.path.basename(path))
            return
        stats.errors += 1
        logger.error("stage1 failed on %s: %s", os.path.basename(path), error)
        if not skip_errors:
            raise error

    if not prefetch:
        for path in paths:
            with Held() as held:
                rgb, page_bgr = decode(path)
            if held.error is None:
                full_regions, per_grid = detector.detect_page_multigrid(path, image=rgb)
                with Held() as held:
                    write(path, full_regions, per_grid, page_bgr)
            note(path, held.error)
        return stats

    # 3-stage pipeline: the prefetch thread decodes page N+1, the main
    # thread runs page N's device forward, and the single writer thread
    # (ordered) emits page N-1's JSON/viz artifact tree. Depth bounded at
    # 2 pending writes so at most ~3 decoded pages are resident.
    pending = collections.deque()  # (path, future)
    with Prefetcher(paths, decode, depth=2) as prefetcher, \
            ThreadPoolExecutor(max_workers=1) as writer:
        while (entry := prefetcher.next_entry()) is not None:
            path, decoded, error = entry
            if error is not None:
                # the sequential path's contract: callers see the original
                # decode exception type, not the wrapper
                note(path, error.cause)
                continue
            rgb, page_bgr = decoded
            full_regions, per_grid = detector.detect_page_multigrid(path, image=rgb)
            pending.append(
                (path, writer.submit(write, path, full_regions, per_grid, page_bgr))
            )
            while len(pending) > 2:
                dpath, fut = pending.popleft()
                note(dpath, fut.exception())
        while pending:
            dpath, fut = pending.popleft()
            note(dpath, fut.exception())
    return stats
