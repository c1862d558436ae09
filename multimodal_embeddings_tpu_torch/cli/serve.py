"""Serving CLI: continuous page ingestion through the page program.

Port of ``multimodal_embeddings_tpu/cli/serve.py`` with the same flags,
store and progress file. Every new page in the input folder runs through
the page program (detect over the full page and the grid views, letterboxed
unless ``--squeeze_views``, then the top ``--num_regions`` regions cropped
and embedded), and its region embeddings and a whole-page embedding are
upserted into the store at ``--db_path``; ``serve_progress.json`` there
marks each page done. ``--device`` (default ``cuda``) picks the device;
``--detector_weights`` and ``--embedder_weights`` read the JAX package's
``.npz`` checkpoints through the weight bridge, and without them the models
run seeded random weights.

    python -m multimodal_embeddings_tpu_torch.cli.serve --input_folder pages \\
        --db_path db --device cpu --imgsz 64 --variant n --grid_configs "" \\
        --num_regions 4 --embedder_size tiny

Pages are padded (bottom/right) to the smallest enclosing shape bucket, and
one page program is built per bucket. Ingest is a 3-stage pipeline: the
prefetch thread decodes page N+1 (``_prepare``) while the card runs page N
(``_submit``: CUDA launches return before the kernels finish) and the main
thread finalizes page N−1 (``_finalize``: boxes to page coordinates,
upserts, the whole-page embedding). ``--no_prefetch`` runs the stages in
sequence, the A/B reference.

The package keeps no ``try``: a page that cannot be opened or decoded fails
in ``_prepare``, on a worker thread whose future holds the error, and is
logged and skipped; a failure on the device or in the store stops the run.
``--data_parallel`` and ``--model_parallel`` above 1 are not ported and exit
with a message.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig, ID_TO_NAMES
from multimodal_embeddings_tpu_torch.io.images import get_image_paths, load_image_rgb
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.prefetch import Prefetcher
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker
from multimodal_embeddings_tpu_torch.pipeline.regions import region_metadata

logger = get_logger("cli.serve")

# shape buckets: pages are padded (bottom/right) up to the enclosing bucket
DEFAULT_BUCKETS = ((1600, 1200), (2400, 1800), (3600, 2800), (8000, 8000))


def bucket_for(h: int, w: int, buckets) -> Tuple[int, int]:
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return buckets[-1]


class FusedServer:
    def __init__(self, args):
        from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
        from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
        from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
        from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
        from multimodal_embeddings_tpu_torch.models.weights import resolve_device
        from multimodal_embeddings_tpu_torch.pipeline.regions import ImageProcessor
        from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

        if args.data_parallel > 1 or args.model_parallel > 1:
            raise SystemExit(
                "--data_parallel and --model_parallel above 1 are not ported: the port "
                "serves on one device"
            )
        self.args = args
        self.device = resolve_device(args.device)
        det_cfg = DetectorConfig(
            image_size=args.imgsz,
            variant=args.variant,
            weights_path=args.detector_weights,
            grid_configs=tuple(
                tuple(int(v) for v in g.split("x"))
                for g in args.grid_configs.split(",")
                if g
            ),
        )
        self.detector = LayoutDetector(det_cfg, dtype=torch.bfloat16, device=self.device)
        if args.embedder_size == "tiny":
            model_config = (MllamaConfig.tiny() if args.embedder_family == "mme5"
                            else DualEncoderConfig.tiny())
        else:
            model_config = None
        self.embedder = MultimodalEmbedder(
            EmbedderConfig(
                family=args.embedder_family,
                weights_path=args.embedder_weights,
                quantize=args.quantize,
            ),
            model_config=model_config,
            device=self.device,
        )
        _, self.collection = initialize_db(args.db_path, device=self.device)
        self._image_processor = ImageProcessor(self.embedder, self.collection)
        self.progress = ProgressTracker(os.path.join(args.db_path, "serve_progress.json"))
        self._page_fns: Dict[Tuple[int, int], object] = {}

    def _embed_chunk(self) -> int:
        """mme5 region-embed chunk: the int8 11B vision attention's
        transient bounds the chunk to 2; bf16 runs 8; tiny test configs take
        the whole batch."""
        if self.args.embedder_size == "tiny":
            cap = self.args.num_regions
        elif self.embedder.model_config.quantize:
            cap = 2
        else:
            cap = 8
        return max(c for c in range(1, cap + 1) if self.args.num_regions % c == 0)

    def _fn_for_bucket(self, bucket: Tuple[int, int]):
        if bucket not in self._page_fns:
            from multimodal_embeddings_tpu_torch.pipeline.fused import (
                build_fused_page_fn,
                build_split_page_fn,
            )

            logger.info("building the page program for bucket %s", bucket)
            letterbox = not self.args.squeeze_views
            if self.embedder.config.family == "mme5" and self.args.embedder_size != "tiny":
                self._page_fns[bucket] = build_split_page_fn(
                    self.detector, self.embedder, bucket,
                    num_regions=self.args.num_regions,
                    embed_chunk=self._embed_chunk(),
                    letterbox=letterbox,
                )
            else:
                self._page_fns[bucket] = build_fused_page_fn(
                    self.detector, self.embedder, bucket,
                    num_regions=self.args.num_regions,
                    letterbox=letterbox,
                )
        return self._page_fns[bucket]

    def _prepare(self, path: str):
        """Host stage 1: decode + downscale + bucket + pad (thread-safe;
        runs ahead of device execution on the prefetch thread)."""
        image = load_image_rgb(path)
        h, w = image.shape[:2]
        # pages larger than the biggest bucket are downscaled to fit;
        # detections are scaled back to original page coordinates in
        # _finalize
        max_h, max_w = DEFAULT_BUCKETS[-1]
        scale = 1.0
        if h > max_h or w > max_w:
            scale = min(max_h / h, max_w / w)
            from PIL import Image

            resized = Image.fromarray(image).resize(
                (max(1, int(w * scale)), max(1, int(h * scale))), Image.LANCZOS
            )
            image = np.asarray(resized)
            h, w = image.shape[:2]
        bucket = bucket_for(h, w, DEFAULT_BUCKETS)
        padded = np.zeros((*bucket, 3), np.uint8)
        padded[:h, :w] = image
        return padded, bucket, scale, h, w

    def _submit(self, prepared):
        """Device stage: launch the page program (asynchronous on the card:
        returns device tensors before the kernels finish)."""
        padded, bucket, _, _, _ = prepared
        return self._fn_for_bucket(bucket)(torch.from_numpy(padded).to(self.device))

    def _finalize(self, path: str, prepared, result) -> int:
        """Host stage 2: fetch results, map coordinates, upsert."""
        _, _, scale, h, w = prepared
        boxes = result.boxes.cpu().numpy().astype(np.float64)
        scores = result.scores.cpu().numpy().astype(np.float64)
        classes = result.classes.cpu().numpy()
        valid = result.valid.cpu().numpy()
        embeddings = result.embeddings.cpu().numpy().astype(np.float64)

        stem = os.path.splitext(os.path.basename(path))[0]
        orig_w = int(round(w / scale))
        orig_h = int(round(h / scale))
        ids, embs, metas = [], [], []
        for i in range(len(boxes)):
            if not valid[i]:
                continue
            # clip padded-region artifacts, then map back to original coords
            box = np.clip(boxes[i], [0, 0, 0, 0], [w, h, w, h]) / scale
            if box[2] - box[0] < 2 or box[3] - box[1] < 2:
                continue
            class_name = ID_TO_NAMES[int(classes[i]) % len(ID_TO_NAMES)]
            ids.append(f"region_{stem}_{i}")
            embs.append(embeddings[i].tolist())
            metas.append(
                region_metadata(
                    path, i, box.tolist(), float(classes[i]), class_name,
                    float(scores[i]), orig_w, orig_h,
                )
            )
        if ids:
            self.collection.upsert(ids=ids, embeddings=embs, metadatas=metas)
        # whole-page embedding (is_region: False) for page-level analysis;
        # ImageProcessor gives the schema and the store-existence dedup
        self._image_processor.process_image(path)
        self.progress.mark_completed(path)
        return len(ids)

    def process_page(self, path: str) -> int:
        """Sequential single-page path (decode → execute → finalize)."""
        prepared = self._prepare(path)
        return self._finalize(path, prepared, self._submit(prepared))

    def _log_rate(self, n_pages: int, start: float, mode: str) -> None:
        if n_pages:
            elapsed = time.perf_counter() - start
            logger.info("ingested %d pages in %.2fs (%.2f pages/s%s)",
                        n_pages, elapsed, n_pages / elapsed, mode)

    def run_once(self) -> int:
        """Ingest the pending pages; returns how many were attempted. A page
        whose decode fails is logged and skipped; the rest are served. The
        pipelined run gives the store the sequential per-page loop gives."""
        paths = [
            p for p in get_image_paths(self.args.input_folder)
            if not self.progress.is_completed(p)
        ]
        start = time.perf_counter()
        if self.args.no_prefetch:
            # sequential A/B reference: each decode runs on a worker thread
            # (whose future holds a decode error) and is waited for
            with ThreadPoolExecutor(max_workers=1) as pool:
                for path in paths:
                    future = pool.submit(self._prepare, path)
                    if future.exception() is not None:
                        logger.error("failed on %s: %s", path, future.exception())
                        continue
                    prepared = future.result()
                    self._finalize_logged(path, prepared, self._submit(prepared))
            self._log_rate(len(paths), start, ", sequential")
            return len(paths)

        inflight = None  # (path, prepared, launched result)
        with Prefetcher(paths, self._prepare, depth=2) as prefetcher:
            for path, prepared, error in iter(prefetcher.next_entry, None):
                if error is not None:
                    logger.error("failed on %s: %s", error.item, error.cause)
                    continue
                result = self._submit(prepared)
                # finalize the previous page while the card runs this one
                if inflight is not None:
                    self._finalize_logged(*inflight)
                inflight = (path, prepared, result)
        if inflight is not None:
            self._finalize_logged(*inflight)
        self._log_rate(len(paths), start, "")
        return len(paths)

    def _finalize_logged(self, path: str, prepared, result) -> int:
        n = self._finalize(path, prepared, result)
        logger.info("served %s: %d regions", os.path.basename(path), n)
        return n


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Serve pages through the page program")
    parser.add_argument("--input_folder", default="newspaper_images")
    parser.add_argument("--db_path", default="db")
    parser.add_argument("--imgsz", type=int, default=1024)
    parser.add_argument("--variant", default="m", choices=list("nsmblx"))
    parser.add_argument("--grid_configs", default="2x2,3x3,4x4")
    parser.add_argument("--num_regions", type=int, default=48)
    parser.add_argument("--embedder_family", choices=["siglip", "mme5"], default="siglip")
    parser.add_argument("--embedder_size", choices=["tiny", "base"], default="base")
    parser.add_argument("--detector_weights", default=None, help="JAX package .npz checkpoint")
    parser.add_argument("--embedder_weights", default=None, help="JAX package .npz checkpoint")
    parser.add_argument(
        "--quantize",
        nargs="?",
        const="int8-mixed",
        default=False,
        choices=["int8", "int4", "int8-mixed", "int4-mixed"],
        help="weight-only quantized mme5 embedder (models/quantized.py). Bare "
        "--quantize = int8-mixed (bf16 vision + int8 text); --quantize int4 "
        "packs two weights per byte (group-128 scales)",
    )
    parser.add_argument(
        "--squeeze_views",
        action="store_true",
        help="aspect-squeeze view resize instead of the default letterbox",
    )
    parser.add_argument("--data_parallel", type=int, default=1, help="not ported")
    parser.add_argument("--model_parallel", type=int, default=1, help="not ported")
    parser.add_argument(
        "--no_prefetch",
        action="store_true",
        help="disable the 3-stage ingest pipeline (sequential decode → "
        "execute → upsert); the A/B reference for the pipeline win",
    )
    parser.add_argument("--watch", action="store_true", help="poll for new pages")
    parser.add_argument("--poll_interval", type=float, default=5.0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    server = FusedServer(args)
    server.run_once()
    while args.watch:
        time.sleep(args.poll_interval)
        server.run_once()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
