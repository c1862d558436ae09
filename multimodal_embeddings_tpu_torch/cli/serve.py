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

``--data_parallel N`` and ``--model_parallel M`` serve on a (N, M) mesh of
ranks (``core/mesh.py``), one process and one card a rank: ``main`` spawns
the N·M ranks itself (``core/mesh.py::launch``: NCCL on the cards, gloo
ranks under ``--device cpu``), or, started by a launcher that set
``RANK``/``WORLD_SIZE`` (``torchrun --nproc_per_node N·M``), joins that
world as its rank. Pages are grouped by shape bucket into batches of N, each
rank running its page of a batch through the batch program
(``build_split_batch_fn`` for mme5, ``build_fused_batch_fn`` for siglip;
a partial group is padded by repeating its first page, whose results are
dropped), and the mme5 tree is tensor-sharded over the M ranks of the
model axis (``MultimodalEmbedder(mesh=)``). Rank 0 alone reads and marks
the progress file, writes the store and logs; every rank decodes every page
of the run (the host work is repeated, not sent), and under M > 1 every
rank also keeps an unwritten copy of the store so that the collective
whole-page embedding runs on every rank in step. The store, the progress
file and the logs are those of a single-device run. A rank that fails
fails the run: ``launch`` raises and the CLI exits non-zero.

    python -m multimodal_embeddings_tpu_torch.cli.serve --input_folder pages \\
        --db_path db --device cpu --imgsz 64 --variant n --grid_configs "" \\
        --num_regions 4 --embedder_size tiny --embedder_family mme5 \\
        --data_parallel 2 --model_parallel 2
"""

from __future__ import annotations

import argparse
import importlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodal_embeddings_tpu_torch.config import (
    DetectorConfig,
    EmbedderConfig,
    ID_TO_NAMES,
    MeshConfig,
)
from multimodal_embeddings_tpu_torch.io.images import get_image_paths, load_image_rgb
from multimodal_embeddings_tpu_torch.core.mesh import (
    launch,
    make_mesh,
    quiet_other_ranks,
    rank_device,
    visible_devices,
    world,
)
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.prefetch import Prefetcher
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker
from multimodal_embeddings_tpu_torch.models.weights import resolve_device
from multimodal_embeddings_tpu_torch.pipeline.fused import PageResult
from multimodal_embeddings_tpu_torch.pipeline.regions import region_metadata
from multimodal_embeddings_tpu_torch.store.embedding_store import (
    DEFAULT_COLLECTION,
    HNSW_COMPAT_METADATA,
    Collection,
    initialize_db,
)

logger = get_logger("cli.serve")

# shape buckets: pages are padded (bottom/right) up to the enclosing bucket
DEFAULT_BUCKETS = ((1600, 1200), (2400, 1800), (3600, 2800), (8000, 8000))


def bucket_for(h: int, w: int, buckets) -> Tuple[int, int]:
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            return bh, bw
    return buckets[-1]


def check_scaleout(args) -> None:
    """JAX's refusals of a serving mesh, with JAX's words."""
    dp, mp = args.data_parallel, args.model_parallel
    need = dp * mp
    have = visible_devices(args.device)
    if have < need:
        raise SystemExit(
            f"--data_parallel {dp} x --model_parallel {mp} needs "
            f"{need} devices; only {have} visible"
        )
    if mp > 1 and args.embedder_family != "mme5":
        raise SystemExit(
            "--model_parallel tensor-shards the parity (mme5) "
            "embedder; the siglip tower fits one chip — scale it "
            "with --data_parallel"
        )
    if mp > 1 and args.quantize:
        raise SystemExit(
            "--model_parallel serves the bf16 tree; the int8 path "
            "is single-chip (drop --quantize, or use "
            "--data_parallel alone)"
        )


class _MirrorCollection(Collection):
    """A rank's copy of rank 0's store under tensor parallelism: the same
    upserts in the same order, in memory only, so that its dedup of the
    whole-page embedding (a collective call) decides as rank 0's does."""

    def persist(self) -> None:
        pass


class FusedServer:
    def __init__(self, args):
        from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector
        from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
        from multimodal_embeddings_tpu_torch.models.mme5 import MllamaConfig
        from multimodal_embeddings_tpu_torch.models.vision_encoder import DualEncoderConfig
        from multimodal_embeddings_tpu_torch.pipeline.regions import ImageProcessor

        self.args = args
        self.mesh = None
        self.rank = world()[0]
        dp, mp = args.data_parallel, args.model_parallel
        if dp > 1 or mp > 1:
            # the serving mesh. Data axis: a page batch sharded one page per
            # data rank (the reference's round-robin GPUs, embedder.py:
            # 190-224; the split batch for mme5, the fused batch for siglip).
            # Model axis: the parity embedder tensor-sharded by the
            # Megatron-style rules (parallel/sharding.py)
            check_scaleout(args)
            if world()[1] != dp * mp:
                raise RuntimeError(
                    f"a (data {dp}, model {mp}) mesh needs a world of {dp * mp} ranks, "
                    f"this one has {world()[1]}: run main(), which spawns them, or "
                    "start one process a rank under a launcher"
                )
            self.mesh = make_mesh(MeshConfig(shape=(dp, mp)))
        self.device = resolve_device(args.device) if self.mesh is None \
            else rank_device(args.device)
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
            # tensor parallelism shards the embedder tree at load; dp-only
            # meshes keep a whole tree on every rank
            mesh=self.mesh if mp > 1 else None,
        )
        if self.rank == 0:
            _, self.collection = initialize_db(args.db_path, device=self.device)
        else:
            self.collection = _MirrorCollection(args.db_path, DEFAULT_COLLECTION,
                                                HNSW_COMPAT_METADATA, device=self.device)
        # every rank finalizes where the whole-page embedding is collective
        # (a model-sharded embedder); else rank 0 alone
        self._finalizes = self.rank == 0 or self.embedder.mesh is not None
        self._image_processor = ImageProcessor(self.embedder, self.collection)
        self.progress = ProgressTracker(os.path.join(args.db_path, "serve_progress.json"))
        self._page_fns: Dict[Tuple[int, int], object] = {}
        self._batch_fns: Dict[Tuple[int, int], object] = {}

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
        if not self._finalizes:
            return 0
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
        if self.rank == 0:
            self.progress.mark_completed(path)
        return len(ids)

    def _batch_fn_for_bucket(self, bucket: Tuple[int, int]):
        if bucket not in self._batch_fns:
            from multimodal_embeddings_tpu_torch.pipeline.fused import (
                build_fused_batch_fn,
                build_split_batch_fn,
            )

            logger.info("building the dp=%d batch program(s) for bucket %s",
                        self.args.data_parallel, bucket)
            letterbox = not self.args.squeeze_views
            if self.embedder.config.family == "mme5":
                # parity embedder: the detect batch + embed chunks, one page
                # per rank over the data axis
                self._batch_fns[bucket] = build_split_batch_fn(
                    self.detector, self.embedder, bucket,
                    num_regions=self.args.num_regions,
                    embed_chunk=self._embed_chunk(),
                    letterbox=letterbox,
                    mesh=self.mesh,
                )
            else:
                self._batch_fns[bucket] = build_fused_batch_fn(
                    self.detector, self.embedder, bucket,
                    num_regions=self.args.num_regions,
                    mesh=self.mesh,
                    letterbox=letterbox,
                )
        return self._batch_fns[bucket]

    def _run_batched(self, paths) -> int:
        """Data-parallel ingest: pages grouped by shape bucket into batches
        of ``data_parallel``, each batch one call of the batch program over
        the mesh's data axis; the last partial group is padded by repeating
        its first page (clone results are discarded). Every rank decodes the
        same pages, so every rank forms the same batches."""
        n = self.args.data_parallel
        total = 0
        queues: Dict[Tuple[int, int], list] = {}

        def flush(bucket) -> None:
            nonlocal total
            entries = queues.pop(bucket, [])
            if not entries:
                return
            padded_batch = np.stack(
                [prep[0] for _, prep in entries]
                + [entries[0][1][0]] * (n - len(entries))
            )
            result = self._batch_fn_for_bucket(bucket)(padded_batch)
            for b, (path, prep) in enumerate(entries):
                cnt = self._finalize(path, prep, PageResult(*(x[b] for x in result)))
                total += cnt
                logger.info("served %s: %d regions (dp batch)", os.path.basename(path), cnt)

        with Prefetcher(paths, self._prepare, depth=2) as prefetcher:
            for path, prepared, error in iter(prefetcher.next_entry, None):
                if error is not None:
                    logger.error("failed on %s: %s", error.item, error.cause)
                    continue
                bucket = prepared[1]
                queues.setdefault(bucket, []).append((path, prepared))
                if len(queues[bucket]) == n:
                    flush(bucket)
        for bucket in list(queues):
            flush(bucket)
        return total

    def process_page(self, path: str) -> int:
        """Sequential single-page path (decode → execute → finalize).

        On a mesh the page runs through the batch program (a TP-sharded
        embedder serves only over its mesh); the data axis is padded by
        repeating the page and clone results are discarded."""
        prepared = self._prepare(path)
        if self.mesh is not None:
            fn = self._batch_fn_for_bucket(prepared[1])
            batch = np.stack([prepared[0]] * self.args.data_parallel)
            result = PageResult(*(x[0] for x in fn(batch)))
            return self._finalize(path, prepared, result)
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
        if self.mesh is not None:
            box = [paths]
            dist.broadcast_object_list(box, src=0)  # rank 0's list on every rank
            paths = box[0]
            self._run_batched(paths)
            self._log_rate(len(paths), start, f", dp={self.args.data_parallel} "
                                              f"tp={self.args.model_parallel}")
            return len(paths)
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
    parser.add_argument(
        "--data_parallel",
        type=int,
        default=1,
        help="shard page batches of this size over the mesh data axis "
        "(multi-chip serving; pages grouped by shape bucket)",
    )
    parser.add_argument(
        "--model_parallel",
        type=int,
        default=1,
        help="tensor-shard the parity (mme5) embedder over this many chips "
        "per page (Megatron-style logical-axis rules; serves weight trees "
        "one chip can't hold, e.g. bf16 11B at tp=2); composes with "
        "--data_parallel on a (dp, tp) mesh",
    )
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


def serve(args) -> int:
    """Build the server and ingest (with ``--watch``, forever); on a rank
    other than 0 the port's loggers are silenced (rank 0 logs what JAX's
    single controller logs)."""
    quiet_other_ranks()
    server = FusedServer(args)
    server.run_once()
    while args.watch:
        time.sleep(args.poll_interval)
        server.run_once()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    ranks = args.data_parallel * args.model_parallel
    if ranks > 1 and not dist.is_initialized():
        check_scaleout(args)
        # by its importable name, which a spawned rank unpickles
        module = importlib.import_module("multimodal_embeddings_tpu_torch.cli.serve")
        return launch(module.serve, ranks, args, device=args.device, timeout=None)[0]
    return serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
