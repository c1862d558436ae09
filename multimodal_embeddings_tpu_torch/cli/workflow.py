"""Integrated workflow CLI — the ``complete_workflow.py`` equivalent (D16).

Port of ``multimodal_embeddings_tpu/cli/workflow.py`` with the same flags
plus ``--device`` (``cuda`` by default; asking for it where there is no
CUDA device raises). ``--stage {orient,detect,embed,cluster,all}`` with
``--reset`` (``complete_workflow.py:80-286``): single process, shared
detector/embedder/store, resume via progress trackers, region clustering +
HTML report at the end. Also runs demo queries and cross-comparisons on
request.

    python -m multimodal_embeddings_tpu_torch.cli.workflow --input_folder pages \\
        --stage all --run_cross_compare --run_region_compare --run_demo \\
        --demo_image pages/p0.png --device cpu --imgsz 64 --variant n \\
        --embedder_size tiny

As in JAX, ``cross_compare/``, ``region_compare/``, ``testout/`` and
``newspaper_process.log`` are written in the working directory, not under
``--output_folder``, and ``--reset`` removes the three folders there with
the store and the output folder. The detector, the embedder, the store and
the clustering pass run on ``--device``; ``--trace_dir`` writes a
``torch.profiler`` Chrome trace of the run (``utils/profiling.py::trace``).
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil

from multimodal_embeddings_tpu_torch.config import DetectorConfig, EmbedderConfig
from multimodal_embeddings_tpu_torch.io.images import get_image_paths
from multimodal_embeddings_tpu_torch.io.logging_setup import configure, get_logger
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = get_logger("cli.workflow")


def reset_workflow(db_path: str, output_folder: str, extra=("cross_compare", "region_compare", "testout")):
    """Wipe db/progress/output (``complete_workflow.py:44-78``, reset.sh)."""
    for target in (db_path, output_folder) + tuple(extra):
        if os.path.isdir(target):
            shutil.rmtree(target)
            logger.info("removed %s", target)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Integrated newspaper workflow")
    parser.add_argument("--input_folder", default="newspaper_images")
    parser.add_argument("--output_folder", default="output")
    parser.add_argument("--db_path", default="db")
    parser.add_argument(
        "--stage",
        choices=["orient", "detect", "embed", "cluster", "all"],
        default="all",
    )
    parser.add_argument("--reset", action="store_true")
    parser.add_argument("--diagnostic", action="store_true")
    parser.add_argument("--n-clusters", type=int, default=None)
    # reference complete_workflow.py:98 default (config's 0.3 constant is
    # the region_compare threshold, not this one)
    parser.add_argument("--similarity-threshold", type=float, default=0.1)
    parser.add_argument("--prefix-length", type=int, default=None)
    parser.add_argument("--embedder_family", choices=["siglip", "mme5"], default="siglip")
    parser.add_argument(
        "--embedder_size",
        choices=["tiny", "base"],
        default="base",
        help="dual-encoder scale (tiny = test/CI scale)",
    )
    parser.add_argument("--detector_weights", default=None)
    parser.add_argument("--embedder_weights", default=None)
    parser.add_argument("--variant", default="m", choices=list("nsmblx"))
    parser.add_argument("--imgsz", type=int, default=1024)
    parser.add_argument("--demo_image", default=None)
    parser.add_argument("--demo_text", default="Hoosier. Hockey.")
    parser.add_argument("--run_demo", action="store_true")
    parser.add_argument("--run_cross_compare", action="store_true")
    parser.add_argument("--run_region_compare", action="store_true")
    parser.add_argument(
        "--skip_orientation",
        action="store_true",
        help="skip deskew (reference ORIENTATION_CORRECTION_ENABLED=True default)",
    )
    parser.add_argument(
        "--correct_orientation",
        action="store_true",
        help="deprecated: orientation now runs by default; use "
        "--skip_orientation to disable",
    )
    parser.add_argument(
        "--trace_dir",
        default=None,
        help="write a torch.profiler Chrome trace of the run to this directory",
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    configure(
        log_file="newspaper_process.log",
        level=logging.DEBUG if args.diagnostic else logging.INFO,
    )
    from multimodal_embeddings_tpu_torch.utils.profiling import StageTimer, trace

    timer = StageTimer()
    with trace(args.trace_dir):
        return _run(args, timer)


def _run(args, timer) -> int:
    if args.reset:
        reset_workflow(args.db_path, args.output_folder)

    image_paths = get_image_paths(args.input_folder)
    if not image_paths:
        logger.error("no images in %s", args.input_folder)
        return 1
    logger.info("found %d images", len(image_paths))
    os.makedirs(args.output_folder, exist_ok=True)

    run = lambda stage: args.stage in ("all", stage)  # noqa: E731

    # --- stage: orient -----------------------------------------------------
    # Non-destructive: corrected copies go to output/oriented_images and
    # downstream stages consume them (complete_workflow.py:148-160); the
    # source scans are never overwritten.
    if run("orient") and not args.skip_orientation:
        from multimodal_embeddings_tpu_torch.pipeline.orientation import (
            batch_correct_orientation,
        )

        oriented_folder = os.path.join(args.output_folder, "oriented_images")
        progress = ProgressTracker(
            os.path.join(args.output_folder, "orientation_progress.json")
        )
        with timer.stage("orient", len(image_paths)):
            batch_correct_orientation(
                image_paths, oriented_folder, progress=progress, device=args.device
            )

    # Prefer oriented copies whenever they exist — also when this invocation
    # runs only a later stage after a previous `--stage orient` run, so
    # per-stage invocations see the same (corrected) inputs and the same
    # progress keys as a full `--stage all` run.
    oriented_folder = os.path.join(args.output_folder, "oriented_images")
    image_paths = [
        os.path.join(oriented_folder, os.path.basename(p))
        if os.path.exists(os.path.join(oriented_folder, os.path.basename(p)))
        else p
        for p in image_paths
    ]

    detector = embedder = collection = None

    def get_detector():
        nonlocal detector
        if detector is None:
            from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector

            detector = LayoutDetector(
                DetectorConfig(
                    image_size=args.imgsz,
                    variant=args.variant,
                    weights_path=args.detector_weights,
                ),
                cache_dir=os.path.join(args.output_folder, "region_cache"),
                device=args.device,
            )
        return detector

    def get_embedder():
        nonlocal embedder
        if embedder is None:
            from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
            from multimodal_embeddings_tpu_torch.models.vision_encoder import (
                DualEncoderConfig,
            )

            model_config = None
            if args.embedder_family == "siglip" and args.embedder_size == "tiny":
                model_config = DualEncoderConfig.tiny()
            embedder = MultimodalEmbedder(
                EmbedderConfig(
                    family=args.embedder_family, weights_path=args.embedder_weights
                ),
                model_config=model_config,
                device=args.device,
            )
        return embedder

    def get_collection():
        nonlocal collection
        if collection is None:
            from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

            _, collection = initialize_db(args.db_path, device=args.device)
        return collection

    # --- stage: detect -----------------------------------------------------
    if run("detect"):
        from multimodal_embeddings_tpu_torch.analysis.visualization import visualize_regions

        det = get_detector()
        viz_folder = os.path.join(args.output_folder, "region_visualizations")
        progress = ProgressTracker(
            os.path.join(args.output_folder, "region_detection_progress.json")
        )
        with timer.stage("detect", len(image_paths)):
            for path in image_paths:
                if progress.is_completed(path):
                    continue
                regions = det.detect_regions(path)
                if regions:
                    base = os.path.splitext(os.path.basename(path))[0]
                    visualize_regions(
                        path, regions, os.path.join(viz_folder, f"{base}_regions.jpg")
                    )
                progress.mark_completed(path)

    # --- stage: embed ------------------------------------------------------
    if run("embed"):
        from multimodal_embeddings_tpu_torch.pipeline.regions import (
            ImageProcessor,
            RegionProcessor,
        )

        col = get_collection()
        emb = get_embedder()
        image_progress = ProgressTracker(
            os.path.join(args.output_folder, "processed_images_progress.json")
        )
        with timer.stage("embed_pages", len(image_paths)):
            ImageProcessor(emb, col, progress=image_progress).process_images(
                image_paths
            )
        region_progress = ProgressTracker(
            os.path.join(args.output_folder, "region_embedding_progress.json")
        )
        with timer.stage("embed_regions", len(image_paths)):
            RegionProcessor(
                get_detector(),
                emb,
                col,
                output_folder=args.output_folder,
                progress=region_progress,
            ).process_regions(image_paths)

    # --- stage: cluster ----------------------------------------------------
    if run("cluster"):
        from multimodal_embeddings_tpu_torch.analysis.clustering import (
            cluster_pages,
            compute_similarity_matrix,
            group_regions_by_page,
        )
        from multimodal_embeddings_tpu_torch.analysis.reports import create_cluster_report

        col = get_collection()
        pages = group_regions_by_page(col)
        if len(pages) < 2:
            logger.warning("need >=2 pages with regions to cluster (have %d)", len(pages))
        else:
            with timer.stage("cluster", len(pages)):
                similarity = compute_similarity_matrix(
                    pages,
                    prefix_skip=args.prefix_length,
                    device=args.device,
                )
                result = cluster_pages(
                    similarity, [p.name for p in pages], n_clusters=args.n_clusters
                )
                create_cluster_report(
                    similarity,
                    result,
                    os.path.join(args.output_folder, "weighted_clustering"),
                )
            logger.info(
                "clustering: %d clusters, silhouette %.4f",
                result.n_clusters,
                result.silhouette,
            )

    # --- optional reports --------------------------------------------------
    if args.run_cross_compare:
        from multimodal_embeddings_tpu_torch.analysis.cross_compare import (
            create_cross_comparison,
        )
        from multimodal_embeddings_tpu_torch.pipeline.regions import ImageProcessor

        create_cross_comparison(
            get_collection(),
            output_folder="cross_compare",
            image_processor=ImageProcessor(get_embedder(), get_collection()),
            progress=ProgressTracker(
                os.path.join(args.output_folder, "cross_compare_progress.json")
            ),
        )
    if args.run_region_compare:
        from multimodal_embeddings_tpu_torch.analysis.region_compare import (
            create_region_cross_comparison,
        )

        create_region_cross_comparison(
            get_collection(),
            output_folder="region_compare",
            similarity_threshold=args.similarity_threshold,
            progress=ProgressTracker(
                os.path.join(args.output_folder, "region_comparison_progress.json")
            ),
        )
    if args.run_demo:
        from multimodal_embeddings_tpu_torch.analysis.demo_queries import run_demo_queries

        run_demo_queries(
            get_embedder(),
            get_collection(),
            test_image=args.demo_image,
            test_text=args.demo_text,
        )

    timer.log_summary()
    logger.info("workflow complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
