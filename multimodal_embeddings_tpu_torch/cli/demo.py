"""Standalone demo-queries CLI (the reference's ``demo_queries.py`` smoke
test, D14): image + text probes against an existing store.

Port of ``multimodal_embeddings_tpu/cli/demo.py`` with the same flags plus
``--device`` (``cuda`` by default): the embedder and the store's retrieval
run there.

    python -m multimodal_embeddings_tpu_torch.cli.demo --db_path db \\
        --test_image pages/p0.png --device cpu
"""

from __future__ import annotations

import argparse

from multimodal_embeddings_tpu_torch.analysis.demo_queries import run_demo_queries
from multimodal_embeddings_tpu_torch.config import EmbedderConfig
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.models.weights import resolve_device

logger = get_logger("cli.demo")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Run demo retrieval queries")
    parser.add_argument("--db_path", default="db")
    parser.add_argument("--test_image", default=None)
    parser.add_argument("--test_text", default="Hoosier. Hockey.")
    parser.add_argument("--output_folder", default="testout")
    parser.add_argument("--top_n", type=int, default=20)
    parser.add_argument("--embedder_family", choices=["siglip", "mme5"], default="siglip")
    parser.add_argument("--embedder_weights", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    from multimodal_embeddings_tpu_torch.models.embedder import MultimodalEmbedder
    from multimodal_embeddings_tpu_torch.store.embedding_store import initialize_db

    _, collection = initialize_db(args.db_path, device=args.device)
    if collection.count() == 0:
        logger.error("store at %s is empty — run the workflow embed stage first", args.db_path)
        return 1
    embedder = MultimodalEmbedder(
        EmbedderConfig(family=args.embedder_family, weights_path=args.embedder_weights),
        device=args.device,
    )
    results_path = run_demo_queries(
        embedder,
        collection,
        test_image=args.test_image,
        test_text=args.test_text,
        output_folder=args.output_folder,
        top_n=args.top_n,
    )
    logger.info("results: %s", results_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
