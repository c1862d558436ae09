"""Demo retrieval queries — the end-to-end smoke test.

Port of ``multimodal_embeddings_tpu/analysis/demo_queries.py`` (the
reference's ``demo_queries.py``, D14): embed a probe image and a probe
text, query the top-20 whole pages and top-20 regions for each, copy the
result images into ``testout/`` with rank-prefixed names, and write a
human-readable ``query_results.txt`` (``demo_queries.py:15-326``;
reference probes: ``TEST_IMG='./sciam.png'``, ``TEST_TEXT='Hoosier.
Hockey.'``, ``config.py:11-12``). ``run_demo_queries`` is a verbatim copy
(``tests/test_torch_analysis.py``). JAX's ``_copy_ranked`` catches a failed
copy's ``OSError``; here the copy runs in ``utils/errors.py::Held``, an
``OSError`` is logged with JAX's message, and any other error is raised
again, as JAX lets it through.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional

from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.utils.errors import Held

logger = get_logger("demo_queries")


def _copy_ranked(results, out_dir: str, tag: str, lines: List[str]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    lines.append(f"\n=== {tag} ===")
    for rank, (rid, dist, meta) in enumerate(
        zip(results["ids"][0], results["distances"][0], results["metadatas"][0]), 1
    ):
        similarity = 1.0 - dist
        lines.append(f"{rank:2d}. {rid}  similarity={similarity:.4f}")
        src = meta.get("image_path") or meta.get("parent_image")
        if src and os.path.exists(src):
            ext = os.path.splitext(src)[1]
            dst = os.path.join(out_dir, f"{tag}_{rank:02d}_{rid}{ext}")
            with Held() as held:
                shutil.copy2(src, dst)
            if isinstance(held.error, OSError):
                logger.warning("copy failed for %s: %s", src, held.error)
            elif held.error is not None:
                raise held.error


def run_demo_queries(
    embedder,
    collection,
    test_image: Optional[str] = None,
    test_text: str = "Hoosier. Hockey.",
    output_folder: str = "testout",
    top_n: int = 20,
) -> str:
    """Run image and text probes; returns the path of query_results.txt."""
    os.makedirs(output_folder, exist_ok=True)
    lines: List[str] = []

    if test_image and os.path.exists(test_image):
        emb = embedder.get_image_embeddings([test_image], is_query=True)[0]
        if emb is not None:
            for is_region, tag in ((False, "img_query_pages"), (True, "img_query_regions")):
                results = collection.query(
                    query_embeddings=[emb],
                    n_results=min(top_n, max(collection.count(), 1)),
                    where={"is_region": {"$eq": is_region}},
                    include=("metadatas", "distances"),
                )
                if results["ids"] and results["ids"][0]:
                    _copy_ranked(results, output_folder, tag, lines)
        else:
            lines.append(f"image probe failed: {test_image}")
    else:
        lines.append("no image probe supplied")

    text_emb = embedder.get_text_embeddings(test_text)
    for is_region, tag in ((False, "txt_query_pages"), (True, "txt_query_regions")):
        results = collection.query(
            query_embeddings=[text_emb],
            n_results=min(top_n, max(collection.count(), 1)),
            where={"is_region": {"$eq": is_region}},
            include=("metadatas", "distances"),
        )
        if results["ids"] and results["ids"][0]:
            _copy_ranked(results, output_folder, f"{tag}", lines)

    results_path = os.path.join(output_folder, "query_results.txt")
    with open(results_path, "w") as f:
        f.write(f"text probe: {test_text!r}\n")
        f.write(f"image probe: {test_image!r}\n")
        f.write("\n".join(lines) + "\n")
    logger.info("demo queries written to %s", results_path)
    return results_path
