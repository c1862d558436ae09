"""Whole-image cross-comparison reports.

A copy of ``multimodal_embeddings_tpu/analysis/cross_compare.py`` (the
reference's ``cross_compare.py``, D11; ``tests/test_torch_analysis.py``
holds the sources equal and the HTML trees byte-identical): for every whole
page in the store, find its most similar pages (excluding same-publication
files via the 20%-filename-prefix skip, ``cross_compare.py:109-111,
201-205``), and emit a styled HTML page per image plus a global index.
Missing embeddings are regenerated through the ImageProcessor
(``cross_compare.py:93-107``).

The retrieval is one batched store query for ALL pages at once, on the
store's device (``store/embedding_store.py::masked_topk``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from multimodal_embeddings_tpu_torch.analysis import html as H
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker

logger = get_logger("cross_compare")


def prefix_length(filename: str, fraction: float = 0.2) -> int:
    return max(1, int(len(filename) * fraction))


def create_cross_comparison(
    collection,
    output_folder: str = "cross_compare",
    top_n: int = 10,
    image_processor=None,
    progress: Optional[ProgressTracker] = None,
    prefix_fraction: float = 0.2,
) -> int:
    """Build per-page comparison HTML + index. Returns pages written."""
    os.makedirs(output_folder, exist_ok=True)
    whole = collection.get(
        where={"is_region": {"$eq": False}}, include=("embeddings", "metadatas")
    )
    ids = whole["ids"]
    if not ids:
        logger.warning("no whole-image embeddings in store")
        return 0

    embeddings: List = list(whole.get("embeddings", []))
    metadatas = whole["metadatas"]

    # Regenerate missing embeddings through the processor (D11 behavior).
    for i, (item_id, emb, meta) in enumerate(zip(ids, embeddings, metadatas)):
        if (emb is None or not emb) and image_processor is not None:
            path = meta.get("image_path")
            if path and image_processor.process_image(path, force=True):
                refetched = collection.get(ids=[item_id], include=("embeddings",))
                if refetched["ids"]:
                    embeddings[i] = refetched["embeddings"][0]

    valid = [i for i, e in enumerate(embeddings) if e]
    if not valid:
        return 0

    query_size = min(top_n * 5, 100, len(valid))
    results = collection.query(
        query_embeddings=[embeddings[i] for i in valid],
        n_results=query_size,
        where={"is_region": {"$eq": False}},
        include=("metadatas", "distances"),
    )

    index_entries = []
    written = 0
    for qn, i in enumerate(valid):
        image_id = ids[i]
        if progress is not None and progress.is_completed(image_id):
            continue
        meta = metadatas[i]
        image_path = meta.get("image_path", "")
        source_prefix = image_id[: prefix_length(image_id, prefix_fraction)]

        cards = []
        for rid, dist, rmeta in zip(
            results["ids"][qn], results["distances"][qn], results["metadatas"][qn]
        ):
            if rid == image_id:
                continue
            if rid[: len(source_prefix)] == source_prefix:
                continue  # same-publication skip
            rprefix = rid[: len(source_prefix)]
            cards.append(
                H.ref_image_card(
                    len(cards) + 1,
                    rmeta.get("image_path", ""),
                    rid,
                    rprefix,
                    f"{dist:.4f}",
                )
            )
            if len(cards) >= top_n:
                break

        # reference DOM (cross_compare.py:131-256): source-info header,
        # source image block, flex grid of image-cards, back button
        import html as _html

        esc = _html.escape
        body = (
            "    <h1>Cross-Comparison Results</h1>\n"
            '    <div class="source-info">\n'
            f"        <h2>Source Image: {esc(image_id)}</h2>\n"
            f"        <p>Source prefix (first {len(source_prefix)} chars): "
            f"<span class=\"prefix\">'{esc(source_prefix)}'</span></p>\n"
            "    </div>\n"
            '    <div class="source-image">\n'
            "        <h2>Source Image:</h2>\n"
            '        <div class="image-container">\n'
            f'            <a href="{esc(image_path)}" target="_blank">'
            f'<img src="{esc(image_path)}" alt="Source: {esc(image_id)}" '
            'title="Click to open full image"></a>\n'
            "        </div>\n"
            "    </div>\n"
            "    <h2>Similar Images (with different prefixes):</h2>\n"
            '    <div class="similar-images">\n'
            + "".join(cards)
            + "    </div>\n"
            '    <a href="index.html" class="back">Back to Index</a>'
        )
        page_name = f"{os.path.splitext(image_id)[0]}_comparison.html"
        H.write_ref_page(
            os.path.join(output_folder, page_name),
            f"Cross-Comparison: {image_id}",
            H.CROSS_PAGE_STYLE,
            body,
        )
        index_entries.append((image_id, page_name, len(cards)))
        if progress is not None:
            progress.mark_completed(image_id)
        written += 1
        if (written % 5) == 0 or written == len(valid):
            logger.info("cross-compare: %d/%d", written, len(valid))

    # reference index DOM (cross_compare.py:48-74): description block +
    # "All Comparisons:" list with per-page similar counts
    import html as _html

    items = "".join(
        f'        <li><a href="{_html.escape(href)}">{_html.escape(name)}</a>'
        f" - {count} similar images</li>\n"
        for name, href, count in index_entries
    )
    index_body = (
        "    <h1>Image Cross-Comparison Index</h1>\n"
        '    <div class="description">\n'
        "        <p>This index contains links to all image cross-comparison "
        "pages.</p>\n"
        "        <p>Each page shows a source image and its most similar "
        "images that differ in the first 20% of their filename.</p>\n"
        "    </div>\n"
        "    <h2>All Comparisons:</h2>\n"
        "    <ul>\n" + items + "    </ul>"
    )
    H.write_ref_page(
        os.path.join(output_folder, "index.html"),
        "Image Cross-Comparison Index",
        H.CROSS_INDEX_STYLE,
        index_body,
    )
    return written
