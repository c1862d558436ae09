"""Region-level cross-comparison reports.

Port of ``multimodal_embeddings_tpu/analysis/region_compare.py`` (the
reference's ``region_compare.py``, D12): for each stored region, find the
most similar regions from OTHER pages, filter by the similarity threshold,
apply area weighting, render side-by-side comparison composites and HTML
pages + index. ``create_region_cross_comparison`` is a verbatim copy
(``tests/test_torch_analysis.py`` holds the sources equal and the HTML
trees byte-identical). JAX's ``_box_from_meta`` catches ``float``'s
``ValueError``; the package keeps no ``try``, so it parses a box only when
every part is what ``float`` takes (``_FLOAT``) and returns JAX's None
otherwise.

Reference quirks preserved behind ``distance_as_similarity`` (default
True): the reference reads Chroma's *distance* column and treats it as the
similarity score — both for the threshold test (skips when
``distance < 0.3``) and in the area-weighted score
(``region_compare.py:264-283``). Set False for the mathematically intended
``1 − distance`` behavior.

Retrieval is batched: one store query for every region at once, on the
store's device. It holds an (R, R) f32 score matrix and its int64 sort keys,
about 12 bytes per pair of regions (``store/embedding_store.py``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from multimodal_embeddings_tpu_torch.analysis import html as H
from multimodal_embeddings_tpu_torch.analysis.visualization import (
    region_comparison_composite,
)
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.io.progress import ProgressTracker

logger = get_logger("region_compare")

# what ``float()`` takes (blanks, a sign, digits with single underscores, a
# point, an exponent, inf, infinity, nan in any case), where JAX catches
# float's ValueError
_DIGITS = r"\d(?:_?\d)*"
_FLOAT = re.compile(
    rf"\s*[+-]?(?:(?:{_DIGITS})?\.{_DIGITS}(?:[eE][+-]?{_DIGITS})?"
    rf"|{_DIGITS}\.?(?:[eE][+-]?{_DIGITS})?|inf(?:inity)?|nan)\s*",
    re.IGNORECASE,
)


def _box_from_meta(meta: Dict) -> Optional[List[float]]:
    box = meta.get("box") or meta.get("box_str")
    if box:
        parts = box.split(",")
        if all(_FLOAT.fullmatch(x) for x in parts):
            return [float(x) for x in parts]
        return None
    return None


def create_region_cross_comparison(
    collection,
    output_folder: str = "region_compare",
    top_n: int = 10,
    similarity_threshold: float = 0.3,
    weight_by_area: bool = True,
    distance_as_similarity: bool = True,
    make_composites: bool = True,
    progress: Optional[ProgressTracker] = None,
) -> int:
    os.makedirs(output_folder, exist_ok=True)
    viz_folder = os.path.join(output_folder, "comparisons")
    os.makedirs(viz_folder, exist_ok=True)

    regions = collection.get(
        where={"is_region": {"$eq": True}}, include=("embeddings", "metadatas")
    )
    ids = regions["ids"]
    if not ids:
        logger.warning("no region embeddings in store")
        return 0
    embeddings = regions.get("embeddings", [])
    metadatas = regions["metadatas"]

    results = collection.query(
        query_embeddings=embeddings,
        n_results=min(top_n * 3, len(ids)),
        where={"is_region": {"$eq": True}},
        include=("metadatas", "distances"),
    )

    index_entries = []
    written = 0
    for qn, (region_id, meta) in enumerate(zip(ids, metadatas)):
        if progress is not None and progress.is_completed(region_id):
            continue
        parent = meta.get("parent_image", "")
        source_area = float(meta.get("area_percentage", 0.0))
        source_box = _box_from_meta(meta)

        matches = []
        for rid, dist, rmeta in zip(
            results["ids"][qn], results["distances"][qn], results["metadatas"][qn]
        ):
            if rid == region_id:
                continue
            if rmeta.get("parent_image", "") == parent:
                continue  # same-page skip (region_compare.py:257-261)
            score = dist if distance_as_similarity else 1.0 - dist
            if score < similarity_threshold:
                continue
            if weight_by_area:
                target_area = float(rmeta.get("area_percentage", 0.0))
                weighted = score * (source_area / 100.0) * (target_area / 100.0)
            else:
                weighted = score
            matches.append((rid, rmeta, score, weighted))
            if len(matches) >= top_n:
                break

        if not matches:
            if progress is not None:
                progress.mark_completed(region_id)
            continue

        cards = []
        for rank, (rid, rmeta, score, weighted) in enumerate(matches):
            target_box = _box_from_meta(rmeta)
            comp_rel = None
            if (
                make_composites
                and source_box is not None
                and target_box is not None
                and os.path.exists(parent)
                and os.path.exists(rmeta.get("parent_image", ""))
            ):
                comp_name = f"{region_id}_vs_{rid}.jpg"
                comp_path = os.path.join(viz_folder, comp_name)
                if region_comparison_composite(
                    parent,
                    rmeta["parent_image"],
                    source_box,
                    target_box,
                    score,
                    comp_path,
                    banner=f"score {score:.4f} | weighted {weighted:.6f}",
                ):
                    comp_rel = os.path.join("comparisons", comp_name)
            # reference region-card DOM (region_compare.py:316-328)
            import html as _html

            rtype = rmeta.get("region_type", "?")
            crop_img = rmeta.get("crop_path", "") or comp_rel or ""
            img = (
                f'<a href="{_html.escape(crop_img)}" target="_blank">'
                f'<img src="{_html.escape(crop_img)}" alt="Similar Region" '
                'title="Click to open full image"></a>'
                if crop_img
                else "<div style='height:120px'></div>"
            )
            viz_link = (
                f'\n            <a href="{_html.escape(comp_rel)}" '
                'class="visualization" target="_blank">View Comparison</a>'
                if comp_rel
                else ""
            )
            cards.append(
                '        <div class="region-card">\n'
                f'            <div class="image-container">{img}</div>\n'
                f"            <p><strong>{rank + 1}.</strong> Type: "
                f"{H.region_type_chip(rtype)}</p>\n"
                f"            <p>Parent: "
                f"{_html.escape(str(rmeta.get('parent_image_name', '?')))}</p>\n"
                f"            <p>Area: "
                f"{float(rmeta.get('area_percentage', 0.0)):.2f}%</p>\n"
                f'            <p>Similarity score: <span class="score">'
                f"{score:.4f}</span></p>\n"
                f'            <p>Weighted score: <span class="score">'
                f"{weighted:.6f}</span></p>{viz_link}\n"
                "        </div>\n"
            )

        # reference page DOM (region_compare.py:178-233)
        import html as _html

        esc = _html.escape
        rtype = meta.get("region_type", "?")
        body = (
            "    <h1>Region Cross-Comparison Results</h1>\n"
            '    <div class="source-info">\n'
            f"        <h2>Source Region: {esc(region_id)}</h2>\n"
            f"        <p>Type: {H.region_type_chip(rtype)}</p>\n"
            f"        <p>Parent Image: "
            f"{esc(str(meta.get('parent_image_name', '?')))}</p>\n"
            f"        <p>Area Percentage: {source_area:.2f}%</p>\n"
            "    </div>\n"
            '    <div class="source-region">\n'
            "        <h2>Source Region:</h2>\n"
            '        <div class="image-container">\n'
            f'            <a href="{esc(parent)}" target="_blank">'
            f'<img src="{esc(parent)}" alt="Parent Image" '
            'title="Click to open parent image" style="max-height: 300px;">'
            "</a>\n"
            "        </div>\n"
            "    </div>\n"
            "    <h2>Similar Regions (from different images):</h2>\n"
            '    <div class="similar-regions">\n'
            + "".join(cards)
            + "    </div>\n"
            '    <a href="index.html" class="back">Back to Index</a>'
        )
        page_name = f"{region_id}_comparison.html"
        H.write_ref_page(
            os.path.join(output_folder, page_name),
            f"Region Cross-Comparison: {region_id}",
            H.REGION_PAGE_STYLE,
            body,
        )
        index_entries.append(
            (region_id, meta.get("region_type", "?"), page_name, len(matches))
        )
        if progress is not None:
            progress.mark_completed(region_id)
        written += 1

    # reference index DOM (region_compare.py:75-107)
    import html as _html

    items = "".join(
        f"        <li>{H.region_type_chip(rtype)} "
        f'<a href="{_html.escape(href)}">{_html.escape(rid)}</a>'
        f" - {count} similar regions</li>\n"
        for rid, rtype, href, count in index_entries
    )
    index_body = (
        "    <h1>Region Cross-Comparison Index</h1>\n"
        '    <div class="description">\n'
        "        <p>This index contains links to all region cross-comparison "
        "pages.</p>\n"
        "        <p>Each page shows a source region and its most similar "
        "regions from different parent images.</p>\n"
        "    </div>\n"
        "    <h2>All Comparisons:</h2>\n"
        "    <ul>\n" + items + "    </ul>"
    )
    H.write_ref_page(
        os.path.join(output_folder, "index.html"),
        "Region Cross-Comparison Index",
        H.REGION_INDEX_STYLE,
        index_body,
    )
    logger.info("region-compare: %d pages written", written)
    return written
