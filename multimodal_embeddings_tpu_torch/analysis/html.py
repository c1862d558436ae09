"""Shared HTML report scaffolding for comparison/cluster reports.

A copy of ``multimodal_embeddings_tpu/analysis/html.py``: the same style
constants and functions (``tests/test_torch_analysis.py`` holds the sources
equal), so the port's reports are JAX's byte for byte.
"""

from __future__ import annotations

import html
import os
from typing import Iterable, List, Optional, Sequence, Tuple

STYLE = """
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       margin: 24px; background: #fafafa; color: #222; }
h1, h2 { color: #1a1a2e; }
.card { background: #fff; border: 1px solid #ddd; border-radius: 8px;
        padding: 14px; margin: 12px 0; box-shadow: 0 1px 3px rgba(0,0,0,.06); }
.grid { display: flex; flex-wrap: wrap; gap: 14px; }
.item { width: 280px; text-align: center; }
.item img { max-width: 100%; max-height: 240px; border: 1px solid #ccc; }
.score { font-weight: 600; color: #0a6; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccc; padding: 5px 9px; }
a { color: #2456a4; text-decoration: none; }
.matrix td { min-width: 34px; text-align: center; font-size: 11px; }
"""


# --- reference-styled scaffolding ------------------------------------------
# Inline CSS mirroring the reference reports so rendered output diffs
# trivially against the originals (cross_compare.py:131-256 page + :48-74
# index; weighted_region_clustering.py:576-797 cluster report).

CROSS_PAGE_STYLE = """
        body { font-family: Arial, sans-serif; margin: 20px; line-height: 1.6; }
        h1, h2 { color: #333; }
        .source-info { background-color: #f5f5f5; padding: 15px; border-radius: 5px; margin-bottom: 20px; }
        .source-image { margin-bottom: 30px; }
        .similar-images { display: flex; flex-wrap: wrap; gap: 20px; }
        .image-card { border: 1px solid #ddd; border-radius: 5px; padding: 15px; width: 300px; }
        .image-container { margin-bottom: 10px; }
        .image-container img { max-width: 100%; height: auto; cursor: pointer; }
        .score { font-weight: bold; }
        .prefix { color: #666; font-style: italic; }
        a.back { display: inline-block; margin-top: 20px; padding: 10px 15px; background-color: #0066cc; color: white; text-decoration: none; border-radius: 4px; }
        a.back:hover { background-color: #0052a3; }
"""

CROSS_INDEX_STYLE = """
        body { font-family: Arial, sans-serif; margin: 20px; line-height: 1.6; }
        h1 { color: #333; }
        .description { margin-bottom: 20px; }
        ul { list-style-type: none; padding: 0; }
        li { margin-bottom: 8px; }
        a { color: #0066cc; text-decoration: none; }
        a:hover { text-decoration: underline; }
"""

CLUSTER_STYLE = """
        body { font-family: Arial, sans-serif; margin: 20px; line-height: 1.6; max-width: 1200px; margin: 0 auto; }
        h1, h2, h3 { color: #333; }
        .section { margin-bottom: 40px; }
        .cluster { background-color: #f5f5f5; padding: 15px; border-radius: 5px; margin-bottom: 20px; }
        .cluster-title { display: flex; justify-content: space-between; }
        .cluster-cohesion { color: #666; }
        .images { display: flex; flex-wrap: wrap; gap: 10px; }
        .image-item { text-align: center; width: 200px; }
        .image-item img { max-width: 100%; height: auto; border: 1px solid #ddd; }
        .visualization { margin-top: 20px; text-align: center; }
        .visualization img { max-width: 100%; border: 1px solid #ddd; }
        table { border-collapse: collapse; width: 100%; }
        th, td { border: 1px solid #ddd; padding: 8px; text-align: left; }
        th { background-color: #f2f2f2; }
        tr:nth-child(even) { background-color: #f9f9f9; }
        .highlight { background-color: #fffacd; }
        .stats { background-color: #e8f4f8; padding: 15px; border-radius: 5px; margin: 20px 0; }
"""


# region-type chips shared by the region pages and index
_REGION_TYPE_CSS = """
        .region-type { display: inline-block; padding: 2px 6px; border-radius: 3px; margin-right: 8px; }
        .title { background-color: #ffeeaa; }
        .plain_text { background-color: #e0f7fa; }
        .figure { background-color: #e8f5e9; }
        .table { background-color: #f3e5f5; }
        .caption { background-color: #fff3e0; }
"""

REGION_PAGE_STYLE = """
        body { font-family: Arial, sans-serif; margin: 20px; line-height: 1.6; }
        h1, h2, h3 { color: #333; }
        .source-info { background-color: #f5f5f5; padding: 15px; border-radius: 5px; margin-bottom: 20px; }
        .source-region { margin-bottom: 30px; }
        .similar-regions { display: flex; flex-wrap: wrap; gap: 20px; }
        .region-card { border: 1px solid #ddd; border-radius: 5px; padding: 15px; width: 300px; }
        .image-container { margin-bottom: 10px; }
        .image-container img { max-width: 100%; height: auto; cursor: pointer; }
        .score { font-weight: bold; }
""" + _REGION_TYPE_CSS + """
        a.back { display: inline-block; margin-top: 20px; padding: 10px 15px; background-color: #0066cc; color: white; text-decoration: none; border-radius: 4px; }
        a.back:hover { background-color: #0052a3; }
        a.visualization { display: inline-block; margin-top: 5px; padding: 5px 10px; background-color: #4caf50; color: white; text-decoration: none; border-radius: 4px; }
        a.visualization:hover { background-color: #388e3c; }
"""

REGION_INDEX_STYLE = """
        body { font-family: Arial, sans-serif; margin: 20px; line-height: 1.6; }
        h1, h2 { color: #333; }
        .description { margin-bottom: 20px; }
        ul { list-style-type: none; padding: 0; }
        li { margin-bottom: 8px; }
        a { color: #0066cc; text-decoration: none; }
        a:hover { text-decoration: underline; }
""" + _REGION_TYPE_CSS


def region_type_chip(region_type: str) -> str:
    t = html.escape(str(region_type))
    return f'<span class="region-type {t.lower()}">{t}</span>'


def ref_page(title: str, style: str, body: str) -> str:
    """Reference-shaped document: same head structure (charset + viewport
    meta, inline <style>) as the reference writers."""
    return (
        '<!DOCTYPE html>\n<html lang="en">\n<head>\n'
        '    <meta charset="UTF-8">\n'
        '    <meta name="viewport" content="width=device-width, '
        'initial-scale=1.0">\n'
        f"    <title>{html.escape(title)}</title>\n"
        f"    <style>{style}    </style>\n</head>\n<body>\n"
        f"{body}\n</body>\n</html>\n"
    )


def write_ref_page(path: str, title: str, style: str, body: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(ref_page(title, style, body))


def ref_image_card(
    rank: int,
    image_path: str,
    filename: str,
    prefix: str,
    score_str: str,
) -> str:
    """The reference's similar-image card (cross_compare.py:218-229)."""
    img = (
        f'<a href="{html.escape(image_path)}" target="_blank">'
        f'<img src="{html.escape(image_path)}" alt="Similar: '
        f'{html.escape(filename)}" title="Click to open full image"></a>'
        if image_path
        else "<div style='height:120px'></div>"
    )
    return (
        '<div class="image-card">\n'
        f'    <div class="image-container">{img}</div>\n'
        f"    <p><strong>{rank}.</strong> {html.escape(filename)}</p>\n"
        f"    <p>Prefix: <span class=\"prefix\">'{html.escape(prefix)}'</span></p>\n"
        f'    <p>Similarity score: <span class="score">{score_str}</span></p>\n'
        "</div>\n"
    )


def page(title: str, body: str) -> str:
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{STYLE}</style></head>"
        f"<body><h1>{html.escape(title)}</h1>{body}</body></html>"
    )


def write_page(path: str, title: str, body: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(page(title, body))


def image_card(
    image_path: str,
    caption: str,
    score: Optional[float] = None,
    link: Optional[str] = None,
) -> str:
    img = (
        f"<img src='{html.escape(image_path)}' loading='lazy'>"
        if image_path
        else "<div style='height:120px'></div>"
    )
    if link:
        img = f"<a href='{html.escape(link)}'>{img}</a>"
    score_html = f"<div class='score'>{score:.4f}</div>" if score is not None else ""
    return (
        f"<div class='item card'>{img}{score_html}"
        f"<div>{html.escape(caption)}</div></div>"
    )


def link_list(entries: Sequence[Tuple[str, str]]) -> str:
    items = "".join(
        f"<li><a href='{html.escape(href)}'>{html.escape(text)}</a></li>"
        for text, href in entries
    )
    return f"<ul>{items}</ul>"


def table(headers: Sequence[str], rows: Iterable[Sequence[str]], cls: str = "") -> str:
    head = "".join(f"<th>{html.escape(str(h))}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{cell}</td>" for cell in row) + "</tr>" for row in rows
    )
    return f"<table class='{cls}'><tr>{head}</tr>{body}</table>"


def colored_cell(value: float) -> str:
    """Similarity-shaded matrix cell (green high, white low)."""
    g = int(255 - min(max(value, 0.0), 1.0) * 120)
    return (
        f"<td style='background: rgb({g},255,{g})'>{value:.2f}</td>"
    )
