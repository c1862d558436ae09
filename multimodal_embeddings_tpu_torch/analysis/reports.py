"""Clustering visualizations and the full HTML report.

Port of ``multimodal_embeddings_tpu/analysis/reports.py`` (equivalents of
the reference's matplotlib heatmap, scipy dendrogram, networkx similarity
graph and HTML cluster report, ``weighted_region_clustering.py:256-450,
576-797``). ``create_cluster_report`` is a verbatim copy
(``tests/test_torch_analysis.py`` holds the sources equal). Plotting is
host-side and optional: the JAX plots ``try`` to import matplotlib, scipy
and networkx and return False when one fails; the package keeps no
``try``, so each plot finds its libraries with ``importlib.util.find_spec``
and returns False where one is not installed (the card's machine has no
matplotlib or networkx). After the imports each plot is JAX's lines.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimodal_embeddings_tpu_torch.analysis import html as H
from multimodal_embeddings_tpu_torch.analysis.clustering import ClusteringResult
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger

logger = get_logger("reports")


def _have(*names: str) -> bool:
    """Each named library is installed (found by ``find_spec``, not
    imported)."""
    return all(importlib.util.find_spec(name) is not None for name in names)


def _short(name: str, n: int = 28) -> str:
    return name if len(name) <= n else name[: n - 1] + "…"


def plot_similarity_heatmap(
    similarity: np.ndarray, names: Sequence[str], output_path: str
) -> bool:
    if not _have("matplotlib"):
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(similarity, cmap="viridis", vmin=0, vmax=1)
    labels = [_short(n) for n in names]
    ax.set_xticks(range(len(names)))
    ax.set_yticks(range(len(names)))
    ax.set_xticklabels(labels, rotation=90, fontsize=6)
    ax.set_yticklabels(labels, fontsize=6)
    fig.colorbar(im, label="weighted region similarity")
    ax.set_title("Page similarity (area-weighted region matches)")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return True


def plot_dendrogram(
    result: ClusteringResult, output_path: str
) -> bool:
    if not _have("matplotlib", "scipy"):
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from scipy.cluster.hierarchy import dendrogram

    fig, ax = plt.subplots(figsize=(11, 6))
    dendrogram(
        result.linkage,
        labels=[_short(n) for n in result.names],
        leaf_rotation=90,
        leaf_font_size=7,
        ax=ax,
    )
    ax.set_title(
        f"Average-linkage dendrogram (k={result.n_clusters}, "
        f"silhouette={result.silhouette:.3f})"
    )
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return True


def plot_similarity_network(
    similarity: np.ndarray,
    result: ClusteringResult,
    output_path: str,
) -> bool:
    if not _have("matplotlib", "networkx"):
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx

    n = similarity.shape[0]
    graph = nx.Graph()
    for i, name in enumerate(result.names):
        graph.add_node(i, label=_short(name, 18), cluster=int(result.labels[i]))
    # adaptive threshold: keep the strongest edges (~3 per node), like the
    # reference's adaptive edge threshold (weighted_region_clustering.py:343-450)
    off = similarity[~np.eye(n, dtype=bool)]
    threshold = np.quantile(off, max(0.0, 1 - 6.0 / max(n, 1))) if off.size else 0
    for i in range(n):
        for j in range(i + 1, n):
            if similarity[i, j] >= threshold and similarity[i, j] > 0:
                graph.add_edge(i, j, weight=float(similarity[i, j]))
    pos = nx.spring_layout(graph, seed=0, weight="weight")
    fig, ax = plt.subplots(figsize=(10, 8))
    colors = [graph.nodes[i]["cluster"] for i in graph.nodes]
    nx.draw_networkx_nodes(
        graph, pos, node_color=colors, cmap="tab10", node_size=320, ax=ax
    )
    nx.draw_networkx_edges(
        graph,
        pos,
        width=[graph[u][v]["weight"] * 3 for u, v in graph.edges],
        alpha=0.4,
        ax=ax,
    )
    nx.draw_networkx_labels(
        graph, pos, {i: graph.nodes[i]["label"] for i in graph.nodes}, font_size=6, ax=ax
    )
    ax.set_title("Similarity network (node color = cluster)")
    ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    fig.savefig(output_path, dpi=150)
    plt.close(fig)
    return True


def create_cluster_report(
    similarity: np.ndarray,
    result: ClusteringResult,
    output_folder: str,
    image_paths: Optional[Dict[str, str]] = None,
    top_pairs: int = 50,
) -> str:
    """Full HTML report: cluster tables, top pairs, colored matrix, linked
    plots; also saves similarity_matrix.npy + clustering_results.json
    (``weighted_region_clustering.py:576-797,870-892``)."""
    os.makedirs(output_folder, exist_ok=True)
    np.save(os.path.join(output_folder, "similarity_matrix.npy"), similarity)
    with open(os.path.join(output_folder, "clustering_results.json"), "w") as f:
        json.dump(
            {
                "names": result.names,
                "labels": result.labels.tolist(),
                "n_clusters": result.n_clusters,
                "silhouette": result.silhouette,
                "cohesion": {str(k): v for k, v in result.cohesion.items()},
            },
            f,
            indent=2,
        )

    heatmap_ok = plot_similarity_heatmap(
        similarity, result.names, os.path.join(output_folder, "similarity_heatmap.png")
    )
    dendro_ok = plot_dendrogram(
        result, os.path.join(output_folder, "dendrogram.png")
    )
    network_ok = plot_similarity_network(
        similarity, result, os.path.join(output_folder, "similarity_network.png")
    )

    # reference DOM (weighted_region_clustering.py:576-797): intro section,
    # stats block, visualization section, clusters sorted by cohesion,
    # top-50 pairs with >0.5 highlight, rgba-shaded similarity matrix
    import html as _html
    import time as _time

    esc = _html.escape
    n = similarity.shape[0]
    off_diag = similarity - np.diag(np.diag(similarity))
    nonzero = similarity[similarity > 0.01]
    sections = [
        '    <h1>Newspaper Image Clustering Results</h1>\n'
        '    <div class="section">\n'
        "        <p>This report shows clustering of newspaper images based "
        "on semantic similarity of their regions, weighted by region "
        "size.</p>\n"
        f"        <p>Number of newspapers analyzed: {len(result.names)}</p>\n"
        f"        <p>Number of clusters: {result.n_clusters}</p>\n"
        f"        <p>Generated on: "
        f"{_time.strftime('%Y-%m-%d %H:%M:%S')}</p>\n"
        f"        <p>Silhouette score: {result.silhouette:.4f}</p>\n"
        "    </div>",
        '    <div class="stats">\n'
        "        <h2>Similarity Statistics</h2>\n"
        f"        <p>Non-zero similarity pairs: "
        f"{int(np.sum(similarity > 0.01)) - n}</p>\n"
        f"        <p>Average non-zero similarity: "
        f"{float(np.mean(nonzero)) if nonzero.size else 0.0:.4f}</p>\n"
        f"        <p>Max similarity between different images: "
        f"{float(np.max(off_diag)) if n > 1 else 0.0:.4f}</p>\n"
        "    </div>",
    ]

    viz = []
    for ok, img, title, caption in (
        (heatmap_ok, "similarity_heatmap.png", "Similarity Heatmap",
         "Heatmap showing pairwise similarities between newspaper images, "
         "based on weighted region comparisons."),
        (dendro_ok, "dendrogram.png", "Hierarchical Clustering Dendrogram",
         "Dendrogram showing hierarchical clustering of newspapers. "
         "Newspapers that are more similar appear closer together."),
        (network_ok, "similarity_network.png", "Similarity Network",
         "Network graph showing relationships between newspapers. Connected "
         "newspapers have significant region similarity."),
    ):
        if ok:
            viz.append(
                f"        <h3>{title}</h3>\n"
                '        <div class="visualization">\n'
                f'            <img src="{img}" alt="{title}">\n'
                f"            <p>{caption}</p>\n"
                "        </div>"
            )
    sections.append(
        '    <div class="section">\n        <h2>Visualizations</h2>\n'
        + "\n".join(viz)
        + "\n    </div>"
    )

    cluster_blocks = []
    by_cohesion = sorted(
        result.clusters().items(),
        key=lambda kv: result.cohesion.get(kv[0], 0),
        reverse=True,
    )
    for cluster_id, members in by_cohesion:
        rows = []
        for name in members:
            cell = esc(name)
            if image_paths and name in image_paths:
                cell = f"<a href='{esc(image_paths[name])}'>{esc(name)}</a>"
            rows.append(f"                <tr><td>{cell}</td></tr>")
        cluster_blocks.append(
            '        <div class="cluster">\n'
            '            <div class="cluster-title">\n'
            f"                <h3>Cluster {cluster_id}</h3>\n"
            f'                <span class="cluster-cohesion">Cohesion: '
            f"{result.cohesion.get(cluster_id, 0):.3f}</span>\n"
            "            </div>\n"
            f"            <p>Contains {len(members)} newspapers.</p>\n"
            "            <table>\n"
            "                <tr><th>Newspaper</th></tr>\n"
            + "\n".join(rows)
            + "\n            </table>\n        </div>"
        )
    sections.append(
        '    <div class="section">\n        <h2>Clusters</h2>\n'
        + "\n".join(cluster_blocks)
        + "\n    </div>"
    )

    pairs = [
        (similarity[i, j], result.names[i], result.names[j])
        for i in range(n)
        for j in range(i + 1, n)
        if similarity[i, j] > 0
    ]
    pairs.sort(reverse=True)
    pair_rows = []
    for s, a, b in pairs[:top_pairs]:
        highlight = " class='highlight'" if s > 0.5 else ""
        pair_rows.append(
            f"            <tr{highlight}><td>{esc(a)}</td><td>{esc(b)}</td>"
            f"<td>{s:.4f}</td></tr>"
        )
    if not pair_rows:
        pair_rows.append(
            '            <tr><td colspan="3">No similarities found between '
            "different newspapers</td></tr>"
        )
    sections.append(
        '    <div class="section">\n        <h2>Top Similarities</h2>\n'
        "        <table>\n"
        "            <tr><th>Newspaper 1</th><th>Newspaper 2</th>"
        "<th>Similarity</th></tr>\n"
        + "\n".join(pair_rows)
        + "\n        </table>\n    </div>"
    )

    def _ref_short(name):
        # reference truncation: first 15 chars + "..." when longer than 18
        return name[:15] + "..." if len(name) > 18 else name

    matrix_rows = ["            <tr><th>Newspaper</th>"]
    for name in result.names:
        matrix_rows[0] += f"<th>{esc(_ref_short(name))}</th>"
    matrix_rows[0] += "</tr>"
    for i, row_name in enumerate(result.names):
        cells = [f"<td>{esc(_ref_short(row_name))}</td>"]
        for j in range(n):
            sim = float(similarity[i, j])
            bg = (
                "#e6e6e6"
                if i == j
                else f"rgba(0, 100, 255, {sim:.2f})"
            )
            cells.append(
                f'<td style="background-color: {bg};">{sim:.3f}</td>'
            )
        matrix_rows.append("            <tr>" + "".join(cells) + "</tr>")
    sections.append(
        '    <div class="section">\n        <h2>Similarity Matrix</h2>\n'
        "        <table>\n" + "\n".join(matrix_rows) + "\n        </table>\n"
        "    </div>"
    )

    report_path = os.path.join(output_folder, "clustering_report.html")
    H.write_ref_page(
        report_path,
        "Newspaper Image Clustering Results",
        H.CLUSTER_STYLE,
        "\n".join(sections),
    )
    logger.info("cluster report written to %s", report_path)
    return report_path
