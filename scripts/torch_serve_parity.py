#!/usr/bin/env python3
"""Serve-vs-exact detection parity of the port, the twin of
``scripts/serve_parity.py`` with its flags, variants and result keys.

The port's fast serving path (``pipeline/fused.py::build_fused_detect_fn``)
approximates the exact numbered chain (stage 1 ``run_detect_stage``, stage
2 ``run_edge_filter_stage``, stage 3 ``run_combine_stage``) three ways: one
cross-view NMS over the top ``candidate_cap·num_regions`` candidates instead
of per-view NMS → edge filter → combine NMS over all boxes, a static top-K
selection, and (the ``squeeze`` variant) an aspect-squeeze view resize
instead of the letterbox. With one detector, the script runs the exact chain
on synthetic pages (``pipeline/synthetic.py::make_page``), then the six
serve variants of the JAX script on the same pages, IoU-matches each
variant's boxes to the exact chain's (greedy by serve score, class-aware)
and reports precision over the serve boxes, recall of the exact set's top-K
strongest boxes and the mean matched IoU.

    python3 scripts/torch_serve_parity.py --full            # on the card
    python3 scripts/torch_serve_parity.py --device cpu      # reduced, here

``--full`` is the production configuration (DocLayout-YOLOv10-m at 1024 px,
grids 2×2, 3×3 and 4×4, 2200×1700 pages, 48 regions, bf16); without it, the
JAX script's reduced one (variant n at 256 px, grids 2×2 and 3×3, 64
detections a view, 800×600 pages, 24 regions, f32). Random weights from
seed 0: every class score then lies within ~1e-5 of 0.5, so the matching
measures ties; ``chip_smoke.py --serve_parity`` calls ``run`` with a
fitted class head instead. The script prints one JSON object with the JAX
record's keys and writes it only to ``--out``: ``SERVE_PARITY.json`` is the
JAX package's record. ``seconds_incl_compile`` keeps the JAX key; the port
compiles nothing per variant, so it is each variant's host wall time over
the pages (the first variant includes the kernels' first launch).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (name, letterbox, edge_filter, candidate_cap, resize in f32): the JAX
# script's six variants, in its order
VARIANTS = (
    ("squeeze", False, True, 4, False),
    ("letterbox", True, True, 4, False),
    ("letterbox_noedge", True, False, 4, False),  # pre-r3 serving semantics
    ("letterbox_cap16", True, True, 16, False),
    ("letterbox_cap64", True, True, 64, False),
    ("letterbox_f32resize", True, True, 4, True),
)


def iou_matrix(a, b):
    import numpy as np

    ax1, ay1, ax2, ay2 = [a[:, i, None] for i in range(4)]
    bx1, by1, bx2, by2 = [b[None, :, i] for i in range(4)]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    area_a = np.clip(ax2 - ax1, 0, None) * np.clip(ay2 - ay1, 0, None)
    area_b = np.clip(bx2 - bx1, 0, None) * np.clip(by2 - by1, 0, None)
    union = area_a + area_b - inter
    return np.where(union > 0, inter / union, 0.0)


def match_sets(serve, exact, iou_floor=0.5):
    """Greedy one-to-one matching by descending serve score; class-aware.

    Returns (precision, recall_topk, mean_iou, n_serve, n_exact_topk)."""
    import numpy as np

    sboxes, sscores, sclasses = serve
    eboxes, escores, eclasses = exact
    if len(sboxes) == 0 or len(eboxes) == 0:
        return 0.0, 0.0, 0.0, len(sboxes), 0
    k = len(sboxes)
    top = np.argsort(-escores, kind="stable")[:k]
    etop_set = set(top.tolist())
    order = np.argsort(-sscores, kind="stable")
    ious = iou_matrix(np.asarray(sboxes, np.float64), np.asarray(eboxes, np.float64))
    same = np.asarray(sclasses)[:, None] == np.asarray(eclasses)[None, :]
    cand = np.where(same, ious, 0.0)
    taken = np.zeros(len(eboxes), bool)
    matched_iou, matched_exact = [], []
    for i in order:
        row = np.where(taken, 0.0, cand[i])
        j = int(np.argmax(row))
        if row[j] >= iou_floor:
            taken[j] = True
            matched_iou.append(float(row[j]))
            matched_exact.append(j)
    precision = len(matched_iou) / max(1, k)
    recall_topk = len(etop_set & set(matched_exact)) / max(1, len(etop_set))
    mean_iou = float(np.mean(matched_iou)) if matched_iou else 0.0
    return precision, recall_topk, mean_iou, k, len(etop_set)


def setup(full: bool, device: str):
    """The page size, region count and a seed-0 detector of the
    configuration."""
    import torch

    from multimodal_embeddings_tpu_torch.config import DetectorConfig
    from multimodal_embeddings_tpu_torch.models.detector import LayoutDetector

    if full:
        cfg = DetectorConfig(image_size=1024, variant="m")
        page_hw, num_regions = (2200, 1700), 48
    else:
        cfg = DetectorConfig(image_size=256, variant="n", grid_configs=((2, 2), (3, 3)),
                             max_detections=64)
        page_hw, num_regions = (800, 600), 24
    detector = LayoutDetector(cfg, dtype=torch.bfloat16 if full else torch.float32,
                              device=device)
    return page_hw, num_regions, detector


def make_pages(page_hw, n: int) -> list:
    from multimodal_embeddings_tpu_torch.pipeline.synthetic import make_page

    return [make_page(*page_hw, seed=s) for s in range(n)]


def exact_chain(detector, pages) -> tuple:
    """The stage 1-3 chain over ``pages`` written as PNGs: ``({stem: (boxes,
    scores, classes)}, seconds)``."""
    import numpy as np
    from PIL import Image

    from multimodal_embeddings_tpu_torch.pipeline.detect import run_detect_stage
    from multimodal_embeddings_tpu_torch.pipeline.stages import (
        run_combine_stage,
        run_edge_filter_stage,
    )

    t0 = time.time()
    exact_sets = {}
    with tempfile.TemporaryDirectory() as td:
        src, s1 = os.path.join(td, "src"), os.path.join(td, "s1")
        s2, s3 = os.path.join(td, "s2"), os.path.join(td, "s3")
        os.makedirs(src)
        for i, page in enumerate(pages):
            Image.fromarray(page).save(os.path.join(src, f"page{i:02d}.png"))
        run_detect_stage(src, s1, detector.config, detector=detector,
                         save_cell_images=False, save_visualizations=False)
        run_edge_filter_stage(s1, s2)
        run_combine_stage(s2, s3)
        for p in sorted(glob.glob(os.path.join(s3, "json", "*_combined.json"))):
            with open(p) as f:
                d = json.load(f)
            stem = os.path.basename(p).split("_combined")[0]
            exact_sets[stem] = (
                np.asarray(d["boxes"], np.float64).reshape(-1, 4),
                np.asarray(d["scores"], np.float64),
                np.asarray(d["classes"]),
            )
    return exact_sets, time.time() - t0


def serve_sets(fn, pages, device) -> dict:
    """``{stem: (boxes, scores, classes)}`` of the valid regions ``fn``
    returns for each page, run on ``device``."""
    import numpy as np
    import torch

    out = {}
    for i, page in enumerate(pages):
        boxes, scores, classes, valid, _ = fn(torch.from_numpy(page).to(device))
        v = valid.cpu().numpy()
        out[f"page{i:02d}"] = (
            boxes.float().cpu().numpy().astype(np.float64)[v],
            scores.float().cpu().numpy().astype(np.float64)[v],
            classes.cpu().numpy()[v],
        )
    return out


def detect_fn(detector, page_hw, num_regions, **kwargs):
    """``build_fused_detect_fn`` at the JAX script's crop size."""
    from multimodal_embeddings_tpu_torch.pipeline.fused import build_fused_detect_fn

    return build_fused_detect_fn(detector, page_hw, num_regions=num_regions, emb_size=64,
                                 **kwargs)


def page_rows(serve_by_page, exact_sets, iou_floor) -> list:
    rows = []
    for stem, serve in serve_by_page.items():
        p, r, miou, k, etk = match_sets(serve, exact_sets[stem], iou_floor=iou_floor)
        rows.append({
            "page": stem, "precision": round(p, 4),
            "recall_topk": round(r, 4), "mean_matched_iou": round(miou, 4),
            "serve_boxes": k, "exact_topk": etk,
            "exact_total": int(len(exact_sets[stem][0])),
        })
    return rows


def run(detector, pages, page_hw, num_regions, iou_floor=0.5, full=False,
        exact=None) -> dict:
    """The JAX script's record for ``detector`` on ``pages``; ``exact`` is
    an ``exact_chain`` result to reuse (run here when None)."""
    import numpy as np
    import torch

    exact_sets, exact_s = exact or exact_chain(detector, pages)
    results = {}
    for variant, letterbox, edge_filter, cap, f32 in VARIANTS:
        fn = detect_fn(detector, page_hw, num_regions, letterbox=letterbox,
                       edge_filter=edge_filter, candidate_cap=cap,
                       resize_dtype=torch.float32 if f32 else torch.bfloat16)
        t_variant = time.time()
        rows = page_rows(serve_sets(fn, pages, detector.device), exact_sets, iou_floor)
        results[variant] = {
            "pages": rows,
            **{key: round(float(np.mean([r[key] for r in rows])), 4)
               for key in ("precision", "recall_topk", "mean_matched_iou")},
            "seconds_incl_compile": round(time.time() - t_variant, 1),
        }
    cfg = detector.config
    return {
        "metric": "serve-vs-exact detection parity (same deterministic weights; exact = "
        "stage1-3 chain, serve = fused detect program)",
        "config": {
            "full": full,
            "image_size": cfg.image_size,
            "variant": cfg.variant,
            "grids": list(map(list, cfg.grid_configs)),
            "page_hw": list(page_hw),
            "num_regions": num_regions,
            "iou_floor": iou_floor,
            "backend": detector.device.type,
        },
        "exact_chain_seconds": round(exact_s, 1),
        **results,
        "measured": time.strftime("%Y-%m-%d"),
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="the production configuration (on the card)")
    parser.add_argument("--pages", type=int, default=3)
    parser.add_argument("--iou-floor", type=float, default=0.5)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--out", default=None, help="also write the JSON record here")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    page_hw, num_regions, detector = setup(args.full, args.device)
    out = run(detector, make_pages(page_hw, args.pages), page_hw, num_regions,
              args.iou_floor, args.full)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
