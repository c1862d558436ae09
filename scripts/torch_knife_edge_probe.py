#!/usr/bin/env python3
"""The knife-edge probe of the port's serve-vs-exact recall gap, the twin of
``scripts/knife_edge_probe.py`` with its flags, experiments and result keys.

Some of the exact chain's top-K boxes have no serve match. The diagnosis
under test: these are cross-view duplicates at the combine NMS's IoU-0.5
knife edge, not a coordinate bug. Three experiments, with the detector and
pages of ``scripts/torch_serve_parity.py``:

  1. **ε-perturbation**: the serve path at combine IoU 0.48, 0.50 and 0.52,
     and the number of kept boxes that flip between them;
  2. **host f64 re-merge**: the serve path's pre-combine candidate set
     (``build_fused_detect_fn(return_candidates=True)``) re-merged by the
     exact host greedy NMS (``ops/nms.py::greedy_nms_host``, the native
     build), and the recall of the exact top-K against every kept candidate
     (``uncut_candidate_recall_topk``);
  3. **unmatched-IoU histogram**: for every unmatched exact top-K box at IoU
     0.50, its best same-class IoU against the serve set.

    python3 scripts/torch_knife_edge_probe.py --full            # on the card
    python3 scripts/torch_knife_edge_probe.py --device cpu      # reduced, here

The script prints one JSON object, ``{"knife_edge": ...}`` with the keys of
the JAX record's ``"knife_edge"`` section, and writes it only to ``--out``:
``SERVE_PARITY.json`` is the JAX package's record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_serve_parity import (  # noqa: E402
    detect_fn,
    exact_chain,
    iou_matrix,
    make_pages,
    match_sets,
    serve_sets,
    setup,
)

CANDIDATE_CAP = 4


def unmatched_best_ious(serve, exact, iou_floor=0.5):
    """Best same-class IoU to ANY serve box, for each exact top-K box that
    the greedy matcher left unmatched."""
    import numpy as np

    sboxes, sscores, sclasses = serve
    eboxes, escores, eclasses = exact
    if len(sboxes) == 0 or len(eboxes) == 0:
        return []
    k = len(sboxes)
    top = np.argsort(-escores, kind="stable")[:k]
    ious = iou_matrix(
        np.asarray(sboxes, np.float64), np.asarray(eboxes, np.float64)
    )
    same = np.asarray(sclasses)[:, None] == np.asarray(eclasses)[None, :]
    cand = np.where(same, ious, 0.0)
    # replicate the greedy matching to find the unmatched top-K set
    order = np.argsort(-np.asarray(sscores), kind="stable")
    taken = np.zeros(len(eboxes), bool)
    matched = set()
    for i in order:
        row = np.where(taken, 0.0, cand[i])
        j = int(np.argmax(row))
        if row[j] >= iou_floor:
            taken[j] = True
            matched.add(j)
    return [
        round(float(cand[:, j].max()), 4) for j in top if j not in matched
    ]


def run(detector, pages, page_hw, num_regions, iou_floor=0.5, full=False,
        exact=None) -> dict:
    """The JAX record's ``"knife_edge"`` section for ``detector`` on
    ``pages``; ``exact`` is an ``exact_chain`` result to reuse."""
    import numpy as np
    import torch

    from multimodal_embeddings_tpu_torch.ops.nms import greedy_nms_host

    exact_sets = (exact or exact_chain(detector, pages))[0]

    def eval_serve(serve_by_page):
        rows = []
        for stem, serve in serve_by_page.items():
            p, r, miou, _, _ = match_sets(serve, exact_sets[stem], iou_floor=iou_floor)
            rows.append({"page": stem, "precision": round(p, 4), "recall_topk": round(r, 4),
                         "mean_matched_iou": round(miou, 4)})
        return {"pages": rows, **{
            key: round(float(np.mean([r[key] for r in rows])), 4)
            for key in ("precision", "recall_topk", "mean_matched_iou")}}

    results = {}

    # experiment 1: the combine-IoU ε sweep
    kept_sets = {}
    for eps_name, ciou in (("iou_048", 0.48), ("iou_050", 0.50), ("iou_052", 0.52)):
        fn = detect_fn(detector, page_hw, num_regions, letterbox=True, edge_filter=True,
                       candidate_cap=CANDIDATE_CAP, combine_iou=ciou)
        serve_by_page = serve_sets(fn, pages, detector.device)
        results[eps_name] = eval_serve(serve_by_page)
        kept_sets[eps_name] = {stem: {tuple(np.round(b, 2)) for b in s[0]}
                               for stem, s in serve_by_page.items()}
        if eps_name == "iou_050":
            hist = []
            for stem, serve in serve_by_page.items():
                hist.extend(unmatched_best_ious(serve, exact_sets[stem], iou_floor=iou_floor))
            results["unmatched_best_iou_at_050"] = sorted(hist)

    # keep-set flip counts between ε variants: the knife population size
    flips = {}
    for a, b in (("iou_048", "iou_050"), ("iou_050", "iou_052")):
        flips[f"{a}_vs_{b}_boxes_flipped"] = sum(
            len(kept_sets[a][s] ^ kept_sets[b][s]) for s in kept_sets[a])
    results["eps_flips"] = flips

    # experiment 2: the host f64 re-merge of the serve candidates
    cand_fn = detect_fn(detector, page_hw, num_regions, letterbox=True, edge_filter=True,
                        candidate_cap=CANDIDATE_CAP, return_candidates=True)
    serve_by_page = {}
    uncut_recalls = []
    for i, page in enumerate(pages):
        cb, cs, cc = cand_fn(torch.from_numpy(page).to(detector.device))
        cb = cb.float().cpu().numpy().astype(np.float64)
        cs = cs.float().cpu().numpy().astype(np.float64)
        cc = cc.cpu().numpy()
        live = cs > 0
        cb, cs, cc = cb[live], cs[live], cc[live]
        keep = greedy_nms_host(cb, cs, cc, iou_threshold=0.5)
        serve_by_page[f"page{i:02d}"] = (
            cb[keep[:num_regions]], cs[keep[:num_regions]], cc[keep[:num_regions]])
        # UNCUT: exact top-K vs every host-kept candidate — separates
        # "lost at the top-K score boundary" from "not detected / box off"
        eb, es, ec = exact_sets[f"page{i:02d}"]
        top = np.argsort(-es, kind="stable")[:num_regions]
        ious = iou_matrix(cb[keep], eb[top])
        same = cc[keep][:, None] == ec[top][None, :]
        hit = (np.where(same, ious, 0.0) >= iou_floor).any(axis=0)
        uncut_recalls.append(float(hit.mean()))
    results["host_remerge"] = eval_serve(serve_by_page)
    results["host_remerge"]["uncut_candidate_recall_topk"] = round(
        float(np.mean(uncut_recalls)), 4)

    # the verdict
    base = results["iou_050"]["recall_topk"]
    remerge = results["host_remerge"]["recall_topk"]
    moved = (abs(results["iou_048"]["recall_topk"] - base)
             + abs(results["iou_052"]["recall_topk"] - base))
    results["interpretation"] = {
        "recall_gap_at_050": round(1.0 - base, 4),
        "recall_gap_after_host_f64_remerge": round(1.0 - remerge, 4),
        "recall_moved_by_eps": round(moved, 4),
        "diagnosis_confirmed": bool(remerge >= base and (moved > 0.0 or remerge > base)),
    }
    cfg = detector.config
    return {
        "config": {"full": full, "image_size": cfg.image_size, "variant": cfg.variant,
                   "pages": len(pages), "candidate_cap": CANDIDATE_CAP},
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
    out = {"knife_edge": run(detector, make_pages(page_hw, args.pages), page_hw, num_regions,
                             args.iou_floor, args.full)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
