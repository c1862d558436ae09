"""Parity measurement harness, in the port.

A copy of ``multimodal_embeddings_tpu/analysis/parity.py`` (the functions
verbatim; ``tests/test_torch_parity.py`` holds the sources and the answers
equal) over the port's ``ops/iou.py``, ``io/json_io.py`` and
``store/embedding_store.py`` (the same ``collection.npz`` format).

BASELINE.json's accuracy targets — bbox IoU ≥ 0.99 and embedding cosine
≥ 0.999 against the reference — need a measurement tool: given a directory
of reference outputs and a directory of ours, compute the match statistics.

* ``match_boxes``: greedy best-IoU assignment between two box sets (each
  reference box matched to the highest-IoU unmatched candidate), returning
  per-match IoU, precision/recall at an IoU floor, and mean matched IoU.
* ``compare_detection_dirs``: pairs same-named regions/combined JSONs from
  two directories and aggregates box parity.
* ``compare_embedding_stores``: pairwise cosine between same-id embeddings
  of two stores.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_embeddings_tpu_torch.io.json_io import load_json
from multimodal_embeddings_tpu_torch.io.logging_setup import get_logger
from multimodal_embeddings_tpu_torch.ops.iou import iou_matrix_np

logger = get_logger("parity")


@dataclasses.dataclass
class BoxParity:
    n_reference: int
    n_candidate: int
    n_matched: int
    mean_matched_iou: float
    precision: float
    recall: float
    per_match_iou: List[float]


def match_boxes(
    reference: np.ndarray,
    candidate: np.ndarray,
    iou_floor: float = 0.5,
    classes_ref: Optional[np.ndarray] = None,
    classes_cand: Optional[np.ndarray] = None,
) -> BoxParity:
    """Greedy best-IoU one-to-one assignment (highest IoU pairs first)."""
    ref = np.asarray(reference, np.float64).reshape(-1, 4)
    cand = np.asarray(candidate, np.float64).reshape(-1, 4)
    if ref.shape[0] == 0 or cand.shape[0] == 0:
        return BoxParity(
            ref.shape[0], cand.shape[0], 0, 0.0,
            0.0 if cand.shape[0] else 1.0,
            0.0 if ref.shape[0] else 1.0,
            [],
        )
    iou = iou_matrix_np(ref, cand)
    if classes_ref is not None and classes_cand is not None:
        same = (
            np.asarray(classes_ref).reshape(-1, 1)
            == np.asarray(classes_cand).reshape(1, -1)
        )
        iou = np.where(same, iou, 0.0)

    matched_iou: List[float] = []
    used_ref = np.zeros(ref.shape[0], bool)
    used_cand = np.zeros(cand.shape[0], bool)
    flat = np.argsort(-iou, axis=None)
    for idx in flat:
        i, j = np.unravel_index(idx, iou.shape)
        # zero-IoU pairs (disjoint or class-masked) are never matches, even
        # at iou_floor=0
        if iou[i, j] <= 0.0 or iou[i, j] < iou_floor:
            break
        if used_ref[i] or used_cand[j]:
            continue
        used_ref[i] = used_cand[j] = True
        matched_iou.append(float(iou[i, j]))

    n_matched = len(matched_iou)
    return BoxParity(
        n_reference=ref.shape[0],
        n_candidate=cand.shape[0],
        n_matched=n_matched,
        mean_matched_iou=float(np.mean(matched_iou)) if matched_iou else 0.0,
        precision=n_matched / cand.shape[0],
        recall=n_matched / ref.shape[0],
        per_match_iou=matched_iou,
    )


def compare_detection_dirs(
    reference_dir: str,
    candidate_dir: str,
    iou_floor: float = 0.5,
    class_aware: bool = True,
) -> Dict:
    """Aggregate box parity across same-named JSONs of two directories."""
    ref_files = {
        os.path.basename(p): p
        for p in glob.glob(os.path.join(reference_dir, "*.json"))
    }
    results: Dict[str, BoxParity] = {}
    all_ious: List[float] = []
    total_ref = total_cand = total_matched = 0
    missing = []
    class_gating_skipped = []
    for name, ref_path in sorted(ref_files.items()):
        cand_path = os.path.join(candidate_dir, name)
        ref = load_json(ref_path)
        if not os.path.exists(cand_path):
            # missing pages still count: their reference boxes are unmatched
            missing.append(name)
            total_ref += len(ref.get("boxes", []))
            continue
        cand = load_json(cand_path)
        if class_aware and not (ref.get("classes") and cand.get("classes")):
            class_gating_skipped.append(name)
        parity = match_boxes(
            np.asarray(ref.get("boxes", [])),
            np.asarray(cand.get("boxes", [])),
            iou_floor=iou_floor,
            classes_ref=np.asarray(ref.get("classes", []))
            if class_aware and ref.get("classes")
            else None,
            classes_cand=np.asarray(cand.get("classes", []))
            if class_aware and cand.get("classes")
            else None,
        )
        results[name] = parity
        all_ious.extend(parity.per_match_iou)
        total_ref += parity.n_reference
        total_cand += parity.n_candidate
        total_matched += parity.n_matched

    # candidate-only pages count against precision (hallucinated output)
    extra_candidates = []
    for path in glob.glob(os.path.join(candidate_dir, "*.json")):
        name = os.path.basename(path)
        if name not in ref_files:
            extra_candidates.append(name)
            total_cand += len(load_json(path).get("boxes", []))

    if class_gating_skipped:
        logger.warning(
            "class-aware parity requested but %d pages lack 'classes' — "
            "those pages matched class-agnostically", len(class_gating_skipped)
        )
    summary = {
        "pages": len(results),
        "missing_candidates": missing,
        "extra_candidates": extra_candidates,
        "class_gating_skipped": class_gating_skipped,
        "total_reference_boxes": total_ref,
        "total_candidate_boxes": total_cand,
        "total_matched": total_matched,
        "mean_matched_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        "recall": total_matched / total_ref if total_ref else 0.0,
        "precision": total_matched / total_cand if total_cand else 0.0,
        "per_page": {
            name: {
                "mean_iou": p.mean_matched_iou,
                "recall": p.recall,
                "precision": p.precision,
            }
            for name, p in results.items()
        },
    }
    return summary


def compare_embedding_stores(
    reference_collection, candidate_collection
) -> Dict:
    """Cosine similarity between same-id embeddings of two collections."""
    ref = reference_collection.get(include=("embeddings",))
    cosines: List[float] = []
    missing = []
    for item_id, emb in zip(ref["ids"], ref.get("embeddings", [])):
        cand = candidate_collection.get(ids=[item_id], include=("embeddings",))
        if not cand["ids"] or not cand.get("embeddings") or not cand["embeddings"][0]:
            missing.append(item_id)
            continue
        a = np.asarray(emb, np.float64)
        b = np.asarray(cand["embeddings"][0], np.float64)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        cosines.append(float(a @ b / denom) if denom > 0 else 0.0)
    return {
        "count": len(cosines),
        "missing": missing,
        "mean_cosine": float(np.mean(cosines)) if cosines else 0.0,
        "min_cosine": float(np.min(cosines)) if cosines else 0.0,
        "p01_cosine": float(np.percentile(cosines, 1)) if cosines else 0.0,
    }
