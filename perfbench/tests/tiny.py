"""Tiny cells for the CPU tests: the harness's real files with the
configuration cut to sizes a CPU test holds."""

from __future__ import annotations

import copy
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from benchlib.cells import load_cell  # noqa: E402

TINY_PAGE = {
    "dtype": "float32",
    "detector": {"variant": "n", "imgsz": 64, "grids": [[2, 2]], "max_det": 40},
    "regions": 4,
    "vision": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text": {"vocab_size": 64, "max_len": 8, "width": 32, "layers": 1, "heads": 2},
    "embed_dim": 32,
    "head_fit": {"view_boxes": {"1": 6, "0": 2}, "logit_std": 3.0, "views": 0},
}


TINY_PARSE = {
    "dtype": "float32",
    "image_pad_id": 301,
    "eos_id": 300,
    "max_new_tokens": 8,
    "text": {"vocab_size": 512, "hidden": 64, "layers": 2, "heads": 4, "kv_heads": 2,
             "head_dim": 16, "mlp_hidden": 128, "max_len": 512, "mrope_section": [2, 3, 3]},
    "vision": {"width": 32, "layers": 2, "heads": 2, "fullatt_block_indexes": [1]},
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def tiny_cell(name: str = "vitb16_doclayout_m.stream"):
    cell = load_cell(name)
    if cell.config["driver"] == "page":
        cell.config = _merge(cell.config, TINY_PAGE)
        cell.traffic = dict(cell.traffic, page_hw=[120, 90], pool=4)
        cell.workload = dict(cell.workload, bucket=[128, 96], check_pages=2)
    elif cell.config["driver"] == "parse":
        cell.config = _merge(cell.config, TINY_PARSE)
        cell.traffic = dict(cell.traffic, page_hw=[112, 84], pool=3, stop_range=[2, 6],
                            queue_len=5)
        cell.workload = dict(cell.workload, rows=2, chunk=4, max_new_tokens=8, check_pages=3,
                             ref_batch=2, control_queue=4)
    return cell
