"""Stages 2-5 of the numbered chain and stage 1's artifact writer: the port
against the JAX package, on the CPU.

* The host copies (``ops/{widths,peaks,columns}.py``, ``utils/colormap.py``,
  ``greedy_nms_np``, ``iou_matrix_np``, ``internal_edge_mask_np`` and the
  stage functions without a ``try``) have the JAX sources, and their results
  are JAX's bit for bit in float64; ``greedy_nms_host`` (the native kernel)
  keeps ``greedy_nms_np``'s indices.
* One synthetic stage-1 tree (full-page JSONs and 2×2 / 3×3 grid-info JSONs,
  boxes from a seed, boxes on internal edges and overlaps across grids, a
  malformed JSON, a grid JSON without its page, a page whose scan is
  missing, a broken stage-3 and stage-4 file) goes through JAX's
  ``run_edge_filter_stage``, ``run_combine_stage``, ``run_median_stage`` and
  ``run_columns_stage`` and the port's, each in its own working folder:
  equal ``StageStats``, equal log lines, equal file lists, every file
  byte-identical — once with cv2 drawing (JPEG bytes equal too) and once
  with cv2 taken away from both packages (no visualizations in either).
* ``write_page_artifacts`` on the same ``(full_regions, per_grid)``: equal
  file lists, byte-identical JSON and images, with cv2 and without it (cell
  images then written by PIL in both).
"""

import dataclasses
import inspect
import json
import logging
import os
import sys

import numpy as np
import pytest
from PIL import Image

from multimodal_embeddings_tpu.analysis import visualization as jviz
from multimodal_embeddings_tpu.io import images as jimages
from multimodal_embeddings_tpu.ops import columns as jcolumns
from multimodal_embeddings_tpu.ops import edge_filter as jedge
from multimodal_embeddings_tpu.ops import grid as jgrid
from multimodal_embeddings_tpu.ops import iou as jiou
from multimodal_embeddings_tpu.ops import nms as jnms
from multimodal_embeddings_tpu.ops import peaks as jpeaks
from multimodal_embeddings_tpu.ops import widths as jwidths
from multimodal_embeddings_tpu.pipeline import detect as jdetect
from multimodal_embeddings_tpu.pipeline import stages as jstages
from multimodal_embeddings_tpu.utils import colormap as jcolormap
from multimodal_embeddings_tpu_torch.config import ID_TO_NAMES as CLASS_NAMES
from multimodal_embeddings_tpu_torch.io import images as timages
from multimodal_embeddings_tpu_torch.ops import columns as tcolumns
from multimodal_embeddings_tpu_torch.ops import edge_filter as tedge
from multimodal_embeddings_tpu_torch.ops import grid as tgrid
from multimodal_embeddings_tpu_torch.ops import iou as tiou
from multimodal_embeddings_tpu_torch.ops import nms as tnms
from multimodal_embeddings_tpu_torch.ops import peaks as tpeaks
from multimodal_embeddings_tpu_torch.ops import widths as twidths
from multimodal_embeddings_tpu_torch.pipeline import detect as tdetect
from multimodal_embeddings_tpu_torch.pipeline import stages as tstages
from multimodal_embeddings_tpu_torch.utils import colormap as tcolormap

COPIES = [
    (jwidths, twidths, "bin_widths"), (jwidths, twidths, "median_from_bins"),
    (jwidths, twidths, "plain_text_widths"),
    (jpeaks, tpeaks, "gaussian_window"), (jpeaks, tpeaks, "smooth_density"),
    (jpeaks, tpeaks, "_local_maxima"), (jpeaks, tpeaks, "_select_by_distance"),
    (jpeaks, tpeaks, "peak_prominences"), (jpeaks, tpeaks, "find_peaks_np"),
    (jcolumns, tcolumns, "build_density_map"),
    (jcolumns, tcolumns, "column_widths_from_peaks"),
    (jcolumns, tcolumns, "find_column_centers"),
    (jcolormap, tcolormap, "colormap"),
    (jnms, tnms, "greedy_nms_np"), (jiou, tiou, "iou_matrix_np"),
    (jedge, tedge, "internal_edge_mask_np"),
    (jstages, tstages, "StageStats"), (jstages, tstages, "_json_files"),
    (jstages, tstages, "_cell_bounds"), (jstages, tstages, "_page_size_for_grid"),
    (jstages, tstages, "edge_filter_regions"), (jstages, tstages, "edge_filter_grid_info"),
    (jstages, tstages, "group_jsons_by_image"), (jstages, tstages, "run_combine_stage"),
    (jstages, tstages, "median_width_for_json"),
    (jstages, tstages, "find_matching_median_json"), (jstages, tstages, "columns_for_page"),
    (jdetect, tdetect, "process_page"), (jdetect, tdetect, "write_page_artifacts"),
]


@pytest.mark.parametrize("jmod,tmod,name", COPIES,
                         ids=[f"{t.__name__.split('.')[-1]}.{n}" for _, t, n in COPIES])
def test_host_copy_has_the_jax_source(jmod, tmod, name):
    assert inspect.getsource(getattr(tmod, name)) == inspect.getsource(getattr(jmod, name))


def _boxes(rng, n, size=300.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(5, 80, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("class_aware", [True, False])
def test_greedy_nms_equal_jax(seed, class_aware):
    """Scores drawn from 8 values, so ties are common (first index wins);
    duplicated boxes overlap exactly."""
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, 60)
    boxes[30:40] = boxes[:10] + rng.uniform(-3, 3, (10, 4))
    scores = rng.integers(0, 8, 60) / 8.0
    classes = rng.integers(0, 3, 60).astype(np.float64) if class_aware else None
    want = jnms.greedy_nms_np(boxes, scores, classes, 0.5)
    np.testing.assert_array_equal(tnms.greedy_nms_np(boxes, scores, classes, 0.5), want)
    got = tnms.greedy_nms_host(boxes, scores, classes, 0.5)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()
    assert tnms.greedy_nms_host(np.zeros((0, 4)), np.zeros(0)).tolist() == []


@pytest.mark.parametrize("seed", range(3))
def test_iou_and_edge_mask_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    assert np.array_equal(tiou.iou_matrix_np(a, b), jiou.iou_matrix_np(a, b))
    assert np.array_equal(tiou.iou_matrix_np(a), jiou.iou_matrix_np(a))
    for bounds in ((0, 0, 150, 160), (140, 0, 300, 160), (140, 150, 310, 300)):
        for threshold in (10.0, 0.0):
            want = jedge.internal_edge_mask_np(a, bounds, 300, 300, threshold)
            assert np.array_equal(tedge.internal_edge_mask_np(a, bounds, 300, 300, threshold),
                                  want)


@pytest.mark.parametrize("seed", range(5))
def test_widths_peaks_columns_equal_jax_bit_for_bit(seed):
    """float64 results equal, not close: the same host math."""
    rng = np.random.default_rng(seed)
    page_w = int(rng.integers(300, 3000))
    widths = list(rng.uniform(20, page_w / 3, 40))
    widths += widths[:5]
    for margin in (0.2, 5.0):
        jb = jwidths.bin_widths(widths, margin, page_w)
        tb = twidths.bin_widths(widths, margin, page_w)
        assert list(tb.items()) == list(jb.items())
        assert twidths.median_from_bins(tb) == jwidths.median_from_bins(jb)
    x = np.convolve(rng.uniform(0, 1, 500), np.ones(9) / 9, mode="same")
    x[100:110] = x[100]  # a plateau
    kw = dict(height=0.2, distance=7.5, prominence=0.05)
    jp, jprops = jpeaks.find_peaks_np(x, **kw)
    tp, tprops = tpeaks.find_peaks_np(x, **kw)
    assert np.array_equal(tp, jp) and tprops.keys() == jprops.keys()
    for key in jprops:
        assert np.array_equal(tprops[key], jprops[key])
    n_cols = int(rng.integers(2, 7))
    col_w = page_w / n_cols
    boxes, names, scores = [], [], []
    for c in range(n_cols):
        for _ in range(8):
            x0 = c * col_w + rng.uniform(0, 0.1 * col_w)
            y0 = rng.uniform(0, 2000)
            boxes.append([x0, y0, x0 + rng.uniform(0.6, 0.9) * col_w, y0 + 40])
            names.append(str(rng.choice(["plain_text", "title", "figure"])))
            scores.append(float(rng.uniform(0.1, 1.0)))
    median = float(np.median([b[2] - b[0] for b in boxes]))
    want = jcolumns.find_column_centers(boxes, names, scores, page_w, 2200, median)
    got = tcolumns.find_column_centers(boxes, names, scores, page_w, 2200, median)
    assert got == want and len(want[0]) > 0
    jd = jcolumns.build_density_map(boxes, page_w, median)
    td = tcolumns.build_density_map(boxes, page_w, median)
    assert np.array_equal(td[0], jd[0]) and td[1] == jd[1]
    assert np.array_equal(tcolormap.colormap(256, True), jcolormap.colormap(256, True))


# -- one synthetic stage-1 tree through both packages' stages 2-5 ----------

PAGE_W, PAGE_H = 320, 240


def _page_boxes(rng):
    """Three text columns of plain_text boxes, a title and a figure, in page
    coordinates; scores on a coarse grid so that some tie."""
    boxes, classes = [], []
    for c, x0 in enumerate((12.0, 118.0, 222.0)):
        y = 30.0
        while y < PAGE_H - 30:
            h = float(rng.integers(12, 30))
            w = float(rng.uniform(78, 92))
            boxes.append([x0 + rng.uniform(0, 4), y, x0 + w, y + h])
            classes.append(1)
            y += h + float(rng.integers(4, 10))
    boxes.append([20.0, 4.0, 300.0, 26.0])
    classes.append(0)
    boxes.append([130.0, 120.0, 200.0, 170.0])
    classes.append(3)
    scores = list(rng.integers(2, 20, len(boxes)) / 20.0)
    return boxes, classes, scores


def _regions(image_path, w, h, boxes, classes, scores):
    return {
        "image_path": image_path,
        "image_size": {"width": w, "height": h},
        "parameters": {"conf_threshold": 0.1, "iou_threshold": 0.45},
        "boxes": [[float(v) for v in b] for b in boxes],
        "classes": [float(c) for c in classes],
        "scores": [float(s) for s in scores],
        "class_names": [CLASS_NAMES[int(c)] for c in classes],
    }


def _write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def make_stage1_tree(root, pages_dir, seed=0):
    """``root/1_doclayout_parsed/json``: per page the full-page JSON and a
    2×2 and 3×3 grid-info JSON (cells with local boxes, ``boxes_original``
    jittered from the page's boxes, and boxes on internal edges), then the
    bad inputs."""
    rng = np.random.default_rng(seed)
    json_dir = os.path.join(root, "1_doclayout_parsed", "json")
    for p in range(3):
        base = f"page_{p}"
        image_path = os.path.join(pages_dir, f"{base}.png")
        if p < 2:  # page_2's scan is missing
            pixels = rng.integers(150, 255, (PAGE_H, PAGE_W, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(image_path)
        boxes, classes, scores = _page_boxes(rng)
        _write_json(os.path.join(json_dir, f"{base}.json"),
                    _regions(image_path, PAGE_W, PAGE_H, boxes, classes, scores))
        for rows, cols in ((2, 2), (3, 3)):
            cells = tgrid.grid_cells(PAGE_W, PAGE_H, rows, cols, 20.0)
            info = {"original_image_path": image_path,
                    "grid_config": {"rows": rows, "cols": cols, "overlap_percentage": 20.0},
                    "cells": []}
            for cell in cells:
                cb, cc, cs = [], [], []
                for box, cls, score in zip(boxes, classes, scores):
                    x0, y0 = max(box[0], cell.x_start), max(box[1], cell.y_start)
                    x1, y1 = min(box[2], cell.x_end), min(box[3], cell.y_end)
                    if x1 - x0 < 4 or y1 - y0 < 4:
                        continue
                    jitter = rng.uniform(-2, 2, 4)
                    cb.append([x0 + jitter[0], y0 + jitter[1], x1 + jitter[2], y1 + jitter[3]])
                    cc.append(cls)
                    cs.append(float(min(1.0, score + rng.integers(-1, 2) / 20.0)))
                # one box hugging the cell's right edge and one its bottom edge
                cb.append([cell.x_end - 30, cell.y_start + 5, cell.x_end - 3, cell.y_start + 25])
                cb.append([cell.x_start + 5, cell.y_end - 20, cell.x_start + 40, cell.y_end - 2])
                cc += [1, 1]
                cs += [0.9, 0.35]
                local = [[b[0] - cell.x_start, b[1] - cell.y_start,
                          b[2] - cell.x_start, b[3] - cell.y_start] for b in cb]
                name = f"{base}_row{cell.row}_col{cell.col}"
                regions = _regions(os.path.join(pages_dir, "cells", f"{name}.png"),
                                   int(cell.x_end - cell.x_start),
                                   int(cell.y_end - cell.y_start), local, cc, cs)
                info["cells"].append({
                    "cell_path": regions["image_path"],
                    "cell_json_path": f"grid/{name}.json",
                    "cell_coordinates": cell.coordinates,
                    "row": cell.row,
                    "col": cell.col,
                    "regions": {**{k: regions[k] for k in
                                   ("boxes", "classes", "scores", "class_names")},
                                "boxes_original": [[float(v) for v in b] for b in cb]},
                })
            _write_json(os.path.join(json_dir, f"{base}_grid_{rows}x{cols}.json"), info)
    # a malformed JSON; a grid JSON whose page has neither a scan nor cells
    with open(os.path.join(json_dir, "broken.json"), "w") as f:
        f.write("{not json")
    _write_json(os.path.join(json_dir, "lost_grid_2x2.json"),
                {"original_image_path": "/nowhere/lost.png",
                 "grid_config": {"rows": 2, "cols": 2, "overlap_percentage": 20.0},
                 "cells": []})


def _tree(root):
    """{relpath: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.lines = []

    def emit(self, record):
        if record.name.startswith("mmtpu.stages"):
            self.lines.append((record.levelname, record.getMessage()))


def _run_stages(stages_mod, workdir, inject):
    """Stages 2-5 of one package in ``workdir`` (relative folders, so the
    JSON paths are the same strings for both packages)."""
    os.chdir(workdir)
    logger = logging.getLogger("mmtpu")
    records = _Records()
    logger.addHandler(records)
    stats = [stages_mod.run_edge_filter_stage("1_doclayout_parsed", "2_edge_box_filtered")]
    stats.append(stages_mod.run_combine_stage("2_edge_box_filtered", "3_combined_bboxes"))
    inject("3")
    stats.append(stages_mod.run_median_stage("3_combined_bboxes", "4_medians_extracted"))
    stats.append(stages_mod.run_median_stage("3_combined_bboxes", "4b_medians_all",
                                             require_image=False))
    inject("4")
    stats.append(stages_mod.run_columns_stage("3_combined_bboxes", "4_medians_extracted",
                                              "5_column_detection"))
    stats.append(stages_mod.run_columns_stage("3_combined_bboxes", "4b_medians_all",
                                              "5b_column_detection"))
    logger.removeHandler(records)
    with pytest.raises(json.JSONDecodeError):  # skip_errors=False raises the file's error
        stages_mod.run_edge_filter_stage("1_doclayout_parsed", "2x", skip_errors=False)
    return [dataclasses.asdict(s) for s in stats], records.lines


def _inject(step):
    """Bad inputs for stages 4 and 5: a stage-3 file that does not parse,
    one without plain_text (median 0), and a median JSON that does not
    parse."""
    if step == "3":
        with open("3_combined_bboxes/json/zz_broken_combined.json", "w") as f:
            f.write("[1, 2")
        doc = json.load(open("3_combined_bboxes/json/page_0_combined.json"))
        keep = [i for i, n in enumerate(doc["class_names"]) if n != "plain_text"]
        for key in ("boxes", "classes", "scores", "class_names"):
            doc[key] = [doc[key][i] for i in keep]
        _write_json("3_combined_bboxes/json/yy_notext_combined.json", doc)
        doc = json.load(open("3_combined_bboxes/json/page_1_combined.json"))
        _write_json("3_combined_bboxes/json/ww_combined.json", doc)
    else:
        for folder in ("4_medians_extracted", "4b_medians_all"):
            with open(f"{folder}/json/ww_combined_median_width.json", "w") as f:
                f.write("{")


@pytest.mark.parametrize("with_cv2", [True, False])
def test_stages_2_to_5_write_the_jax_tree(tmp_path, monkeypatch, with_cv2):
    if not with_cv2:  # each package's own way of finding cv2 absent
        monkeypatch.setattr(jimages, "cv2", None)
        monkeypatch.setattr(jviz, "cv2", None)
        monkeypatch.setitem(sys.modules, "cv2", None)
    pages = tmp_path / "pages"
    pages.mkdir()
    for name in ("jax", "torch"):
        make_stage1_tree(str(tmp_path / name), str(pages))
    monkeypatch.chdir(tmp_path)
    jstats, jlines = _run_stages(jstages, str(tmp_path / "jax"), _inject)
    tstats, tlines = _run_stages(tstages, str(tmp_path / "torch"), _inject)
    assert tstats == jstats
    assert tlines == jlines
    # every stage counted something of each kind the bad inputs cause
    assert jstats[0]["errors"] == 2 and jstats[2] == {"processed": 4, "errors": 1, "skipped": 1}
    assert jstats[4]["errors"] == 1 and jstats[4]["skipped"] >= 1
    jtree, ttree = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(ttree) == sorted(jtree)
    for name in jtree:
        assert ttree[name] == jtree[name], name
    jpgs = [n for n in jtree if n.endswith(".jpg")]
    assert bool(jpgs) == with_cv2
    assert len([n for n in jtree if n.startswith("5_column_detection/json")]) == 2


# -- stage 1's artifact writer ------------------------------------------------


def _per_grid(grid_mod, rng, image_path, w, h):
    per_grid = []
    for rows, cols in ((2, 2), (3, 3)):
        cells = grid_mod.grid_cells(w, h, rows, cols, 20.0)
        cell_regions = []
        for cell in cells:
            x0, y0, x1, y1 = cell.slice_bounds
            boxes = _boxes(rng, 5, size=min(x1 - x0, y1 - y0) - 40)
            classes = rng.integers(0, 10, 5)
            regions = _regions(image_path, x1 - x0, y1 - y0, boxes, classes, rng.uniform(0, 1, 5))
            regions["cell_coordinates"] = cell.coordinates
            regions["original_image_path"] = image_path
            regions["boxes_original"] = grid_mod.translate_boxes(regions["boxes"], cell)
            regions["grid_info"] = {"rows": rows, "cols": cols, "row": cell.row, "col": cell.col}
            cell_regions.append(regions)
        per_grid.append(((rows, cols), cells, cell_regions))
    return per_grid


@pytest.mark.parametrize("with_cv2", [True, False])
@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_write_page_artifacts_equal_jax(tmp_path, monkeypatch, with_cv2, ext):
    if not with_cv2:
        monkeypatch.setattr(jimages, "cv2", None)
        monkeypatch.setattr(jviz, "cv2", None)
        monkeypatch.setitem(sys.modules, "cv2", None)
    h, w = 230, 310
    image_path = str(tmp_path / f"scan{ext}")
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        image_path)
    for name, mod, grid_mod in (("jax", jdetect, jgrid), ("torch", tdetect, tgrid)):
        rng = np.random.default_rng(7)
        full = _regions(image_path, w, h, _boxes(rng, 6, size=200), [1, 0, 3, 1, 1, 5],
                        rng.uniform(0, 1, 6))
        per_grid = _per_grid(grid_mod, rng, image_path, w, h)
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert mod.write_page_artifacts(image_path, "out", full, per_grid, 20.0) is True
        mod.write_page_artifacts(image_path, "out_bare", full, per_grid, 20.0,
                                 save_cell_images=False, save_visualizations=False)
    jtree, ttree = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert sorted(ttree) == sorted(jtree)
    assert sum(n.startswith("out/grid_3x3/images/") for n in jtree) == 9
    assert any(n.endswith("_viz.jpg") for n in jtree) == with_cv2
    for name in jtree:
        assert ttree[name] == jtree[name], name


def test_image_io_equal_jax(tmp_path, monkeypatch):
    """``load_image_bgr``/``load_image_gray``/``save_image_bgr``: cv2's
    branch, then PIL's (cv2 absent from both packages)."""
    arr = np.random.default_rng(1).integers(0, 255, (41, 29, 3), dtype=np.uint8)
    src = str(tmp_path / "a.png")
    Image.fromarray(arr).save(src)
    for with_cv2 in (True, False):
        if not with_cv2:
            monkeypatch.setattr(jimages, "cv2", None)
            monkeypatch.setitem(sys.modules, "cv2", None)
            assert timages.cv2_module() is None
        np.testing.assert_array_equal(timages.load_image_bgr(src), jimages.load_image_bgr(src))
        np.testing.assert_array_equal(timages.load_image_gray(src), jimages.load_image_gray(src))
        bgr = jimages.load_image_bgr(src)
        for ext in (".png", ".jpg"):
            jpath, tpath = (str(tmp_path / f"{n}{with_cv2}" / f"x{ext}") for n in "jt")
            jimages.save_image_bgr(jpath, bgr)
            timages.save_image_bgr(tpath, bgr)
            assert open(tpath, "rb").read() == open(jpath, "rb").read()
