"""The parity harness and its CLI: the port against the JAX package.

1. ``analysis/parity.py`` is a verbatim copy (sources equal) and gives JAX's
   answers: ``match_boxes`` on JAX's cases, ``compare_detection_dirs`` on a
   synthetic stage-3 JSON tree (shifted boxes, a class flip, a page without
   classes, a missing page, an extra page, an empty page) and
   ``compare_embedding_stores`` on two stores written once and opened by each
   package (noisy rows, a row deleted from the candidate, an extra row): the
   summaries are equal, float for float.
2. ``cli/parity.py`` prints JAX's headline JSON with JAX's exit code in all
   four modes on the same inputs: ``boxes``, ``embeddings`` and
   ``acts-compare`` (a passing and a diverging pair) byte for byte;
   ``acts-dump`` with the same keys and output shape (the two packages draw
   different random weights, and the port has no raw-conv layers, so the
   layer counts differ).
"""

import dataclasses
import inspect
import json
import os

import numpy as np
import pytest

from multimodal_embeddings_tpu.analysis import parity as jp
from multimodal_embeddings_tpu.cli import parity as jcli
from multimodal_embeddings_tpu.store import embedding_store as jstore
from multimodal_embeddings_tpu_torch.analysis import parity as tp
from multimodal_embeddings_tpu_torch.cli import parity as tcli
from multimodal_embeddings_tpu_torch.store import embedding_store as tstore


@pytest.mark.parametrize("name", ["BoxParity", "match_boxes", "compare_detection_dirs",
                                  "compare_embedding_stores"])
def test_sources_equal(name):
    assert inspect.getsource(getattr(tp, name)) == inspect.getsource(getattr(jp, name))


def _box_cases():
    rng = np.random.default_rng(0)
    ref = rng.uniform(0, 500, size=(12, 2)).repeat(2, axis=1) + [0, 0, 40, 30]
    cand = ref + rng.normal(scale=3, size=ref.shape)
    classes = rng.integers(0, 3, 12).astype(float)
    return {
        "identical": (ref, ref, {}),
        "shifted": (np.array([[0, 0, 10, 10.]]), np.array([[1, 0, 11, 10.]]), {}),
        "one_to_one": (np.array([[0, 0, 10, 10.]]),
                       np.array([[0, 0, 10, 10], [0.5, 0, 10.5, 10]]), {}),
        "class_blocked": (np.array([[0, 0, 10, 10.]]), np.array([[0, 0, 10, 10.]]),
                          {"classes_ref": np.array([1.0]), "classes_cand": np.array([2.0])}),
        "empty": (np.zeros((0, 4)), np.zeros((0, 4)), {}),
        "empty_candidate": (ref, np.zeros((0, 4)), {}),
        "disjoint_floor_0": (np.array([[0, 0, 10, 10.]]), np.array([[100, 100, 110, 110.]]),
                             {"iou_floor": 0.0}),
        "noisy_class_aware": (ref, cand[::-1], {"classes_ref": classes,
                                                "classes_cand": classes[::-1]}),
        "noisy_floor_0.9": (ref, cand, {"iou_floor": 0.9}),
    }


@pytest.mark.parametrize("case", sorted(_box_cases()))
def test_match_boxes_equals_jax(case):
    ref, cand, kw = _box_cases()[case]
    got, want = tp.match_boxes(ref, cand, **kw), jp.match_boxes(ref, cand, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _stage3_tree(root):
    """Reference and candidate ``*_combined.json`` folders."""
    rng = np.random.default_rng(1)
    ref_dir, cand_dir = os.path.join(root, "ref"), os.path.join(root, "cand")
    os.makedirs(ref_dir)
    os.makedirs(cand_dir)
    for i in range(6):
        n = 8 + i
        boxes = rng.uniform(0, 1500, size=(n, 2)).repeat(2, axis=1) + rng.uniform(20, 200, (n, 4)) * [0, 0, 1, 1]
        classes = rng.integers(0, 10, n).astype(float)
        ref = {"boxes": boxes.tolist(), "classes": classes.tolist(), "scores": [0.9] * n}
        cand_boxes = boxes + rng.normal(scale=2.0, size=boxes.shape)
        cand_classes = classes.copy()
        cand_classes[0] = (cand_classes[0] + 1) % 10  # one class flip
        cand = {"boxes": cand_boxes[: n - 1].tolist(), "classes": cand_classes[: n - 1].tolist()}
        if i == 2:
            cand.pop("classes")  # a page without classes: matched class-agnostically
        if i == 4:
            cand = {"boxes": [], "classes": []}  # an empty page
        name = f"page{i}_combined.json"
        with open(os.path.join(ref_dir, name), "w") as f:
            json.dump(ref, f)
        if i != 5:  # a missing page
            with open(os.path.join(cand_dir, name), "w") as f:
                json.dump(cand, f)
    with open(os.path.join(cand_dir, "extra_combined.json"), "w") as f:
        json.dump({"boxes": [[0, 0, 5, 5], [1, 1, 9, 9]]}, f)
    return ref_dir, cand_dir


@pytest.mark.parametrize("kw", [{}, {"class_aware": False}, {"iou_floor": 0.8}])
def test_compare_detection_dirs_equals_jax(tmp_path, kw):
    ref_dir, cand_dir = _stage3_tree(str(tmp_path))
    got = tp.compare_detection_dirs(ref_dir, cand_dir, **kw)
    want = jp.compare_detection_dirs(ref_dir, cand_dir, **kw)
    assert got == want
    assert got["missing_candidates"] == ["page5_combined.json"]
    assert got["extra_candidates"] == ["extra_combined.json"]
    assert 0 < got["recall"] < 1 and 0 < got["precision"] < 1


def _stores(root):
    """Two stores written by the port: the candidate holds noisy copies of
    the reference rows, minus one deleted row, plus one extra."""
    rng = np.random.default_rng(2)
    _, ref = tstore.initialize_db(os.path.join(root, "ref_db"), device="cpu")
    _, cand = tstore.initialize_db(os.path.join(root, "cand_db"), device="cpu")
    for i in range(7):
        e = rng.normal(size=32).astype(np.float32)
        ref.upsert(ids=[f"r{i}"], embeddings=[e / np.linalg.norm(e)])
        noisy = e + rng.normal(scale=1e-2, size=32).astype(np.float32)
        cand.upsert(ids=[f"r{i}"], embeddings=[noisy / np.linalg.norm(noisy)])
    cand.delete(["r3"])
    cand.upsert(ids=["extra"], embeddings=[np.ones(32, np.float32) / np.sqrt(32)])
    return os.path.join(root, "ref_db"), os.path.join(root, "cand_db")


def test_compare_embedding_stores_equals_jax(tmp_path):
    ref_db, cand_db = _stores(str(tmp_path))
    got = tp.compare_embedding_stores(tstore.initialize_db(ref_db, device="cpu")[1],
                                      tstore.initialize_db(cand_db, device="cpu")[1])
    want = jp.compare_embedding_stores(jstore.initialize_db(ref_db)[1],
                                       jstore.initialize_db(cand_db)[1])
    assert got == want
    assert got["missing"] == ["r3"] and got["count"] == 6
    assert 0.99 < got["min_cosine"] < 1.0


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out[-1]


def test_cli_boxes_and_embeddings_print_jax_headlines(tmp_path, capsys):
    ref_dir, cand_dir = _stage3_tree(str(tmp_path))
    for extra in ([], ["--class_agnostic", "--iou_floor", "0.7"]):
        argv = ["boxes", ref_dir, cand_dir, *extra]
        assert _run(tcli, argv, capsys) == _run(jcli, argv, capsys)
    ref_db, cand_db = _stores(str(tmp_path))
    rc, line = _run(tcli, ["embeddings", ref_db, cand_db, "--device", "cpu",
                           "--out", str(tmp_path / "e.json")], capsys)
    assert (rc, line) == _run(jcli, ["embeddings", ref_db, cand_db], capsys)
    assert json.load(open(tmp_path / "e.json"))["missing"] == ["r3"]


def test_cli_acts_modes_print_jax_headlines(tmp_path, capsys):
    """``acts-dump`` of the tiny detector in each package, then
    ``acts-compare`` of the same JSON pairs through both CLIs: equal
    headlines and exit codes, 1 where a layer diverges."""
    port_json, jax_json = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    dump = ["acts-dump", "--family", "detector", "--variant", "n", "--imgsz", "64"]
    rc, line = _run(tcli, [*dump, "--out", port_json, "--device", "cpu"], capsys)
    jrc, jline = _run(jcli, [*dump, "--out", jax_json], capsys)
    got, want = json.loads(line), json.loads(jline)
    assert rc == jrc == 0
    assert list(got) == list(want) and got["output_shape"] == want["output_shape"] == [1, 8, 8, 64]
    assert got["out"] == port_json and 0 < got["layers"] < want["layers"]
    bad = json.load(open(port_json))
    bad["layers"][next(iter(bad["layers"]))]["mean"] += 100.0
    bad_json = str(tmp_path / "bad.json")
    with open(bad_json, "w") as f:
        json.dump(bad, f)
    for pair, code in (([port_json, port_json], 0), ([bad_json, port_json], 1),
                       ([jax_json, port_json], None)):
        rc, line = _run(tcli, ["acts-compare", *pair], capsys)
        assert (rc, line) == _run(jcli, ["acts-compare", *pair], capsys)
        if code is not None:
            assert rc == code
    assert json.loads(line)["layers_compared"] == got["layers"]
