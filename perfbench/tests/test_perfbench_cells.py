"""The harness finds every cell, configuration, traffic mix, driver and
metric by name from the data files, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import os
import re

import pytest

from benchlib.cells import HERE, ROOT, load_cell

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert all(NAME.match(n) for n in names), names
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["name"].endswith(".page") or m["name"].endswith(".parse")


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = load_cell(name)
    assert cell.driver().Session
    assert cell.generator().make
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
        if "workloads" in m:
            assert name in m["workloads"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(ROOT, config["file"])
    assert path.startswith(HERE + os.sep) and os.path.exists(path)
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
    assert len(config["source"]) <= 200 and len(config["reduced"]) <= 16


def test_free_text_fields():
    texts = [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
    texts += [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_metric_file_is_listed():
    listed = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "metrics")) if f.endswith(".py")}
    assert files == listed
