"""A cell found by name: its entry in ``BENCHMARK.json``, its workload file,
its configuration file, its traffic mix and generator, its driver, and the
metrics it reports. Everything that belongs to one configuration, traffic
mix or per-layer metric is a file of its own under ``perfbench/``:

- ``configs/<config>.json`` (names its ``driver``),
- ``workloads/<cell>.json`` (the cell's options and correctness limits),
- ``traffic/<traffic>.json`` (names its generator ``kind``) and
  ``traffic/<kind>.py``,
- ``drivers/<driver>.py``,
- ``metrics/<metric>.py`` (``read(ctx)`` → a number, or None where the run
  has nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # perfbench/
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the BENCHMARK.json workload entry
    config: dict
    workload: dict
    traffic: dict
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def driver(self):
        return importlib.import_module("drivers." + self.config["driver"])

    def generator(self):
        kind = self.traffic["kind"]
        return load_module(os.path.join(HERE, "traffic", kind + ".py"), "perfbench_traffic_" + kind)

    def metric_reader(self, name: str):
        return load_module(os.path.join(HERE, "metrics", name + ".py"),
                           "perfbench_metric_" + name.replace(".", "_"))


def _applies(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, benchmark_path: str = None) -> Cell:
    bench = load_json(benchmark_path or os.path.join(ROOT, "BENCHMARK.json"))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[entry["config"]]["file"]))
    workload = load_json(os.path.join(HERE, "workloads", name + ".json"))
    traffic = load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, entry, config, workload, traffic, e2e, per_layer)
