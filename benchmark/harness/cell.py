"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration (``benchmark/configs/<config>.json``), its traffic mix
(``benchmark/traffic/<traffic>.json``), its limits
(``benchmark/cells/<cell>.json``), and each metric's reader
(``benchmark/metrics/<metric>.py``).  A later cell, mix, configuration or
metric is new files and new entries only."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


class Cell:
    def __init__(self, name: str, root: str = ROOT):
        man = manifest(root)
        found = [w for w in man["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        conf = [c for c in man["configs"] if c["name"] == self.entry["config"]][0]
        self.config = _json(os.path.relpath(os.path.join(root, conf["file"]), BENCH))
        self.traffic = _json("traffic", self.entry["traffic"] + ".json")
        self.limits = _json("cells", name + ".json")["limits"]
        self.end_to_end = [m for m in man["end_to_end"] if _in_cell(m, name)]
        self.per_layer = [m for m in man["per_layer"] if _in_cell(m, name)]

    def loop(self, seed: int, device):
        """The traffic's loop (``benchmark/harness/<loop>.py``'s ``Loop``)
        over this cell's configuration."""
        mod = importlib.import_module("benchmark.harness." + self.traffic["loop"])
        return mod.Loop(self.config, self.traffic, seed, device, self.chips)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
