"""``BENCHMARK.json`` and the files it names, found by name.

A workload entry names its configuration and its traffic mix; the
configuration's entry names its file, the mix is
``olabench/traffic/<traffic>.json`` and every metric is read by
``olabench/metrics/<name>.py``.  Adding a configuration, a mix or a metric
means adding files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re

#: the folder of the harness, and the checkout's root above it
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # BENCHMARK.json metric entries of this cell
    per_layer: list


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read(root: str, path: str) -> dict:
    with open(os.path.join(root, path)) as f:
        return json.load(f)


def read_config(name: str) -> dict:
    """A configuration file of ``olabench/configs`` by its name, whether or
    not a cell of ``BENCHMARK.json`` runs it."""
    return _read(HERE, os.path.join("configs", f"{name}.json"))


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_module(name: str) -> str:
    return "metrics." + re.sub(r"[^A-Za-z0-9_]", "_", name)


def cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root, configs[w["config"]]["file"])
    traffic = _read(HERE, os.path.join("traffic", f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if reports(m, name)])


def reader(metric: dict):
    """The ``read(record) -> float | None`` of a metric."""
    return importlib.import_module(metric_module(metric["name"])).read
