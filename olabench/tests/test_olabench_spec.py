"""BENCHMARK.json against the contract it is written to, and every name in
it resolved to its file."""

import importlib
import json
import os
import re

import pytest

from harness import spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per_tok)")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_text(w) for w in BENCH["command"])
    for word in BENCH["command"][1:]:
        if os.sep in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_a_full_check_of_24_cells_fits():
    s = BENCH["run_seconds"]
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert _text(entry["source"]) and _text(entry["why"])
    assert any(entry["file"].startswith(p + "/") for p in BENCH["paths"])
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
    # the configuration states its reference and its check's limits
    importlib.import_module(f"reference.{cfg['reference']}")
    assert set(cfg["check"]) == {"unanswered", "over_eps", "off_4hw_pct"}
    assert 0 < cfg["control"]["confidence"] < cfg["guarantees"]["confidence"]
    assert cfg["server"]["measured_rates"] is None
    assert cfg["server"]["rates_path"] is None


def test_configs_used_and_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and _text(w["why"])
    cell = spec.cell(BENCH, w["name"])
    importlib.import_module(f"generators.{cell.traffic['generator']}")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                      "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_moves_a_metric_its_cells_report(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                      "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and _text(m["layer"])
    assert m["source"] in ("device_trace", "program_span",
                           "program_counter", "host_clock")
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        if spec.reports(m, w["name"]):
            assert spec.reports(e2e[m["moves"]], w["name"])
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_layers_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for name in layers:
        assert name == name.strip()


def test_setup_s_is_reported_everywhere():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25
