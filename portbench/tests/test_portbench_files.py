"""The benchmark's data files: ``BENCHMARK.json`` against the contract's
shape, and every configuration, traffic mix, entry and metric it names
present and loadable."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_the_contract_keys(section):
    for e in BENCH[section]:
        extra = set(e) - KEYS[section] - ({"workloads"} if section in (
            "end_to_end", "per_layer") else set())
        assert not extra and KEYS[section] <= set(e), (section, e["name"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key]), e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    plan = harness.cell_plan(BENCH, cell)
    importlib.import_module(f"portbench.entries.{plan.traffic['entry']}")
    assert plan.cell["chips"] == 1
    assert any(m["name"] == "setup_s" for m in plan.end_to_end)
    assert len(plan.end_to_end) >= 2 and plan.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]]
                         + [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_metric(metric).read)


def test_configs_state_their_source_and_cuts():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and cfg["assumed"]
        assert set(cfg["check"]["limits"]) and cfg["check"]["sample"] > 0


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", cells), (m["name"], cell)


def test_bounds_within_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
