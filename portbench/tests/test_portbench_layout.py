"""The benchmark finds every configuration, cell, driver and metric by its
name, and BENCHMARK.json keeps to the benchmark's contract."""
import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell, cfg, driver = harness.cell_files(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell["name"] == name == entry["traffic"]
    assert cell["config"] == entry["config"] and cell["chips"] == entry["chips"]
    assert cell["why"] == entry["why"] and len(entry["why"]) <= 200
    assert callable(driver.setup) and callable(driver.control_readings)
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert json.loads((harness.ROOT / conf["file"]).read_text()) == cfg
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", METRICS)
def test_metric_found_by_name(name):
    mod = harness.load_module(harness.BENCH / "metrics" / f"{name}.py")
    assert callable(mod.read)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_what_it_must(name):
    e2e, layer = harness.cell_metrics(BENCH, name)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    assert all(m["moves"] in names for m in layer)


def test_names_units_and_entries():
    seen = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
