"""BENCHMARK.json against the benchmark's contract, and every file a cell
or a metric names found by name."""
import json
import re

import pytest

from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found_by_name(cell):
    files = common.cell_files(BENCH, cell["name"])
    assert files["config"]["name"] == cell["config"]
    assert files["traffic"]["kind"] in ("train", "serve")
    assert files["limits_path"].exists()
    assert json.loads(files["limits_path"].read_text())["limits"]
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    for m in common.cell_metrics(BENCH, cell["name"], trace=True):
        assert (common.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_names_units_and_moves():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in common.cell_metrics(BENCH, cell["name"], trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert common.cell_metrics(BENCH, cell["name"], trace=True)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((common.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    sizes = common.model_sizes(cfg["config"], {"batch": 1})
    assert common.formula(cfg["flops"]["train_example"], sizes) > 0
