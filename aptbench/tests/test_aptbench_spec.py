"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file."""

import json
import re
from pathlib import Path

import pytest

from aptbench import spec

ROOT = spec.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "aptbench/run.py"] and BENCH["paths"] == ["aptbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for k in ("configs", "workloads") for x in BENCH[k]]
                         + [m["name"] for m in METRICS])
def test_names_use_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_fields(m):
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert Path(spec.HERE / "metrics" / f"{m['name']}.py").exists()
    for w in m.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}
    if m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    else:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


def test_uniques_and_setup():
    for k in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[k]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files_and_metrics(cell):
    sp = spec.Spec(ROOT)
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    config = sp.config(cell["config"])
    traffic = sp.traffic(cell["traffic"])
    assert (spec.HERE / "entries" / f"{traffic['entry']}.py").exists()
    limits = sp.limits(cell["name"])
    assert set(limits) == {"px_gap", "rows_off_pct", "passes_failed"} and limits["passes_failed"] == 0
    e2e = [m["name"] for m in sp.metrics_for(cell["name"], "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = sp.metrics_for(cell["name"], "per_layer")
    assert layer and all(m["moves"] in e2e for m in layer)
    assert config["sample_rate"] > 0 and config["profile"]["work_rate"] % 4160 == 0


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("aptbench/") and (ROOT / c["file"]).exists()
    assert len(c["reduced"]) <= 16 and 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_every_cell_uses_a_config_and_each_config_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
