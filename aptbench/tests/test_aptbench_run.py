"""``run.py`` as a check runs it: on the card it prints one result line;
without a card, or without the program beside it, it prints none and
exits with another code than 0."""

import json
import shutil
import subprocess
import sys

import pytest

from aptbench import spec

ROOT = spec.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "aptbench/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def test_without_a_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run(ROOT, "--workload", "sdr48k_std.single", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "CUDA is not available" in r.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "aptbench", tmp_path / "aptbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    r = run(tmp_path, "--workload", "sdr48k_std.single", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_on_the_card(card, cell, traced):
    r = run(ROOT, "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "3", "--trace", str(traced))
    assert r.returncode == 0, r.stderr[-4000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in spec.Spec(ROOT).metrics_for(cell, kind)}
    assert set(result["metrics"]) == want
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in result["metrics"].items() if "roofline" in k)
