"""Shared fixtures of the benchmark's own tests (CPU, small sizes)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def tiny_traffic(monkeypatch):
    """Every traffic mix cut to two passes of 30-42 s, so that a whole run
    fits a CPU test."""
    from aptbench import spec

    orig = spec.Spec.traffic

    def tiny(name):
        t = orig(name)
        t["pool"], t["minutes"] = 2, [0.5, 0.7]
        return t

    monkeypatch.setattr(spec.Spec, "traffic", staticmethod(tiny))


@pytest.fixture
def cli_home(tmp_path, monkeypatch):
    """The CLI's settings file and the runs' scratch in the test's directory."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "config"))
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    return tmp_path
