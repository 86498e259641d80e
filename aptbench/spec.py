"""Where the benchmark finds each of its parts, by the names in
``BENCHMARK.json``: a configuration's file (``configs/<name>.json``), a
traffic mix (``traffic/<name>.json``), the entry driver the mix names
(``entries/<entry>.py``), a metric's reader (``metrics/<name>.py``), a
kernel's count of operations and bytes (``roofline/<kernel>.py``) and a
cell's correctness limits (``limits/<cell>.json``).  Adding any of them
is adding a file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """The module in ``path``, loaded under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """``BENCHMARK.json`` and what it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    @staticmethod
    def traffic(name: str) -> dict:
        return load_json(HERE / "traffic" / f"{name}.json")

    @staticmethod
    def entry(name: str):
        return load_module(HERE / "entries" / f"{name}.py", f"aptbench_entry_{name}")

    @staticmethod
    def limits(cell: str) -> dict:
        return load_json(HERE / "limits" / f"{cell}.json")

    @staticmethod
    def reader(metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py", f"aptbench_metric_{metric.replace('.', '_')}")

    def metrics_for(self, cell: str, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
        return [m for m in self.bench[kind] if "workloads" not in m or cell in m["workloads"]]


def rooflines() -> dict:
    """kernel name -> its count module, for every file in ``roofline/``."""
    return {p.stem: load_module(p, f"aptbench_roofline_{p.stem}")
            for p in sorted((HERE / "roofline").glob("*.py"))}


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named ``device_name``, or None."""
    table = load_json(HERE / "roofline" / "peaks.json")
    return table.get(device_name)
