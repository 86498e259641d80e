"""One run of one cell: set-up, the measured window, the reading of the
trace, the check against the reference, and the result line.

:func:`run_cell` takes the device as an argument so that the tests can
drive a whole run on the CPU; ``run.py`` always asks for the card.
"""

from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import spec as spec_mod
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "noaa_apt_tpu")
PROGRAM = "noaa_apt_tpu_torch"


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden import, ...)."""


@dataclass
class Run:
    """What an entry driver is handed."""

    config: dict
    passes: list  # gen.pool.Pass, in the seed's order
    pool_dir: Path
    workdir: Path
    extra_args: list  # appended to every CLI call (``--device cpu`` in the tests)
    rng: np.random.Generator


@dataclass
class Context:
    """What a metric's reader reads."""

    passes: list  # one record per pass attempted in the window
    window_s: float
    setup_s: float
    trace: trace_mod.Trace | None = None
    peaks: dict | None = None
    geometry: list = field(default_factory=list)  # per pass of the window, for the rooflines

    def median(self, key: str, scale: float = 1.0):
        vals = [p[key] for p in self.passes if p.get(key) is not None and p["ok"]]
        return float(np.median(vals)) * scale if vals else None

    def roofline(self, kernels) -> float | None:
        """100 x the least time the card could take for ``kernels``' work
        in the window (the larger of operations over the peak rate and
        bytes over the peak bandwidth) over their measured device time."""
        if self.trace is None or self.peaks is None or not self.geometry:
            return None
        counts = spec_mod.rooflines()
        measured = sum(self.trace.kernel_seconds(counts[k].NAMES) for k in kernels)
        if measured <= 0:
            return None
        bound = 0.0
        for k in kernels:
            if self.trace.kernel_seconds(counts[k].NAMES) <= 0:
                continue  # a kernel off the path bounds nothing
            for g in self.geometry:
                flops, n_bytes = counts[k].count(g)
                bound += max(flops / self.peaks["fp32_flops_per_s"], n_bytes / self.peaks["bytes_per_s"])
        return 100.0 * bound / measured


def process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return max(0.0, float(Path("/proc/uptime").read_text().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def geometry(config: dict, n_samples: int, rows: int | None) -> dict:
    """The sizes a kernel's count of operations and bytes is worked out from."""
    from .reference import dsp

    t = dsp.design(config["profile"], int(config["sample_rate"]))
    n_work = t.work_len(n_samples)
    g = t.template.shape[0]
    spr, _, max_peaks = dsp.selector_params(n_work, t.work_rate)
    return {"n_in": n_samples, "in_bytes": 2, "l": t.l, "m": t.m,
            "taps_per_output": t.taps_per_output(), "n_work": n_work, "fir_taps": int(t.taps.shape[0]),
            "sync_len": int(g), "n_valid": max(0, n_work - g), "spr": spr, "max_peaks": max_peaks,
            "rows": rows or 0}


def compare(config: dict, items, failed: int, device) -> dict:
    """The numbers compared over ``items``, ``(pass, image or None)``:
    each image against the reference decode of its pass's samples,
    computed in float64 on ``device``.

    - ``px_gap``: the widest u8 gap of a pixel (``reference/judge.py``);
    - ``rows_off_pct``: rows matched only by a shift or a resync, and rows
      too many or too few, per hundred of the reference's rows;
    - ``passes_failed``: ``failed`` (passes of the window that gave no
      PNG) and the items with no image (exact: limit 0)."""
    import torch

    from .gen.pool import read_wav
    from .reference import decode as ref_decode
    from .reference.judge import judge

    px_gap, off, rows = 0, 0, 0
    for p, img in items:
        if img is None:
            failed += 1
            continue
        ref = ref_decode.decode(read_wav(p.path), p.rate, config["profile"], config["percent"],
                                dtype=torch.float64, device=device)
        j = judge(img() if callable(img) else img, ref)
        px_gap = max(px_gap, j["px_gap"])
        off += j["rows_off"]
        rows += max(j["rows"], 1)
        del ref
    return {"px_gap": px_gap, "rows_off_pct": 100.0 * off / rows if rows else 0.0, "passes_failed": failed}


def decide(got: dict, limits: dict) -> tuple[dict, bool]:
    """Each number of :func:`compare` beside its limit, and whether every
    one lies within it: the one decision of ``correct``, for a run and for
    the control alike."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def check_correct(run: Run, outputs: list, failed: int, limits: dict, device) -> tuple[dict, bool]:
    """:func:`decide` on :func:`compare` over the kept PNGs."""
    from .pngread import read_png

    items = [(p, (lambda f=png: read_png(f)) if png is not None and Path(png).exists() else None)
             for p, png in outputs]
    return decide(compare(run.config, items, failed, device), limits)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             age0: float = 0.0, t0: float | None = None, min_calls: int = 0) -> dict:
    """One run of ``workload``; returns the result line's object.  The
    window lasts ``seconds`` and at least ``min_calls`` calls (the tests'
    short windows on a loaded CPU ask for one call per pass)."""
    t0 = time.perf_counter() if t0 is None else t0
    sp = spec_mod.Spec(root)
    cell = sp.cell(workload)
    config = sp.config(cell["config"])
    traffic = sp.traffic(cell["traffic"])
    limits = sp.limits(workload)
    entry_mod = sp.entry(traffic["entry"])

    marks = [("start", time.perf_counter())]
    import torch

    marks.append(("torch", time.perf_counter()))
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available: this benchmark runs only on the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{workload} needs {cell['chips']} cards, {torch.cuda.device_count()} visible")
    workdir = Path(tempfile.mkdtemp(prefix="aptbench-", dir=os.environ.get("TMPDIR")))
    os.environ["XDG_CONFIG_HOME"] = str(workdir / "config")  # the CLI's settings file
    try:
        marks.append(("cuda check", time.perf_counter()))
        program = __import__(PROGRAM)
        marks.append(("program", time.perf_counter()))
        if not Path(program.__file__).resolve().is_relative_to(Path(root).resolve()):
            raise Refused(f"{PROGRAM} was imported from {program.__file__}, outside {root}")
        from .gen.pool import make_pool

        dev = torch.device(device)
        t_pool = time.perf_counter()
        passes = make_pool(workdir / "pool", seed, config, traffic, dev)
        t_pool = time.perf_counter() - t_pool
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run = Run(config, passes, workdir / "pool", workdir,
                  [] if device == "cuda" else ["--device", device],
                  np.random.default_rng([int(seed) % (1 << 64), 0x61707462]))
        entry = entry_mod.Entry(run)
        t_warm = time.perf_counter()
        entry.warm()
        t_warm = time.perf_counter() - t_warm
        setup_s = age0 + time.perf_counter() - t0

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        calls, spans = [], []
        deadline = time.perf_counter() + seconds
        try:
            i = 0
            while time.perf_counter() < deadline or i < min_calls:
                rec = entry.call(i, record=trace)
                calls.append(rec)
                spans.extend(rec["spans"])
                i += 1
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        window_s = calls[-1]["t1"] - calls[0]["t0"]
        memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        outputs = entry.outputs()
        entry.close()
        del entry
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        pass_recs = [p for c in calls for p in c["passes"]]
        failed = sum(1 for p in pass_recs if not p["ok"])
        stages = {k: np.median([p[k] for p in pass_recs if p.get(k) is not None]) * 1e3
                  for k in ("wall_s", "load_s", "decode_s", "finish_s", "save_s", "device_s", "encode_s")
                  if any(p.get(k) is not None for p in pass_recs)}
        print("aptbench: per-pass medians (ms): " + ", ".join(f"{k[:-2]} {v:.2f}" for k, v in stages.items()),
              file=sys.stderr)
        ctx = Context(pass_recs, window_s, setup_s)
        png_bytes = [p["png_bytes"] for p in pass_recs if p.get("png_bytes")]
        print(f"aptbench: PNGs of the window: {len(png_bytes)}, {sum(png_bytes)} bytes, "
              f"{ctx.median('png_bytes_per_row')} bytes per row (median)", file=sys.stderr)
        dev_info = {"platform": "gpu" if device == "cuda" else device,
                    "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                    "count": int(cell["chips"]) if device == "cuda" else 0,
                    "memory_peak_bytes": int(memory_peak)}
        if prof is not None:
            ctx.trace = trace_mod.from_profiler(prof, spans)
            del prof
            ctx.peaks = spec_mod.peaks(dev_info["kind"])
            ctx.geometry = [geometry(config, p["n_samples"], p.get("rows")) for p in pass_recs if p["ok"]]
            dev_info["busy_s"] = ctx.trace.busy_s
            dev_info["window_s"] = ctx.trace.window_s
            dev_info["power_limit"] = power_limit()
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in sp.metrics_for(workload, kind):
            v = sp.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        t_check = time.perf_counter()
        checks, correct = check_correct(run, outputs, failed, limits, dev)
        print(f"aptbench: {workload} seed {seed}: set-up {setup_s:.2f} s, window {window_s:.2f} s "
              f"({len(calls)} calls), check {time.perf_counter() - t_check:.2f} s; set-up's pool "
              f"{t_pool:.2f} s, warm-up {t_warm:.2f} s, before the harness {age0 + marks[0][1] - t0:.2f} s, "
              + ", ".join(f"{b[0]} {b[1] - a[1]:.2f} s" for a, b in zip(marks, marks[1:])), file=sys.stderr)
        result = {"correct": correct, "attempted": len(pass_recs), "failed": failed,
                  "metrics": metrics, "device": dev_info}
        if ctx.trace is not None:
            result["breakdown"] = {"device_ops": ctx.trace.device_ops(), "idle_gaps": ctx.trace.idle_gaps()}
        result["checks"] = checks
        found = forbidden_modules()
        if found:
            raise Refused(f"the process loaded {', '.join(found)}")
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
