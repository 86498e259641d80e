"""Entry driver ``fleet``: an archive decoded a directory at a time.

Each call is one ``noaa_apt_tpu_torch.cli.main([pool_dir, "-o", out_dir,
"-q", ...])``: directory mode, which runs ``serve.decode_fleet`` (loader
threads, the device thread, encoder threads) over every WAV of the pool
and writes grey PNGs and ``fleet_report.json``.  Calls run back to back
(closed loop), so each call's pipeline fill and drain counts.  Every call
writes into a directory of its own (writing over the last call's files
would wait on their writeback instead).  One call, a uniform draw from
the seed (a reservoir of one), is kept for the check; the others'
outputs are deleted once the window has closed.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time


class Entry:
    label = "fleet_call"

    def __init__(self, run):
        from noaa_apt_tpu_torch import cli

        self.cli = cli
        self.run = run
        self.out = run.workdir / "fleet_out"
        self.kept = None  # output directory of the kept call
        self.n_calls = 0
        self.sink = open(os.devnull, "w")

    def _main(self, out, report: dict) -> int:
        argv = [str(self.run.pool_dir), "-o", str(out), "-q", *self.run.config["cli_args"],
                *self.run.extra_args]
        with contextlib.redirect_stdout(self.sink):
            return self.cli.main(argv, report=report)

    def warm(self) -> None:
        """One call over the pool: every shape the window uses."""
        rc = self._main(self.out / "warm", {})
        if rc != 0:
            raise RuntimeError(f"warm-up fleet call returned {rc}")

    def call(self, i: int, record: bool = False) -> dict:
        rep: dict = {}
        out = self.out / str(i)
        t0 = time.perf_counter_ns()
        if record:
            from torch.profiler import record_function

            with record_function(self.label):
                rc = self._main(out, rep)
        else:
            rc = self._main(out, rep)
        t1 = time.perf_counter_ns()
        fleet = rep.get("fleet")
        results = {r.input_path.name: r for r in (fleet.results if fleet is not None else [])}
        recs = []
        for p in self.run.passes:
            r = results.get(p.path.name)
            ok = r is not None and r.error is None and r.output_path is not None and r.output_path.exists()
            png_bytes = r.output_path.stat().st_size if ok else None
            rows = r.n_rows if r is not None else None
            recs.append({"ok": ok, "n_samples": p.n_samples, "recorded_s": p.seconds, "rows": rows,
                         "png_bytes": png_bytes,
                         "png_bytes_per_row": png_bytes / rows if png_bytes and rows else None,
                         **{k: (getattr(r, k) if r is not None else None)
                            for k in ("load_s", "ingest_s", "device_s", "fetch_s", "encode_s")}})
        self.n_calls += 1
        if rc == 0 and self.run.rng.random() * self.n_calls < 1.0:
            self.kept = out
        return {"t0": t0 / 1e9, "t1": t1 / 1e9, "passes": recs, "spans": [(self.label, t0, t1, True)]}

    def outputs(self) -> list:
        """``(pass, PNG of the kept call or None)`` for every pass of the
        pool; a pass that the kept call's ``fleet_report.json`` lists as
        failed, or does not list, has no PNG."""
        report = self.kept / "fleet_report.json" if self.kept is not None else None
        if report is None or not report.exists():
            return [(p, None) for p in self.run.passes]
        rep = json.loads(report.read_text())
        listed = {os.path.basename(e["input"]): e["output"] for e in rep.get("passes", [])}
        failed = {os.path.basename(e["input"]) for e in rep.get("failed", [])}
        out = []
        for p in self.run.passes:
            name = p.path.name
            ok = name in listed and name not in failed
            out.append((p, self.kept / f"{p.path.stem}.png" if ok else None))
        return out

    def close(self) -> None:
        """Delete every call's output but the kept one's."""
        self.sink.close()
        for d in self.out.iterdir():
            if d != self.kept:
                shutil.rmtree(d, ignore_errors=True)
