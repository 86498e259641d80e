"""Entry driver ``single``: a station decodes each recording as it lands.

Each call is one ``noaa_apt_tpu_torch.cli.main([wav, "-o", png, "-q",
...])`` over the pool, in turn, each waiting for the last (closed loop,
one client): the CLI's serial path from the WAV on disk to the PNG on
disk.  Every call writes a PNG of its own, as a station names each
pass's image after its recording (writing over the last call's file
would wait on that file's writeback instead).  Of each pass's calls one,
a uniform draw from the seed (a reservoir of one), is kept for the check;
the others are deleted once the window has closed.
"""

from __future__ import annotations

import contextlib
import os
import time

STAGES = ("load", "decode", "finish", "save")


class Entry:
    label = "pass"

    def __init__(self, run):
        from noaa_apt_tpu_torch import cli

        self.cli = cli
        self.run = run
        self.out = run.workdir / "out"
        self.out.mkdir()
        self.calls = [0] * len(run.passes)
        self.kept: dict = {}  # pass -> PNG of its kept call
        self.sink = open(os.devnull, "w")

    def _main(self, k: int, png, report: dict) -> int:
        p = self.run.passes[k]
        argv = [str(p.path), "-o", str(png), "-q",
                *self.run.config["cli_args"], *self.run.extra_args]
        with contextlib.redirect_stdout(self.sink):
            return self.cli.main(argv, report=report)

    def warm(self) -> None:
        """One call per pass of the pool: every shape the window uses."""
        for k, p in enumerate(self.run.passes):
            rc = self._main(k, self.out / f"warm.{p.path.stem}.png", {})
            if rc != 0:
                raise RuntimeError(f"warm-up decode of {self.run.passes[k].path.name} returned {rc}")

    def call(self, i: int, record: bool = False) -> dict:
        k = i % len(self.run.passes)
        p = self.run.passes[k]
        png = self.out / f"{i}.{p.path.stem}.png"
        rep: dict = {}
        t0 = time.perf_counter_ns()
        if record:
            from torch.profiler import record_function

            with record_function(self.label):
                rc = self._main(k, png, rep)
        else:
            rc = self._main(k, png, rep)
        t1 = time.perf_counter_ns()
        ok = rc == 0 and png.exists()
        spans = [(self.label, t0, t1, True)]
        if ok:
            # The CLI's own steps, laid back from the call's end (the save
            # ends as the call returns).
            end = t1
            for stage in reversed(STAGES):
                a = end - int(rep[f"{stage}_s"] * 1e9)
                spans.append((f"cli.{stage}", a, end, False))
                end = a
            spans.append(("cli.args_settings", t0, end, False))
            self.calls[k] += 1
            if self.run.rng.random() * self.calls[k] < 1.0:
                self.kept[k] = png
        stage_ms = rep.get("stage_ms") or {}
        png_bytes = png.stat().st_size if ok else None
        rows = rep.get("rows")
        rec = {"ok": ok, "n_samples": p.n_samples, "recorded_s": p.seconds, "wall_s": (t1 - t0) / 1e9,
               "rows": rows, "stage_ms": stage_ms, "png_bytes": png_bytes,
               "png_bytes_per_row": png_bytes / rows if png_bytes and rows else None,
               **{f"{s}_s": rep.get(f"{s}_s") for s in STAGES}}
        return {"t0": t0 / 1e9, "t1": t1 / 1e9, "passes": [rec], "spans": spans}

    def outputs(self) -> list:
        """``(pass, kept PNG or None)`` for every pass of the pool."""
        return [(p, self.kept.get(k)) for k, p in enumerate(self.run.passes)]

    def close(self) -> None:
        """Delete every PNG but the kept ones."""
        self.sink.close()
        keep = set(self.kept.values())
        for f in self.out.iterdir():
            if f not in keep:
                f.unlink()
