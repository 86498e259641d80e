"""The port's spans (``noaa_apt_tpu_torch/spans.py``) on the CPU.

Under a ``torch.profiler`` started as the benchmark starts it (no
experimental config, so only the calling thread's spans are recorded),
the CLI's serial path records each of its ``apt.*`` spans, each child
inside its parent, and the fleet's calling thread its waits, dispatches
and drain.  With no profiler on, a span never enters ``record_function``,
and the CLI's report keeps its keys and intervals.  ``--profile-trace``
records every thread's spans where the installed torch can.
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from noaa_apt_tpu_torch import cli, serve, spans
from noaa_apt_tpu_torch.io import wav
from noaa_apt_tpu_torch.synth import synth_recording

torch.set_num_threads(1)

RATE = 11025
# Each span of the serial path, with the span it lies in (None: the call's).
SERIAL = {"apt.load": None, "apt.wav.read": "apt.load", "apt.wav.convert": "apt.load",
          "apt.decode": None, "apt.tables": "apt.decode", "apt.upload.copy": "apt.decode",
          "apt.upload.h2d": "apt.decode", "apt.wait.peaks": "apt.decode", "apt.wait.rows": "apt.decode",
          "apt.finish": None, "apt.save": None, "apt.png.deflate": "apt.save", "apt.png.write": "apt.save"}
# Spans a serial call records twice: the decoder's K1 tables and its K2 tables.
TWICE = {"apt.tables"}
STEPS = (("load_s", "apt.load"), ("decode_s", "apt.decode"), ("finish_s", "apt.finish"), ("save_s", "apt.save"))


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def passes(tmp_path_factory) -> Path:
    """A directory of three 40-row passes at 11025 Hz (16-bit WAVs)."""
    d = tmp_path_factory.mktemp("spans")
    signal, _ = synth_recording(n_rows=40, sample_rate=RATE, noise_db=20.0, seed=3)
    for k in range(3):
        wav.write_wav(d / f"p{k}.wav", signal[: len(signal) - 2000 * k], wav.WavSpec(1, RATE, 16, "int"))
    return d


class Recorder:
    """Stands in for ``record_function``: keeps the names it was entered with."""

    entered: list = []

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        Recorder.entered.append(self.name)
        return self

    def __exit__(self, *exc):
        return None


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(Recorder, "entered", [])
    monkeypatch.setattr(spans, "record_function", Recorder)
    return Recorder.entered


def host_events(prof) -> list:
    """``(name, start ns, end ns, thread)`` of every host event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def test_cli_serial_path_records_each_span_inside_its_parent(passes):
    report: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main([str(passes / "p0.wav"), "-o", "o.png", "-q", "--device", "cpu"], report=report) == 0
    by = {}
    for name, a, b, _ in host_events(prof):
        if name.startswith("apt."):
            by.setdefault(name, []).append((a, b))
    assert set(by) == set(SERIAL) and all(len(v) == 1 + (name in TWICE) for name, v in by.items())
    for child, parent in SERIAL.items():
        if parent is not None:
            (pa, pb), = by[parent]
            assert all(pa <= a <= b <= pb for a, b in by[child]), (child, parent)
    steps = [by[name][0] for _, name in STEPS]
    assert all(x[1] <= y[0] for x, y in zip(steps, steps[1:]))
    for key, name in STEPS:  # the report's step is its span's interval, inside its record_function
        a, b = by[name][0]
        assert (b - a) / 1e9 - 2e-3 <= report[key] <= (b - a) / 1e9 + 1e-6


def test_without_a_profiler_no_record_function_and_the_report_as_before(passes, recorder):
    report: dict = {}
    assert cli.main([str(passes / "p0.wav"), "-o", "o.png", "-q", "--device", "cpu"], report=report) == 0
    assert recorder == []
    assert set(report) == {"ingest_s", "payload_bytes", "load_s", "decode_s", "finish_s", "save_s", "wall_s",
                           "rows", "sync_positions", "stage_ms", "telemetry_ms", "png_strips", "wav_bytes",
                           "wav_mapped", "upload_chunks", "k1_variant"}
    steps = [report[key] for key, _ in STEPS]
    assert all(s > 0 for s in steps) and sum(steps) <= report["wall_s"] <= sum(steps) + 0.05
    # The decoder's stage clock runs inside the decode step.
    assert sum(report["stage_ms"].values()) / 1e3 <= report["decode_s"]
    assert report["payload_bytes"] == 2 * (len(wav.load_device_ready(passes / "p0.wav")[0]))
    assert report["upload_chunks"] > 0  # the mapped WAV went through the ring
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("apt.test") as s:
            pass
    assert recorder == ["apt.test"] and s.seconds >= 0


def test_span_records_where_torch_has_no_profiler_flag(monkeypatch, recorder):
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert spans.profiling()
    with spans.span("apt.test") as s:
        pass
    assert recorder == ["apt.test"] and s.end >= s.start > 0


def test_png_strips_each_record_a_span_in_the_deflate_pool(recorder):
    """A pass-sized PNG: one ``apt.png.deflate`` on the caller's thread, one
    ``apt.png.strip`` a strip on the pool's threads."""
    from noaa_apt_tpu_torch.io import png

    img = np.random.default_rng(0).integers(0, 256, (1200, 2080, 4), dtype=np.uint8)
    threads = set()
    strip = png._deflate_strip

    def deflate_strip(*args):
        threads.add(threading.get_ident())
        return strip(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(png, "_deflate_strip", deflate_strip)
        with profile(activities=[ProfilerActivity.CPU]):
            png.encode_png(img)
    assert recorder.count("apt.png.deflate") == 1
    assert recorder.count("apt.png.strip") == png.png_strips(img) > 1
    assert threading.get_ident() not in threads


def test_fleet_calling_thread_records_its_waits_dispatches_and_drain(passes, monkeypatch):
    """Loaders slowed by 50 ms a pass: the device thread waits for them."""
    load = wav.load_device_ready

    def slow_load(path):
        threading.Event().wait(0.05)
        return load(path)

    monkeypatch.setattr(serve.wav, "load_device_ready", slow_load)
    report: dict = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            assert cli.main([str(passes), "-o", "out", "-q", "--device", "cpu"], report=report) == 0
    events = host_events(prof)
    caller = next(t for name, _, _, t in events if name == "test.caller")
    names = [name for name, _, _, t in events if name.startswith("apt.") and t == caller]
    assert {"apt.fleet.wait_loader", "apt.fleet.dispatch", "apt.fleet.drain"} <= set(names)
    assert names.count("apt.fleet.dispatch") == 3 and names.count("apt.fleet.drain") == 1
    fleet = report["fleet"]
    assert set(fleet.waits) == {"loader", "encoder", "drain"}
    assert fleet.waits["loader"] > 0.02 and fleet.waits["drain"] > 0
    written = json.loads(Path("out/fleet_report.json").read_text())
    assert written["wait_seconds"] == {k: round(v, 3) for k, v in fleet.waits.items()}
    assert set(written["stage_seconds"]) == {"load", "ingest", "device", "fetch", "encode"}
    dispatch_s = sorted((b - a) / 1e9 for name, a, b, t in events if name == "apt.fleet.dispatch")
    assert sorted(r.device_s for r in fleet.results) == pytest.approx(dispatch_s, abs=1e-3)


def test_fleet_waits_for_a_full_encode_queue(passes, monkeypatch, tmp_path):
    """One encoder held until the device thread blocks on the full queue
    (one pass in the encoder and four queued): the sixth pass waits."""
    gate = threading.Event()

    class Span(spans.span):
        __slots__ = ()

        def __enter__(self):
            if self.name == "apt.fleet.wait_encoder":
                gate.set()
            return super().__enter__()

    write = serve.png.write_png

    def held_write(*args, **kwargs):
        assert gate.wait(30)
        write(*args, **kwargs)

    monkeypatch.setattr(serve, "span", Span)
    monkeypatch.setattr(serve.png, "write_png", held_write)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rep = serve.decode_fleet([passes / "p0.wav"] * 6, tmp_path / "o", ingest="device", encoders=1,
                                 device="cpu")
    assert len(rep.ok) == 6 and rep.waits["encoder"] > 0
    assert "apt.fleet.wait_encoder" in {name for name, _, _, _ in host_events(prof)}


def test_profile_trace_records_the_loader_and_encoder_threads(passes):
    from torch.profiler import _ExperimentalConfig

    try:
        _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        pytest.skip("this torch's profiler records only the thread that started it")
    assert cli.main([str(passes), "-o", "out", "-q", "--device", "cpu", "--profile-trace", "tr"]) == 0
    events = json.loads(next(Path("tr").glob("*.trace.json")).read_text())["traceEvents"]
    tids = {}
    for e in events:
        if str(e.get("name", "")).startswith("apt."):
            tids.setdefault(e["name"], set()).add(e["tid"])
    caller = tids["apt.fleet.dispatch"]
    assert tids["apt.fleet.load"] - caller and tids["apt.png.deflate"] - caller
