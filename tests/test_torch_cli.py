"""The port's CLI against the JAX package's CLI on the CPU, for every
contrast and colour choice of the single-file decode branch.

The same WAV goes through ``noaa_apt_tpu.cli.inner_main`` and
``noaa_apt_tpu_torch.cli.main --device cpu``.  The PNGs must be equal
where the two packages' grey rows are equal; otherwise the grey rows
must agree under the +-1 / 0.1% rule and the port's finish stage, given
the JAX package's grey rows, must give the JAX PNG exactly.
"""

import json
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu.cli import inner_main as jax_cli
from noaa_apt_tpu.geo import states as jstates
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.graph import decode as jdecode
from noaa_apt_tpu.graph.process import finish_image as j_finish_image
from noaa_apt_tpu.graph.process import process as j_process
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.synth import synth_recording
from noaa_apt_tpu.types import Contrast as JContrast
from noaa_apt_tpu.types import ContrastKind as JContrastKind
from noaa_apt_tpu.types import MapSettings as JMapSettings
from noaa_apt_tpu.types import OrbitSettings as JOrbitSettings
from noaa_apt_tpu.types import RefTime as JRefTime
from noaa_apt_tpu.types import Rotate as JRotate
from noaa_apt_tpu.types import SatName as JSatName

from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph.decode import Decoder
from noaa_apt_tpu_torch.graph.process import finish_image, process
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.geo import states
from noaa_apt_tpu_torch.types import (ColorSettings, ContrastKind, MapSettings, OrbitSettings,
                                      RefTime, Rotate, SatName)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RATE = 11025
PALETTE = ROOT / "noaa_apt_tpu_torch" / "res" / "palettes" / "WXtoImg-class.png"


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    monkeypatch.chdir(tmp_path)


@pytest.fixture(scope="module")
def pass_wav(tmp_path_factory):
    """A 230-row pass (a telemetry frame needs 200 rows) as a 16-bit WAV."""
    signal, _ = synth_recording(n_rows=230, sample_rate=RATE, noise_db=20.0, seed=9)
    path = tmp_path_factory.mktemp("cli") / "pass.wav"
    wav.write_wav(path, signal, wav.WavSpec(1, RATE, 16, "int"))
    return path


def _u8_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


def _grays(path, kind: str, sync: bool, colored: bool):
    """(port, JAX) grey rows with the levels each CLI picks."""
    x, rate = wav.load_device_ready(path)
    jx, jrate = jwav.load_device_ready(path)
    dec, jdec = Decoder(PROFILES["standard"], device="cpu"), jdecode.Decoder(JPROFILES["standard"])
    levels = {"percent": "percent", "telemetry": "telemetry", "minmax": "minmax",
              "histogram": "percent" if colored else "minmax"}[kind]
    if sync:
        return (dec.decode_render_input(x, len(x), rate, levels)[0],
                jdec.decode_render_input(jx, len(jx), jrate, levels)[0])
    return (dec.render_u8(dec.decode(x, rate, sync=False), levels),
            jdec.render_u8(jdec.decode(jx, jrate, sync=False), levels))


CASES = {
    "telemetry": (["-c", "telemetry"], "telemetry", True, None),
    "histogram": (["-c", "histogram"], "histogram", True, None),
    "false_color": (["-F"], "percent", True, "default"),
    "false_color_palette": (["-F", "-P", str(PALETTE)], "percent", True, PALETTE),
    "false_color_histogram": (["-F", "-c", "histogram", "-R", "yes"], "histogram", True, "default"),
    "no_sync": (["--no-sync"], "percent", False, None),
    "no_sync_histogram": (["--no-sync", "-c", "histogram"], "histogram", False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax_cli(tmp_path, caplog, pass_wav, case):
    flags, kind, sync, palette = CASES[case]
    assert jax_cli([str(pass_wav), "-o", "jax.png", "-q", *flags]) == 0
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "port.png", "--device", "cpu", "-q", *flags],
                    report=report) == 0
    got, want = png.read_png("port.png"), np.asarray(Image.open("jax.png"))
    assert got.shape == want.shape and got.shape[1:] == (2080, 4)
    color = None
    if palette is not None:
        color = ColorSettings(PALETTE if palette == PALETTE else
                              ROOT / "noaa_apt_tpu_torch" / "res" / "palettes" / "noaa-apt-daylight.png")
    rotate = Rotate.YES if "-R" in flags else Rotate.NO
    pgray, jgray = _grays(pass_wav, kind, sync, color is not None)
    np.testing.assert_array_equal(finish_image(pgray, ContrastKind(kind), rotate, color), got)
    if np.array_equal(pgray, jgray):
        np.testing.assert_array_equal(got, want)
    else:
        _u8_close(pgray, jgray)
        np.testing.assert_array_equal(finish_image(jgray, ContrastKind(kind), rotate, color), want)
    assert (report["telemetry_ms"] is not None) == (kind == "telemetry")
    if not sync and kind == "histogram":
        assert "without syncing, expect horrible results" in caplog.text


def test_cli_raw_out_then_npy_matches_jax(tmp_path, pass_wav):
    """``--raw-out`` (the unfused decode() + process() path), then the .npy
    re-processed with each contrast: the raw signals agree to rounding,
    and the host path on the same .npy is the JAX package's bit for bit."""
    assert jax_cli([str(pass_wav), "-o", "jax.png", "-q", "--raw-out", "jax.npy"]) == 0
    assert cli.main([str(pass_wav), "-o", "port.png", "--device", "cpu", "-q",
                     "--raw-out", "port.npy"]) == 0
    raw, jraw = np.load("port.npy"), np.load("jax.npy")
    assert raw.shape == jraw.shape and raw.dtype == np.float32
    assert float(np.abs(raw - jraw).max()) <= 1e-4 * float(np.abs(jraw).max())
    pgray, jgray = _grays(pass_wav, "percent", True, False)
    _u8_close(png.read_png("port.png")[..., 0], np.asarray(Image.open("jax.png"))[..., 0])
    _u8_close(pgray, jgray)
    for c in ("98_percent", "telemetry", "disable", "histogram"):
        assert cli.main(["jax.npy", "-o", f"p_{c}.png", "--device", "cpu", "-q", "-c", c]) == 0
        assert jax_cli(["jax.npy", "-o", f"j_{c}.png", "-q", "-c", c]) == 0
        np.testing.assert_array_equal(png.read_png(f"p_{c}.png"), np.asarray(Image.open(f"j_{c}.png")))
    # The port's own .npy re-processes to its --raw-out run's image.
    assert cli.main(["port.npy", "-o", "again.png", "--device", "cpu", "-q"]) == 0
    np.testing.assert_array_equal(png.read_png("again.png"),
                                  process(raw, cli.CONTRASTS["98_percent"], Rotate.NO))
    np.testing.assert_array_equal(
        process(jraw, cli.CONTRASTS["disable"], Rotate.NO),
        j_process(jraw, JContrast.minmax(), JRotate.NO))


@pytest.mark.parametrize("flags,what", [(["--distributed", "2"], "--distributed")])
def test_cli_unported_options_exit_1(tmp_path, caplog, pass_wav, flags, what):
    """Only the GUI (no input) is left unported: it exits 1 and writes no
    file.  ``--distributed`` is ported: it decodes, and its PNG is the
    one-device run's."""
    assert cli.main([str(pass_wav), "-o", "one.png", "--device", "cpu"]) == 0
    assert cli.main([str(pass_wav), "-o", "out.png", "--device", "cpu", *flags]) == 0
    assert Path("out.png").read_bytes() == Path("one.png").read_bytes()
    assert f"{what} is not ported yet" not in caplog.text
    assert cli.main(["-o", "gui.png", "--device", "cpu"]) == 1 and not Path("gui.png").exists()
    assert "the GUI (no input file) is not ported yet" in caplog.text


@pytest.fixture(scope="module")
def steps_pass(tmp_path_factory):
    """A 14-row pass at 48000 Hz (l = 13, so the export grid stays small)
    and its offline ``--raw-out`` run's PNG and raw signal."""
    d = tmp_path_factory.mktemp("steps")
    signal, _ = synth_recording(n_rows=14, sample_rate=48000, noise_db=20.0, seed=5)
    wav.write_wav(d / "pass.wav", signal, wav.WavSpec(1, 48000, 16, "int"))
    assert cli.main([str(d / "pass.wav"), "-o", str(d / "off.png"), "--device", "cpu", "-q",
                     "--raw-out", str(d / "off.npy")]) == 0
    return d


@pytest.mark.parametrize("flags", [["--wav-steps"], ["--export-resample-filtered"], ["--stream"],
                                   ["--ingest", "host16", "--stream"]], ids=" ".join)
def test_cli_ported_debug_and_stream_options(tmp_path, monkeypatch, steps_pass, flags):
    """The step export and the stream against the JAX CLI, each with
    ``--raw-out`` (which the JAX CLI needs to take its step path for
    ``--export-resample-filtered`` alone): the raw signals within 1e-4 of
    their peak, the grey rows by the +-1 / 0.1% rule, the same step WAVs.
    Off the export grid the port's run is its offline ``--raw-out`` run,
    raw signal and PNG bit for bit; the export grid moves the samples."""
    wav_path = steps_pass / "pass.wav"
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_cli([str(wav_path), "-o", "out.png", "-q", *flags, "--raw-out", "out.npy"]) == 0
    monkeypatch.chdir(tmp_path / "port")
    report: dict = {}
    assert cli.main([str(wav_path), "-o", "out.png", "--device", "cpu", "-q", *flags,
                     "--raw-out", "out.npy"], report=report) == 0
    raw, jraw = np.load("out.npy"), np.load(tmp_path / "jax" / "out.npy")
    assert raw.shape == jraw.shape
    assert float(np.abs(raw - jraw).max()) <= 1e-4 * float(np.abs(jraw).max())
    _u8_close(png.read_png("out.png")[..., 0], np.asarray(Image.open(tmp_path / "jax" / "out.png"))[..., 0])
    steps = sorted(p.name for p in Path(".").glob("*.wav"))
    assert steps == sorted(p.name for p in (tmp_path / "jax").glob("*.wav"))
    assert (len(steps) == 10) == ("--wav-steps" in flags)
    off = np.load(steps_pass / "off.npy")
    if "--export-resample-filtered" in flags:
        assert not np.array_equal(raw, off)
    else:
        np.testing.assert_array_equal(raw, off)
        assert Path("out.png").read_bytes() == (steps_pass / "off.png").read_bytes()
    assert len(report["sync_positions"]) >= 13
    if "--stream" in flags:
        assert report["stream"]["chunks"] >= 2 and report["stream"]["audio_s"] == pytest.approx(7.0, abs=0.01)


def test_cli_export_resample_filtered_alone_departs_from_jax(tmp_path, monkeypatch, steps_pass):
    """``--export-resample-filtered`` without ``--raw-out``: the JAX CLI
    takes its fused path, where the flag changes nothing (its PNG is its
    run without the flag), while the port takes the step decode on the
    export grid by design (its PNG is its ``--raw-out`` run's byte for
    byte), so the two PNGs differ."""
    wav_path = str(steps_pass / "pass.wav")
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    assert jax_cli([wav_path, "-o", "flag.png", "-q", "--export-resample-filtered"]) == 0
    assert jax_cli([wav_path, "-o", "plain.png", "-q"]) == 0
    jflag = np.asarray(Image.open("flag.png"))
    np.testing.assert_array_equal(jflag, np.asarray(Image.open("plain.png")))
    monkeypatch.chdir(tmp_path / "port")
    assert cli.main([wav_path, "-o", "flag.png", "--device", "cpu", "-q", "--export-resample-filtered"]) == 0
    assert cli.main([wav_path, "-o", "raw.png", "--device", "cpu", "-q", "--export-resample-filtered",
                     "--raw-out", "raw.npy"]) == 0
    assert Path("flag.png").read_bytes() == Path("raw.png").read_bytes()
    assert Path("flag.png").read_bytes() != (steps_pass / "off.png").read_bytes()
    assert not np.array_equal(png.read_png("flag.png")[..., 0], jflag[..., 0])
    assert not list(Path(".").glob("*.wav"))


class _ChunkedPipe:
    """A binary stream that returns at most ``chunk`` bytes per read: a pipe
    that never hands over the whole recording at once."""

    def __init__(self, data: bytes, chunk: int = 777):
        self._data, self._i, self._chunk = data, 0, chunk

    def read(self, n: int) -> bytes:
        n = min(n, self._chunk)
        b = self._data[self._i : self._i + n]
        self._i += len(b)
        return b


def test_cli_stream_stdin_and_raw_pcm_match_offline(tmp_path, monkeypatch, short_pass):
    """``--stream`` from stdin (a WAV byte stream in 777-byte reads, then
    raw s16 with ``--stream-rate`` and ``--stream-update``) and from a raw
    PCM file: each PNG is the offline ``--raw-out`` run's byte for byte,
    the previews were written, and the raw PCM run's grey rows match the
    JAX CLI's."""
    import sys
    from types import SimpleNamespace

    assert cli.main([str(short_pass), "-o", "off.png", "--device", "cpu", "-q", "--raw-out", "off.npy"]) == 0
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=_ChunkedPipe(short_pass.read_bytes())))
    assert cli.main(["-", "--stream", "-o", "stdin.png", "--device", "cpu", "-q", "--raw-out", "st.npy"]) == 0
    np.testing.assert_array_equal(np.load("st.npy"), np.load("off.npy"))
    assert Path("stdin.png").read_bytes() == Path("off.png").read_bytes()

    samples, _ = wav.load_wav(short_pass, raw_int16=True)
    Path("raw.pcm").write_bytes(samples.astype("<i2").tobytes())
    previews = []
    real = cli._write_stream_preview
    monkeypatch.setattr(cli, "_write_stream_preview", lambda rows, out: (previews.append(out), real(rows, out)))
    monkeypatch.setattr(sys, "stdin", SimpleNamespace(buffer=_ChunkedPipe(Path("raw.pcm").read_bytes())))
    assert cli.main(["-", "--stream", "--stream-rate", str(RATE), "--stream-update", "4", "-o", "upd.png",
                     "--device", "cpu", "-q"]) == 0
    assert previews and set(previews) == {"upd.png"}
    assert Path("upd.png").read_bytes() == Path("off.png").read_bytes()
    assert cli.main(["raw.pcm", "--stream", "--stream-rate", str(RATE), "-o", "file.png", "--device", "cpu",
                     "-q"]) == 0
    assert Path("file.png").read_bytes() == Path("off.png").read_bytes()
    assert jax_cli(["raw.pcm", "--stream", "--stream-rate", str(RATE), "-o", "jax.png", "-q"]) == 0
    _u8_close(png.read_png("file.png")[..., 0], np.asarray(Image.open("jax.png"))[..., 0])


@pytest.mark.parametrize("flags,name", [(["--wav-steps"], "--wav-steps"),
                                        (["--export-resample-filtered"], "--export-resample-filtered"),
                                        (["--distributed", "2"], "--distributed")])
def test_cli_stream_refusals_match_jax(tmp_path, capsys, short_pass, flags, name):
    assert jax_cli([str(short_pass), "--stream", "-o", "jax.png", "-q", *flags]) == 1
    jout = capsys.readouterr().out.splitlines()
    assert cli.main([str(short_pass), "--stream", "-o", "port.png", "--device", "cpu", "-q", *flags]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == jout[-1] == f"{name} is not supported in stream mode"
    assert not Path("port.png").exists()


def test_cli_stream_errors_match_jax(tmp_path, caplog, capsys):
    """Raw PCM without ``--stream-rate`` (the JAX CLI raises its
    InvalidInputError, the port logs it and exits 1), and a stream too
    short for a row (both print the same line and exit 1)."""
    from noaa_apt_tpu import err as jerr

    Path("raw.pcm").write_bytes(b"\x00\x01" * 100)
    with pytest.raises(jerr.InvalidInputError) as info:
        jax_cli(["-q", "raw.pcm", "--stream"])
    assert cli.main(["-q", "raw.pcm", "--stream", "--device", "cpu"]) == 1
    assert str(info.value) in caplog.text and "--stream-rate" in str(info.value)
    capsys.readouterr()
    assert jax_cli(["-q", "raw.pcm", "--stream", "--stream-rate", "11025"]) == 1
    jout = capsys.readouterr().out.splitlines()
    assert cli.main(["-q", "raw.pcm", "--stream", "--stream-rate", "11025", "--device", "cpu"]) == 1
    assert capsys.readouterr().out.splitlines()[-1] == jout[-1] == (
        "Stream ended before any image rows were decoded")


def test_cli_profile_trace_writes_chrome_trace(tmp_path, short_pass):
    """``--profile-trace DIR`` writes ``DIR/<host>.<pid>.trace.json``, a
    Chrome trace of the run's host ops, beside the usual PNG."""
    import json as _json
    import os
    import socket

    report: dict = {}
    assert cli.main([str(short_pass), "-o", "t.png", "--device", "cpu", "-q", "--profile-trace", "tr"],
                    report=report) == 0
    traces = list(Path("tr").glob("*.trace.json"))
    assert [p.name for p in traces] == [f"{socket.gethostname()}.{os.getpid()}.trace.json"]
    assert report["trace"] == str(traces[0]) and png.png_size("t.png") == (2080, report["rows"])
    events = _json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_cli_profile_trace_refuses_a_trace_without_cuda_events(tmp_path, short_pass, monkeypatch, caplog):
    """A CUDA run that launched kernels but whose profile holds no CUDA
    event exits 1 and writes no trace (here the card is stood in for by
    the CPU and a launch counter that moves)."""
    import itertools

    ticks = itertools.count()
    monkeypatch.setattr(cli, "resolve_device", lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(cli.ops, "launch_counts", lambda: {"polyphase_resample": next(ticks)})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    assert cli.main([str(short_pass), "-o", "t.png", "-q", "--profile-trace", "tr"]) == 1
    assert not list(Path("tr").glob("*"))
    assert "recorded no CUDA activity" in caplog.text


def test_cli_directory_gui_version_and_debug(tmp_path, caplog, capsys, pass_wav):
    """A directory input decodes every WAV in it (fleet mode); no input
    (the GUI) is refused; ``-v`` prints the version; ``-d`` logs at debug
    level; ``-p`` overrides the settings file's profile."""
    d = tmp_path / "passes"
    d.mkdir()
    (d / "pass.wav").write_bytes(pass_wav.read_bytes())
    assert cli.main([str(d), "-o", "fleet", "--device", "cpu"]) == 0
    assert json.loads(Path("fleet/fleet_report.json").read_text())["ok"] == 1
    assert png.read_png("fleet/pass.png").shape[1:] == (2080, 1)
    assert "not ported yet" not in caplog.text
    assert cli.main(["--device", "cpu"]) == 1
    assert cli.main(["-v"]) == 0 and "version" in capsys.readouterr().out
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "slow.png", "--device", "cpu", "-d", "-p", "slow",
                     "-c", "telemetry"],
                    report=report) == 0
    jx, jrate = jwav.load_device_ready(pass_wav)
    jgray, jsync = jdecode.Decoder(JPROFILES["slow"]).decode_render_input(jx, len(jx), jrate)
    assert report["sync_positions"] == jsync
    assert report["rows"] == jgray.shape[0]
    assert any(r.levelname == "DEBUG" and "Telemetry wedges" in r.message for r in caplog.records)


# The pinned Jan-2020 TLE of the JAX package's tests (geo.rs:206-214), and
# a start time over Bolivia (tests/test_map.py's overlay ink test).
TEST_TLE = """NOAA 15
1 25338U 98030A   20028.53684332  .00000010  00000-0  22730-4 0  9996
2 25338  98.7308  54.2052 0009655 316.5487  43.4931 14.25949056128892
NOAA 18
1 28654U 05018A   20028.55430359  .00000064  00000-0  59410-4 0  9998
2 28654  99.0657  83.5290 0013366 267.3059  92.6583 14.12484618757024
NOAA 19
1 33591U 09005A   20028.54874297  .00000001  00000-0  25623-4 0  9996
2 33591  99.1936  30.2411 0014855 109.6767 250.6008 14.12393428565240"""
START = "2020-01-26T09:23:20+00:00"


@pytest.fixture
def offline_states(monkeypatch):
    """The states layer is skipped in both packages without a download:
    their failure memo is set, and the prefetch runs in the caller's
    thread (so none is left running past the test)."""
    monkeypatch.setattr(jstates, "_download_failed", [True])
    monkeypatch.setattr(states, "_download_failed", [True])
    monkeypatch.setattr(jstates, "prefetch_states_async", lambda: jstates.get_states_shp())
    monkeypatch.setattr(cli, "prefetch_states_async", lambda: states.get_states_shp())


@pytest.fixture(scope="module")
def short_pass(tmp_path_factory):
    """A 40-row pass at 11025 Hz as a 16-bit WAV."""
    signal, _ = synth_recording(n_rows=40, sample_rate=RATE, noise_db=20.0, seed=3)
    path = tmp_path_factory.mktemp("orbit") / "pass.wav"
    wav.write_wav(path, signal, wav.WavSpec(1, RATE, 16, "int"))
    return path


def _orbit(flags):
    """The orbit settings the CLIs build from ``ORBIT_FLAGS`` on a name
    that matches no filename format: NOAA 19, the ``-t`` time."""
    t = datetime.fromisoformat(START)
    draw = MapSettings() if "-m" in flags else None
    jdraw = JMapSettings() if "-m" in flags else None
    return (OrbitSettings(SatName.NOAA_19, RefTime.start(t), TEST_TLE, draw),
            JOrbitSettings(JSatName.NOAA_19, JRefTime.start(t), TEST_TLE, jdraw))


ORBIT_CASES = {
    "map_auto_rotate": (["-m", "yes", "-R", "auto"], "percent"),
    "map_sat_histogram": (["-m", "yes", "-s", "noaa_19", "-c", "histogram"], "histogram"),
    "auto_rotate_only": (["-R", "auto"], "percent"),
}


@pytest.mark.parametrize("case", sorted(ORBIT_CASES))
def test_cli_orbit_options_match_jax(tmp_path, offline_states, short_pass, case):
    """``-m yes``, ``-R auto`` and ``-s`` with ``-T``/``-t`` on a 40-row
    pass against the JAX CLI: grey rows by the +-1 / 0.1% rule, and each
    PNG equal to its package's grey rows finished with the same orbit
    settings (overlay, then the rotation the pass direction asks for)."""
    flags, kind = ORBIT_CASES[case]
    Path("tle.txt").write_text(TEST_TLE)
    flags = [*flags, "-T", "tle.txt", "-t", START]
    assert jax_cli([str(short_pass), "-o", "jax.png", "-q", *flags]) == 0
    assert cli.main([str(short_pass), "-o", "port.png", "--device", "cpu", "-q", *flags]) == 0
    got, want = png.read_png("port.png"), np.asarray(Image.open("jax.png"))
    assert got.shape == want.shape and got.shape[1:] == (2080, 4)
    o, jo = _orbit(flags)
    pgray, jgray = _grays(short_pass, kind, True, False)
    _u8_close(pgray, jgray)
    np.testing.assert_array_equal(finish_image(pgray, ContrastKind(kind), Rotate.ORBIT if "auto" in flags
                                               else Rotate.NO, None, o), got)
    np.testing.assert_array_equal(
        j_finish_image(jgray, JContrastKind(kind), JRotate.ORBIT if "auto" in flags else JRotate.NO,
                       None, jo), want)
    if "-m" in flags:
        assert (np.abs(got[..., 0].astype(np.int16) - got[..., 2]) > 10).sum() > 100  # map ink


def test_cli_orbit_options_on_npy_match_jax(tmp_path, offline_states, short_pass):
    """A ``.npy`` re-processed with the map and ``-R auto`` (the host
    ``process()`` path) gives the JAX CLI's PNG exactly."""
    Path("tle.txt").write_text(TEST_TLE)
    assert jax_cli([str(short_pass), "-o", "jax.png", "-q", "--raw-out", "raw.npy"]) == 0
    flags = ["-m", "yes", "-R", "auto", "-T", "tle.txt", "-t", START, "-q"]
    assert jax_cli(["raw.npy", "-o", "j.png", *flags]) == 0
    assert cli.main(["raw.npy", "-o", "p.png", "--device", "cpu", *flags]) == 0
    np.testing.assert_array_equal(png.read_png("p.png"), np.asarray(Image.open("j.png")))


BAD = {
    "map": (["-m", "maybe"], "Invalid map argument"),
    "sat": (["-s", "noaa_20"], "Invalid provided satellite name"),
    "time": (["-t", "yesterday"], "Could not parse date and time given"),
    "naive_time": (["-t", "2020-01-26T09:23:20"], "Could not parse date and time given"),
    "tle": (["-T", "missing_tle.txt"], "Could not open custom TLE file"),
    "no_time_for_auto": (["-R", "auto"], "Can't rotate automatically if no satellite and time"),
    "no_time_for_map": (["-m", "yes"], "Can't draw map if no satellite and time"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_cli_bad_orbit_options_match_jax(tmp_path, capsys, offline_states, short_pass, case):
    """A bad ``-m``, ``-s``, ``-t`` or ``-T``, and ``-R auto`` or ``-m yes``
    where no time and satellite can be found (an input without metadata):
    the JAX CLI's messages and exit code 0, and no PNG."""
    flags, message = BAD[case]
    wav_in = str(short_pass) if case.startswith(("map", "sat", "time", "naive", "tle")) else "gone.wav"
    assert jax_cli([wav_in, "-o", "jax.png", *flags]) == 0
    jlines = [ln for ln in capsys.readouterr().out.splitlines()
              if "decoder version" not in ln and "Saving default settings" not in ln]
    assert cli.main([wav_in, "-o", "port.png", "--device", "cpu", *flags]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == jlines and message in lines[-1]
    assert not Path("port.png").exists() and not Path("jax.png").exists()


@pytest.mark.parametrize("out", [None, "x.wav"])
def test_cli_resample_matches_jax(tmp_path, out):
    """``-r 12480`` with and without ``-o`` (``./output.wav``) against the
    JAX CLI: the same rate and length, int16 within 1 LSB."""
    signal, _ = synth_recording(n_rows=6, sample_rate=RATE, seed=4)
    wav.write_wav("in.wav", signal, wav.WavSpec(1, RATE, 16, "int"))
    Path("jax").mkdir()
    o = ["-o", out] if out else []
    assert jax_cli(["in.wav", "-r", "12480", "-q", *(["-o", f"jax/{out}"] if out else [])]) == 0
    if not out:
        Path("output.wav").rename("jax/output.wav")
    assert cli.main(["in.wav", "-r", "12480", "--device", "cpu", "-q", *o]) == 0
    name = out or "output.wav"
    got, spec = wav.load_wav(name, raw_int16=True)
    want, jspec = jwav.load_wav(Path("jax") / name, raw_int16=True)
    assert (spec.sample_rate, jspec.sample_rate) == (12480, 12480) and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert not Path("output.png").exists()
    assert cli.main(["gone.wav", "-r", "12480", "--device", "cpu", "-q"]) == 1
