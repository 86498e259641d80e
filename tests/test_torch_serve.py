"""The port's fleet serving (``noaa_apt_tpu_torch.serve.decode_fleet``, the
CLI's directory mode) against the JAX package's on the CPU.

The same seeded 16-row synthesized passes at 11025 Hz (as
``tests/test_serve.py`` uses) go through both packages' ``decode_fleet``:
the same inputs succeed and fail, with the same row counts, output names
and report keys; the PNG pixels agree under the port's rule (u8 +-1 only
on a ``floor(v+0.5)`` knife edge, on at most 0.1% of pixels).  Within the
port, grouped dispatch is byte-equal to per-pass dispatch, host16c to
host16, and ``gray_png="never"`` to the single-file CLI's PNG.
"""

import json
import struct
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu.cli import inner_main as jax_cli
from noaa_apt_tpu.io import png as jpng
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.serve import FleetReport as JFleetReport
from noaa_apt_tpu.serve import PassResult as JPassResult
from noaa_apt_tpu.serve import decode_fleet as jax_fleet
from noaa_apt_tpu.synth import synth_recording
from noaa_apt_tpu.types import Contrast as JContrast

from noaa_apt_tpu_torch import cli, err
from noaa_apt_tpu_torch.graph import decode as pdecode
from noaa_apt_tpu_torch.graph import process as pprocess
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.serve import FleetReport, PassResult, decode_fleet
from noaa_apt_tpu_torch.types import Contrast

torch.set_num_threads(1)

RATE = 11025


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)


def _write(path: Path, rows: int, seed: int, noise_db=18.0) -> Path:
    sig, _ = synth_recording(n_rows=rows, sample_rate=RATE, noise_db=noise_db, seed=seed)
    jwav.write_wav(path, sig, jwav.WavSpec(1, RATE, 16, "int"))
    return path


@pytest.fixture(scope="module")
def fleet_dir(tmp_path_factory) -> Path:
    """Three good passes, a header-only ``RIFFxxxxWAVE`` file and a 4-row pass."""
    d = tmp_path_factory.mktemp("fleet")
    for seed in range(3):
        _write(d / f"pass_{seed}.wav", 16, seed)
    (d / "bad.wav").write_bytes(b"RIFFxxxxWAVE")
    _write(d / "short.wav", 4, 7)
    return d


def _paths(d: Path) -> list:
    return sorted(d.glob("*.wav"))


def _pixels(path) -> np.ndarray:
    """A PNG's pixels as the port reads them, grey as [H, W]."""
    img = png.read_png(path)
    return img[..., 0] if img.shape[2] == 1 else img


def _u8_close(got: np.ndarray, want: np.ndarray) -> int:
    """The port's rule: +-1 on at most 0.1% of pixels; returns the count."""
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size
    return int((d > 0).sum())


def _same_outcomes(rep: FleetReport, jrep: JFleetReport) -> None:
    """The same inputs ok and failed, in order, with the same rows and names."""
    assert [r.input_path.name for r in rep.results] == [r.input_path.name for r in jrep.results]
    assert [r.error is None for r in rep.results] == [r.error is None for r in jrep.results]
    assert [r.n_rows for r in rep.ok] == [r.n_rows for r in jrep.ok]
    assert [r.output_path.name for r in rep.ok] == [r.output_path.name for r in jrep.ok]
    for r, jr in zip(rep.ok, jrep.ok):
        assert r.output_path.exists()
        _u8_close(_pixels(r.output_path), np.asarray(Image.open(jr.output_path)))


def test_device_ingest_matches_jax(fleet_dir, tmp_path):
    paths = _paths(fleet_dir)
    rep = decode_fleet(paths, tmp_path / "port", ingest="device", device="cpu")
    jrep = jax_fleet(paths, tmp_path / "jax", ingest="device")
    _same_outcomes(rep, jrep)
    assert len(rep.ok) == 3 and {r.input_path.name for r in rep.failed} == {"bad.wav", "short.wav"}
    assert "too short" in next(r.error for r in rep.failed if r.input_path.name == "short.wav")
    assert set(rep.stage_totals()) == set(jrep.stage_totals())
    assert [f.name for f in PassResult.__dataclass_fields__.values()] == \
        [f.name for f in JPassResult.__dataclass_fields__.values()]
    # The port's report adds the device thread's waits (``waits``), which the JAX package lacks.
    assert set(FleetReport.__dataclass_fields__) == set(JFleetReport.__dataclass_fields__) | {"waits"}
    assert set(rep.waits) == {"loader", "encoder", "drain"} and all(v >= 0 for v in rep.waits.values())
    for r in rep.ok:
        assert r.n_rows >= 14 and r.device_s > 0 and r.encode_s > 0
        assert r.seconds == pytest.approx(r.device_s + r.fetch_s + r.encode_s)
    assert rep.realtime_factor > 0 and rep.compile_variants == 1  # one input rate
    assert set(rep.link) == {"uploaded_MB", "up_wall_s", "eff_up_MBps"} <= set(jrep.link)
    # The three good passes and the short one were padded and uploaded.
    assert rep.link["uploaded_MB"] > 0


GROUP_PASSES = {
    # seed: rows.  Mixed buckets (16 and 24 rows) and a too-short member.
    "percent": {0: 16, 1: 16, 2: 16, 3: 24, 4: 24, 5: 4},
    # A telemetry frame needs 200 rows.
    "telemetry": {0: 208, 1: 208, 2: 16},
}


@pytest.mark.parametrize("case", sorted(GROUP_PASSES))
def test_grouped_dispatch_matches_per_pass_and_jax(tmp_path, monkeypatch, case):
    """host16 payloads grouped by four against one by one: byte-equal PNGs
    within the port, K3 once per group; pixels equal to JAX's grouped run."""
    paths = [_write(tmp_path / f"g{seed}.wav", rows, seed, 20.0) for seed, rows in GROUP_PASSES[case].items()]
    contrast = Contrast.telemetry() if case == "telemetry" else None
    jcontrast = JContrast.telemetry() if case == "telemetry" else None
    k3_rows = []
    real = pdecode.select_peaks

    def spy(corr, *a, **kw):
        k3_rows.append(corr.shape[0])
        return real(corr, *a, **kw)

    monkeypatch.setattr(pdecode, "select_peaks", spy)
    rep_b = decode_fleet(paths, tmp_path / "b", ingest="host16", contrast=contrast, fleet_batch=4,
                         loaders=1, device="cpu")
    grouped = list(k3_rows)
    rep_1 = decode_fleet(paths, tmp_path / "one", ingest="host16", contrast=contrast, fleet_batch=1,
                         device="cpu")
    live = len(paths) - 1  # the last member is too short, or too short for telemetry
    assert len(rep_b.ok) == len(rep_1.ok) == live and len(rep_b.failed) == len(rep_1.failed) == 1
    decoded = len(paths) - (case == "percent")  # the 4-row member never reaches K3
    assert sum(grouped) == decoded and len(grouped) < decoded
    assert k3_rows[len(grouped):] == [1] * decoded
    for rb, r1 in zip(rep_b.ok, rep_1.ok):
        assert rb.input_path == r1.input_path and rb.n_rows == r1.n_rows
        assert rb.output_path.read_bytes() == r1.output_path.read_bytes()
    jrep = jax_fleet(paths, tmp_path / "jax", ingest="host16", contrast=jcontrast, fleet_batch=4)
    _same_outcomes(rep_b, jrep)
    assert rep_b.failed[0].error == rep_1.failed[0].error


@pytest.fixture(scope="module")
def clean_dir(tmp_path_factory) -> Path:
    """Two clean 16-row passes: their host16 payloads compress (host16c)."""
    d = tmp_path_factory.mktemp("clean")
    for seed in range(2):
        _write(d / f"c{seed}.wav", 16, seed, noise_db=None)
    return d


@pytest.mark.parametrize("sync", [True, False])
def test_host16c_matches_host16_and_jax(clean_dir, tmp_path, monkeypatch, sync):
    """host16c through K4's twin (sync on), and its fall back to host16
    without sync: byte-equal to the port's host16 run, pixels equal to
    the JAX package's host16c run."""
    paths = _paths(clean_dir)
    unpacks = []
    real = pdecode.unpack_sealed
    monkeypatch.setattr(pdecode, "unpack_sealed", lambda x, *a: unpacks.append(a) or real(x, *a))
    rep = decode_fleet(paths, tmp_path / "c", ingest="host16c", sync=sync, device="cpu")
    assert len(unpacks) == (len(paths) if sync else 0)
    rep16 = decode_fleet(paths, tmp_path / "p", ingest="host16", sync=sync, device="cpu")
    for r, r16 in zip(rep.ok, rep16.ok):
        assert r.output_path.read_bytes() == r16.output_path.read_bytes()
    jrep = jax_fleet(paths, tmp_path / "jax", ingest="host16c", sync=sync)
    assert len(rep.ok) == len(paths)
    _same_outcomes(rep, jrep)


def test_duplicate_stems_and_zero_loaders(tmp_path):
    paths = []
    for d in ("recA", "recB"):
        (tmp_path / d).mkdir()
        paths.append(_write(tmp_path / d / "pass.wav", 16, 1))
    rep = decode_fleet(paths, tmp_path / "out", ingest="device", loaders=0, device="cpu")
    jrep = jax_fleet(paths, tmp_path / "jout", ingest="device", loaders=0)
    _same_outcomes(rep, jrep)
    assert [r.output_path.name for r in rep.ok] == ["pass.png", "pass_1.png"]


def test_many_threads_match_one(tmp_path):
    """Eight loaders and four encoders with a short switch interval give
    the PNGs and per-pass results of one loader and one encoder."""
    import sys

    paths = [_write(tmp_path / f"s{seed:02d}.wav", 12 + seed % 3, seed) for seed in range(10)]
    one = decode_fleet(paths, tmp_path / "one", ingest="host16", loaders=1, encoders=1, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        many = decode_fleet(paths, tmp_path / "many", ingest="host16", loaders=8, encoders=4,
                            fleet_batch=3, device="cpu")
    finally:
        sys.setswitchinterval(interval)
    assert [r.input_path for r in many.results] == paths and not many.failed and not one.failed
    for a, b in zip(many.results, one.results):
        assert a.n_rows == b.n_rows and a.output_path.read_bytes() == b.output_path.read_bytes()


def test_gray_png_modes_and_single_file_cli(fleet_dir, tmp_path):
    """"auto" writes a grey PNG equal to the "never" file's R, G and B
    channels; the "never" file is byte-equal to the single-file CLI's PNG
    of the same WAV; an invalid value raises."""
    p = fleet_dir / "pass_1.wav"
    gray = decode_fleet([p], tmp_path / "gray", ingest="device", device="cpu")
    rgba = decode_fleet([p], tmp_path / "rgba", ingest="device", gray_png="never", device="cpu")
    g, r = png.read_png(gray.ok[0].output_path), png.read_png(rgba.ok[0].output_path)
    assert g.shape[2] == 1 and r.shape[2] == 4
    for c in range(3):
        np.testing.assert_array_equal(g[..., 0], r[..., c])
    assert (r[..., 3] == 255).all()
    assert cli.main([str(p), "-o", "single.png", "--device", "cpu", "-q"]) == 0
    assert Path("single.png").read_bytes() == rgba.ok[0].output_path.read_bytes()
    with pytest.raises(err.InvalidInputError, match="gray_png"):
        decode_fleet([p], tmp_path / "bad", gray_png="always", device="cpu")


def test_encode_png_gray_equals_jax_writer():
    gray = np.random.default_rng(3).integers(0, 256, (9, 2080), dtype=np.uint8)
    assert png.encode_png(gray) == jpng.encode_gray_png(gray)
    assert png.encode_png(gray, level=6) == jpng.encode_gray_png(gray, level=6)


def test_decode_fleet_needs_cuda_unless_cpu(fleet_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the no-CUDA refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_fleet(_paths(fleet_dir), tmp_path / "out")
    assert not (tmp_path / "out").exists()


def _stereo_wav(path: Path, left: np.ndarray, right: np.ndarray) -> None:
    frames = np.stack([left, right], axis=1).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 2, RATE, RATE * 4, 4, 16)
    path.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(frames)) + b"WAVE" + b"fmt "
                     + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(frames)) + frames)


@pytest.mark.parametrize("channels", [1, 2])
def test_load_device_ready_without_mmap_matches_jax(tmp_path, channels):
    """``use_mmap=False`` reads into RAM: int16, equal to the memmap path
    and to the JAX package's loader with and without its memmap."""
    x = np.random.default_rng(channels).integers(-32768, 32768, 5001).astype(np.int16)
    path = tmp_path / "a.wav"
    if channels == 1:
        jwav.write_wav(path, x.astype(np.float32), jwav.WavSpec(1, RATE, 16, "int"))
    else:
        _stereo_wav(path, x, x[::-1])
    got, rate = wav.load_device_ready(path, use_mmap=False)
    mapped, _ = wav.load_device_ready(path)
    assert got.dtype == np.int16 and not isinstance(got, np.memmap) and rate.get_hz() == RATE
    assert isinstance(mapped, np.memmap)  # channel 0's view, strided for stereo
    np.testing.assert_array_equal(got, mapped)
    for use_mmap in (False, True):
        want, jrate = jwav.load_device_ready(path, use_mmap=use_mmap)
        assert want.dtype == np.int16 and jrate.get_hz() == RATE
        np.testing.assert_array_equal(got, want)
    if channels == 2:
        np.testing.assert_array_equal(got, x)


# --- the CLI's directory mode -----------------------------------------------

REPORT_KEYS = {"ok", "failed", "wall_seconds", "realtime_factor", "rows", "stage_seconds",
               "compile_variants", "passes"}
PASS_KEYS = {"input", "output", "rows", "load_s", "ingest_s", "device_s", "fetch_s", "encode_s"}


@pytest.mark.parametrize("fleet_png", ["auto", "rgba"])
def test_cli_directory_mode_matches_jax(fleet_dir, capsys, fleet_png):
    """Both CLIs on the fleet directory: exit 1 (two passes fail),
    ``fleet_report.json`` with the same keys, ok count, failed inputs and
    rows; the PNGs of ``--fleet-png rgba`` are RGBA, pixels equal."""
    flags = ["-q", "--ingest", "device", "--fleet-png", fleet_png]
    assert jax_cli([str(fleet_dir), "-o", "jax", *flags]) == 1
    jline = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("fleet:")]
    rep: dict = {}
    assert cli.main([str(fleet_dir), "-o", "port", "--device", "cpu", *flags], report=rep) == 1
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("fleet:")]
    assert len(line) == len(jline) == 1 and line[0].split(",")[:2] == jline[0].split(",")[:2]
    got = json.loads(Path("port/fleet_report.json").read_text())
    want = json.loads(Path("jax/fleet_report.json").read_text())
    assert set(want) == REPORT_KEYS and set(got) == REPORT_KEYS | {"wait_seconds"}
    assert set(got["wait_seconds"]) == {"loader", "encoder", "drain"}
    assert set(got["stage_seconds"]) == set(want["stage_seconds"])
    assert all(set(p) == PASS_KEYS for p in got["passes"] + want["passes"])
    assert got["ok"] == want["ok"] == 3 and got["rows"] == want["rows"]
    assert [Path(f["input"]).name for f in got["failed"]] == [Path(f["input"]).name for f in want["failed"]]
    assert isinstance(rep["fleet"], FleetReport)
    for p, jp in zip(got["passes"], want["passes"]):
        assert Path(p["output"]).name == Path(jp["output"]).name and p["rows"] == jp["rows"]
        img, jimg = _pixels(p["output"]), np.asarray(Image.open(jp["output"]))
        assert img.ndim == (3 if fleet_png == "rgba" else 2)
        _u8_close(img, jimg)


@pytest.mark.parametrize("flags,name", [
    (["--raw-out", "x.npy"], "--raw-out"), (["--wav-steps"], "--wav-steps"),
    (["--distributed", "2"], "--distributed"),
])
def test_cli_fleet_refusals_match_jax(fleet_dir, capsys, flags, name):
    assert jax_cli([str(fleet_dir), "-o", "jax", "-q", *flags]) == 1
    jout = capsys.readouterr().out.splitlines()
    assert cli.main([str(fleet_dir), "-o", "port", "--device", "cpu", "-q", *flags]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == jout[-1] == f"{name} is not supported in fleet (directory) mode"
    assert not Path("port").exists()


def test_cli_empty_directory_and_multihost(fleet_dir, tmp_path, capsys, caplog, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "notes.txt").write_text("no passes here")
    assert jax_cli([str(empty), "-o", "jax", "-q"]) == 1
    jout = capsys.readouterr().out.splitlines()
    assert cli.main([str(empty), "-o", "port", "--device", "cpu", "-q"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == jout[-1] == f"No WAV files found in {empty}"
    # --multihost without a coordinator: one process, whose share is the
    # whole directory, as in the JAX CLI (two passes fail: exit 1).
    for name in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert jax_cli([str(fleet_dir), "-o", "jax", "-q", "--multihost"]) == 1
    assert cli.main([str(fleet_dir), "-o", "port", "--device", "cpu", "--multihost"]) == 1
    assert "not ported yet" not in caplog.text
    assert "multihost fleet: process 0/1 decoding 5 of the recordings" in caplog.text
    assert sorted(p.name for p in Path("port").glob("*.png")) == sorted(p.name for p in Path("jax").glob("*.png"))


# The pinned Jan-2020 TLE of tests/test_torch_cli.py; the names carry each
# pass's start time in the gqrx format, an hour apart.
NAMES = ["gqrx_20200126_013320_137100000.wav", "gqrx_20200126_023320_137100000.wav"]


@pytest.mark.parametrize("override", [False, True])
def test_cli_per_file_orbit_matches_jax(tmp_path, monkeypatch, override):
    """``-R auto`` in fleet mode: each pass gets its own reference time
    from its name (one ``-t`` for all with ``override``), as in the JAX
    CLI; the rotated PNGs agree pixel for pixel under the rule."""
    import noaa_apt_tpu.geo.orbit as jorbit
    from test_torch_cli import TEST_TLE

    d = tmp_path / "passes"
    d.mkdir()
    for i, name in enumerate(NAMES):
        _write(d / name, 16, i, 20.0)
    Path("tle.txt").write_text(TEST_TLE)
    seen, jseen = [], []
    real, jreal = pprocess.south_to_north_pass, jorbit.south_to_north_pass
    monkeypatch.setattr(pprocess, "south_to_north_pass", lambda o: seen.append(o) or real(o))
    monkeypatch.setattr(jorbit, "south_to_north_pass", lambda o: jseen.append(o) or jreal(o))
    flags = ["-q", "--ingest", "device", "-R", "auto", "-T", "tle.txt"]
    if override:
        flags += ["-t", "2020-01-26T09:23:20+00:00", "-s", "noaa_18"]
    assert jax_cli([str(d), "-o", "jax", *flags]) == 0
    assert cli.main([str(d), "-o", "port", "--device", "cpu", *flags]) == 0
    times = sorted(o.ref_time.time for o in seen)
    assert times == sorted(o.ref_time.time for o in jseen)
    assert sorted(o.sat_name.value for o in seen) == sorted(o.sat_name.value for o in jseen)
    assert len(set(times)) == (1 if override else 2)
    if override:
        assert times[0] == datetime.fromisoformat("2020-01-26T09:23:20+00:00")
    for name in NAMES:
        stem = Path(name).stem
        img = png.read_png(f"port/{stem}.png")
        assert img.shape[2] == 4  # -R auto: RGBA
        _u8_close(img, np.asarray(Image.open(f"jax/{stem}.png")))

