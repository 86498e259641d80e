"""The port's CLI against the JAX package's CLI on the CPU, for every
contrast and colour choice of the single-file decode branch.

The same WAV goes through ``noaa_apt_tpu.cli.inner_main`` and
``noaa_apt_tpu_torch.cli.main --device cpu``.  The PNGs must be equal
where the two packages' grey rows are equal; otherwise the grey rows
must agree under the +-1 / 0.1% rule and the port's finish stage, given
the JAX package's grey rows, must give the JAX PNG exactly.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu.cli import inner_main as jax_cli
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.graph import decode as jdecode
from noaa_apt_tpu.graph.process import process as j_process
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.synth import synth_recording
from noaa_apt_tpu.types import Contrast as JContrast
from noaa_apt_tpu.types import Rotate as JRotate

from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph.decode import Decoder
from noaa_apt_tpu_torch.graph.process import finish_image, process
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.types import ColorSettings, ContrastKind, Rotate

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


@pytest.mark.parametrize("flags,what", [
    (["-R", "auto"], "-R auto"), (["-m", "yes"], "-m yes"), (["-s", "noaa_19"], "-s"),
    (["-t", "2020-01-26T00:53:20+00:00"], "-t"), (["-T", "tle.txt"], "-T"),
    (["--wav-steps"], "--wav-steps"), (["--export-resample-filtered"], "--export-resample-filtered"),
    (["-r", "8000"], "-r"), (["--stream"], "--stream"), (["--distributed", "2"], "--distributed"),
    (["--ingest", "host16"], "--ingest host16"),
])
def test_cli_unported_options_exit_1(tmp_path, caplog, pass_wav, flags, what):
    rc = cli.main([str(pass_wav), "-o", "out.png", "--device", "cpu", *flags])
    assert rc == 1 and not Path("out.png").exists()
    assert f"{what} is not ported yet" in caplog.text


def test_cli_directory_gui_version_and_debug(tmp_path, caplog, capsys, pass_wav):
    """A directory input and no input (the GUI) are refused; ``-v`` prints
    the version; ``-d`` logs at debug level; ``-p`` overrides the
    settings file's profile."""
    assert cli.main([str(tmp_path), "-o", "out.png", "--device", "cpu"]) == 1
    assert "a directory input is not ported yet" in caplog.text
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
