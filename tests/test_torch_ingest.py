"""The port's host-ingest payload modes (``--ingest host|host16|host16c|host8``)
against the JAX package's, on the CPU.

- ``prepare_work`` gives the JAX ``Decoder(ingest=...)``'s payloads byte
  for byte: the f32 work signal of ``host``, the i16/i8 buffers and
  their ``inv_scale``, the sealed u32 buffer of ``host16c`` (the port
  builds the JAX package's C++ with the same g++ command);
- ``decode_render`` and ``decode(host_work=...)`` give the JAX package's
  sync lists, and u8 rows within +-1 on at most 0.1% of pixels;
  ``host16c`` renders equal ``host16``'s byte for byte;
- an l == 1 rate pair takes the device path; the too-short guards keep
  the JAX messages; the CLI runs every mode on the fused and the unfused
  branch against the JAX CLI.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import synth_i16
from noaa_apt_tpu.cli import inner_main as jax_cli
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.err import InternalError as JInternalError
from noaa_apt_tpu.graph import decode as jdecode

from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.err import InternalError
from noaa_apt_tpu_torch.graph import decode as pdecode
from noaa_apt_tpu_torch.graph.decode import Decoder, PackedWorkPayload, pad_bucket
from noaa_apt_tpu_torch.io import png, wav
from noaa_apt_tpu_torch.ops import launch_counts, reset_launch_counts

torch.set_num_threads(1)

MODES = ("host", "host16", "host16c", "host8")
SHAPES = [("standard", 11025), ("standard", 48000), ("fast", 48000)]


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    monkeypatch.chdir(tmp_path)


_SIGNALS: dict = {}


def _signal(rate: int, rows: int = 40, noise_db: float = 30.0, seed: int = 5) -> np.ndarray:
    key = (rate, rows, noise_db, seed)
    if key not in _SIGNALS:
        _SIGNALS[key] = synth_i16(rows, rate, noise_db=noise_db, seed=seed)[0]
    return _SIGNALS[key]


def _decoders(profile: str, mode: str):
    return Decoder(PROFILES[profile], device="cpu", ingest=mode), jdecode.Decoder(JPROFILES[profile], ingest=mode)


def _host(data) -> np.ndarray:
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _u8_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


@pytest.mark.parametrize("to_device", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("profile,rate", SHAPES)
def test_payloads_equal_jax(profile, rate, mode, to_device):
    sig = _signal(rate)
    dec, jdec = _decoders(profile, mode)
    pw = dec.prepare_work(sig, Rate(rate), to_device=to_device)
    jw = jdec.prepare_work(sig, JRate(rate), to_device=to_device)
    assert type(pw).__name__ == type(jw).__name__
    assert dec.last_ingest_s is not None and dec.last_ingest_s > 0
    if isinstance(pw, PackedWorkPayload):
        assert mode == "host16c" and to_device
        assert (pw.nb, pw.w_lo, pw.n_esc_pad, pw.work_true, pw.coeff) == (
            jw.nb, jw.w_lo, jw.n_esc_pad, jw.work_true, jw.coeff)
        assert pw.inv_scale == jw.inv_scale
        assert pw.buf.dtype == torch.int32
        np.testing.assert_array_equal(_host(pw.buf).view(np.uint32), np.asarray(jw.buf))
        assert dec.last_upload["bytes"] == pw.buf.numel() * 4
        return
    got, want = _host(pw.data), np.asarray(jw.data)
    assert got.dtype == want.dtype == {"host": np.float32, "host8": np.int8}.get(mode, np.int16)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))  # bit for bit
    assert pw.work_true == jw.work_true and pw.inv_scale == jw.inv_scale
    assert got.shape[0] == (pad_bucket(pw.work_true) if to_device else pw.work_true)


def test_host8_gate_falls_back_on_spiky_signal():
    """A quiet recording with full-scale clicks predicts an i8 SNR under
    the 42 dB gate: the payload is i16, counted in ``host8_fallbacks``,
    as in the JAX package; a clean pass stays i8."""
    sig = _signal(11025).astype(np.int32) // 64
    sig[::5000] = 32767
    sig = sig.astype(np.int16)
    assert pdecode._i8_ingest_snr_estimate(sig) == jdecode._i8_ingest_snr_estimate(sig)
    dec, jdec = _decoders("standard", "host8")
    pw, jw = dec.prepare_work(sig, Rate(11025)), jdec.prepare_work(sig, JRate(11025))
    assert pw.data.dtype == np.int16 and dec.host8_fallbacks == jdec.host8_fallbacks == 1
    np.testing.assert_array_equal(pw.data, np.asarray(jw.data))
    clean = dec.prepare_work(_signal(11025), Rate(11025))
    assert clean.data.dtype == np.int8 and dec.host8_fallbacks == 1
    assert pdecode._i8_ingest_snr_estimate(np.zeros(10, np.int16)) == 0.0
    assert pdecode._i8_ingest_snr_estimate(np.zeros(0, np.int16)) is None


@pytest.mark.parametrize("kind", ["percent", "minmax"])
@pytest.mark.parametrize("mode", MODES)
def test_render_matches_jax(mode, kind):
    """``decode_render`` on the payload ``prepare_work`` uploads (host16c:
    the sealed buffer through K4's twin) against the JAX decoder's; K1
    does not run."""
    sig = _signal(48000)
    dec, jdec = _decoders("standard", mode)
    pw = dec.prepare_work(sig, Rate(48000), to_device=True)
    jw = jdec.prepare_work(sig, JRate(48000), to_device=True)
    gray, sync_pos = dec.decode_render(pw, kind)
    jgray, jsync = jdec.decode_render(jw, kind)
    assert sync_pos == jsync
    _u8_close(gray, jgray)
    stages = set(dec.last_stage_ms)
    assert {"upload", "demod_fir_corr", "select", "rows_levels_u8", "fetch_image"} <= stages
    assert "resample" not in stages
    assert ("unpack" in stages) == (mode == "host16c") and ("dequant" in stages) == (mode != "host")


@pytest.mark.parametrize("mode", MODES)
def test_decode_host_work_matches_jax(mode):
    """``decode()`` with a host ingest prepares its own payload (host16c:
    the plain i16 one) and matches the JAX ``decode``; ``host_work``
    given explicitly is the same decode."""
    sig = _signal(11025)
    dec, jdec = _decoders("standard", mode)
    res, jres = dec.decode(sig, Rate(11025)), jdec.decode(sig, JRate(11025))
    assert res.sync_positions == jres.sync_positions and res.n_rows == jres.n_rows
    _u8_close(dec.render_u8(res, "percent"), jdec.render_u8(jres, "percent"))
    assert "resample" not in dec.last_stage_ms
    again = dec.decode(sig, Rate(11025), host_work=dec.prepare_work(sig, Rate(11025)))
    np.testing.assert_array_equal(again.image_np(), res.image_np())
    if mode == "host":  # a bare work-rate array is wrapped as an unquantized payload
        bare = Decoder(PROFILES["standard"], device="cpu").decode(
            sig, Rate(11025), host_work=dec.prepare_work(sig, Rate(11025)).data)
        np.testing.assert_array_equal(bare.image_np(), res.image_np())


def test_decode_refuses_packed_payload():
    sig = _signal(48000)
    dec, jdec = _decoders("standard", "host16c")
    pw = dec.prepare_work(sig, Rate(48000), to_device=True)
    jw = jdec.prepare_work(sig, JRate(48000), to_device=True)
    with pytest.raises(JInternalError) as jexc:
        jdec.decode(sig, JRate(48000), host_work=jw)
    with pytest.raises(InternalError) as exc:
        dec.decode(sig, Rate(48000), host_work=pw)
    assert str(exc.value) == str(jexc.value)


@pytest.mark.parametrize("kind", ["percent", "minmax", "telemetry"])
def test_host16c_render_equals_host16(kind):
    """The packed payload decodes to the exact i16 work signal, so its
    render is host16's byte for byte (telemetry at 230 rows: a frame
    needs 200)."""
    sig = _signal(11025, rows=230 if kind == "telemetry" else 40)
    d16 = Decoder(PROFILES["standard"], device="cpu", ingest="host16")
    dc = Decoder(PROFILES["standard"], device="cpu", ingest="host16c")
    w16 = d16.prepare_work(sig, Rate(11025), to_device=True)
    wc = dc.prepare_work(sig, Rate(11025), to_device=True)
    assert isinstance(wc, PackedWorkPayload) and wc.inv_scale == w16.inv_scale
    assert wc.buf.numel() * 4 < 0.97 * w16.data.numel() * 2
    g16, s16 = d16.decode_render(w16, kind)
    gc, sc = dc.decode_render(wc, kind)
    assert sc == s16
    np.testing.assert_array_equal(gc, g16)


def test_deferred_render_equals_fetched():
    sig = _signal(11025)
    dec = Decoder(PROFILES["standard"], device="cpu", ingest="host16")
    pw = dec.prepare_work(sig, Rate(11025))
    gray, sync_pos = dec.decode_render(pw)
    pending = dec.decode_render(pw, fetch=False)
    assert isinstance(pending, pdecode.PendingRender)
    g2, s2 = pending.get()
    assert s2 == sync_pos
    np.testing.assert_array_equal(g2, gray)
    tel = dec.decode_render_input(sig, len(sig), Rate(11025), "telemetry", fetch=False)
    assert isinstance(tel, pdecode.PendingRenderTelemetry)


@pytest.mark.parametrize("profile,rate", [("standard", 24960), ("standard", 12480), ("slow", 41600)])
def test_l1_rate_takes_the_device_path(profile, rate):
    """No host plan at l == 1: ``prepare_work`` returns None in every
    mode (as the JAX decoder does), and ``decode()`` runs K1's device
    path, equal to the device-ingest decode."""
    sig = _signal(rate, rows=16)
    dev_res = Decoder(PROFILES[profile], device="cpu").decode(sig, Rate(rate))
    for mode in MODES:
        dec, jdec = _decoders(profile, mode)
        assert dec.prepare_work(sig, Rate(rate), to_device=True) is None
        assert jdec.prepare_work(sig, JRate(rate), to_device=True) is None
        res = dec.decode(sig, Rate(rate))
        assert "resample" in dec.last_stage_ms
        assert res.sync_positions == dev_res.sync_positions
        np.testing.assert_array_equal(res.image_np(), dev_res.image_np())


def test_too_short_keeps_the_jax_message():
    sig = _signal(11025)
    dec, jdec = _decoders("standard", "host16")
    tiny = sig[:5]  # resamples to nothing
    with pytest.raises(JInternalError) as jexc:
        jdec.prepare_work(tiny, JRate(11025))
    with pytest.raises(InternalError) as exc:
        dec.prepare_work(tiny, Rate(11025))
    assert str(exc.value) == str(jexc.value)
    short = dec.prepare_work(sig[: len(sig) // 8], Rate(11025))
    jshort = jdec.prepare_work(sig[: len(sig) // 8], JRate(11025))
    with pytest.raises(JInternalError) as jexc:
        jdec.decode_render(jshort)
    with pytest.raises(InternalError) as exc:
        dec.decode_render(short)
    assert str(exc.value) == str(jexc.value)


def test_payload_length_and_coefficient_contract():
    """A pre-uploaded plain payload must be padded to ``pad_bucket``
    (the JAX message), and a packed payload's predictor coefficient must
    be the decoder's."""
    sig = _signal(11025)
    dec = Decoder(PROFILES["standard"], device="cpu", ingest="host16c")
    pw = Decoder(PROFILES["standard"], device="cpu", ingest="host16").prepare_work(sig, Rate(11025))
    bad = dataclasses.replace(pw, data=torch.from_numpy(pw.data))
    with pytest.raises(InternalError, match=rf"pre-uploaded work buffer is {pw.work_true}, "
                                            rf"expected pad_bucket\({pw.work_true}\) = {pad_bucket(pw.work_true)}"):
        dec.decode_render(bad)
    wc = dec.prepare_work(sig, Rate(11025), to_device=True)
    with pytest.raises(InternalError, match="predictor coefficient"):
        dec.decode_render(dataclasses.replace(wc, coeff=wc.coeff + 1))
    # A host numpy sealed buffer (u32) uploads and decodes alike.
    host = dataclasses.replace(wc, buf=wc.buf.numpy().view(np.uint32))
    assert dec.decode_render(host)[1] == dec.decode_render(wc)[1]


def test_unknown_ingest_mode_raises():
    with pytest.raises(ValueError, match="ingest"):
        Decoder(PROFILES["standard"], device="cpu", ingest="host4")


@pytest.fixture(scope="module")
def pass_wav(tmp_path_factory):
    sig = _signal(11025, rows=40, noise_db=20.0, seed=9)
    path = tmp_path_factory.mktemp("ingest") / "pass.wav"
    wav.write_wav(path, sig, wav.WavSpec(1, 11025, 16, "int"))
    return path


@pytest.mark.parametrize("branch", ["fused", "no_sync", "raw_out"])
@pytest.mark.parametrize("mode", MODES)
def test_cli_ingest_matches_jax_cli(caplog, pass_wav, mode, branch):
    """``--ingest MODE`` through both CLIs: the fused branch
    (``prepare_work`` -> ``decode_render``) and the unfused one
    (``--no-sync``, ``--raw-out``: ``decode()``); K1 never launches."""
    flags = {"fused": [], "no_sync": ["--no-sync"], "raw_out": ["--raw-out", "raw.npy"]}[branch]
    assert jax_cli([str(pass_wav), "-o", "jax.png", "-q", "--ingest", mode, *flags]) == 0
    report: dict = {}
    caplog.set_level("INFO")
    reset_launch_counts()
    assert cli.main([str(pass_wav), "-o", "port.png", "--device", "cpu", "--ingest", mode, *flags],
                    report=report) == 0
    assert launch_counts() == {"polyphase_resample": 0, "demod_fir_corr": 0, "select_peaks": 0,
                               "unpack_sealed": 0}  # the CPU runs the twins
    got, want = png.read_png("port.png"), np.asarray(Image.open("jax.png"))
    _u8_close(got, want)
    assert report["ingest_s"] is not None and report["payload_bytes"] > 0
    assert "resample" not in report["stage_ms"]
    if branch == "fused":
        assert f"Decoding (fused, {mode} ingest)" in caplog.text
        jx, jrate = pdecode_jax_input(pass_wav)
        jdec = jdecode.Decoder(JPROFILES["standard"], ingest=mode)
        jw = jdec.prepare_work(jx, jrate, to_device=(mode == "host16c"))
        assert report["sync_positions"] == jdec.decode_render(jw)[1]
        assert ("unpack" in report["stage_ms"]) == (mode == "host16c")
    if branch == "raw_out":
        assert np.load("raw.npy").shape[0] == got.shape[0] * 2080


def pdecode_jax_input(path):
    from noaa_apt_tpu.io import wav as jwav

    return jwav.load_device_ready(path)


def test_cli_l1_rate_with_host_ingest_uses_device_path(tmp_path):
    sig = _signal(24960, rows=16)
    path = tmp_path / "l1.wav"
    wav.write_wav(path, sig, wav.WavSpec(1, 24960, 16, "int"))
    report: dict = {}
    assert cli.main([str(path), "-o", "a.png", "--device", "cpu", "-q", "--ingest", "host16c"],
                    report=report) == 0
    assert cli.main([str(path), "-o", "b.png", "--device", "cpu", "-q"]) == 0
    np.testing.assert_array_equal(png.read_png("a.png"), png.read_png("b.png"))
    assert "resample" in report["stage_ms"] and Path("a.png").exists()
