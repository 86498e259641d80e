"""The port's WAV -> WAV resample tool (``graph/resample_tool.py``, ``-r``)
and its eager resample (``graph/debug.py``) against the JAX package's,
on the CPU.

Seeded 3-second int16 WAVs go through both packages at 48000 -> 11025
(l 147, m 640), 11025 -> 48000 (l 640, m 147), 24960 -> 12480 (l == 1,
m 2) and 12480 -> 12480 (l == 1, m 1).  The float outputs agree within
1e-5 of the input's peak (measured worst: 3.0e-7 of it, at 24960 ->
12480; 9.3e-10 at 48000 -> 11025): JAX's dot
products and the port's ascending-tap sums add in different orders.
The written int16 samples agree within 1 LSB.
"""

import os
from dataclasses import astuple
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noaa_apt_tpu import err as jerr
from noaa_apt_tpu.core.frequency import Freq as JFreq
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.graph import debug as jdebug
from noaa_apt_tpu.graph import resample_tool as jtool
from noaa_apt_tpu.io import config as jcfg
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.io.context import Context as JContext

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch.core.frequency import Freq, Rate
from noaa_apt_tpu_torch.graph import debug, resample_tool
from noaa_apt_tpu_torch.io import config as cfg
from noaa_apt_tpu_torch.io import wav
from noaa_apt_tpu_torch.io.context import Context
from noaa_apt_tpu_torch.ops.resample import polyphase_resample

torch.set_num_threads(1)

PAIRS = [(48000, 11025), (11025, 48000), (24960, 12480), (12480, 12480)]
MTIME = 1_580_030_600


def _seeded_wav(path: Path, rate: int, seconds: float = 3.0, seed: int = 0) -> np.ndarray:
    """A seeded int16 WAV: two tones under noise, written as-is."""
    rng = np.random.default_rng(seed + rate)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    x = 9000 * np.sin(2 * np.pi * 1300 * t) + 6000 * np.sin(2 * np.pi * 2400 * t)
    x = np.clip(x + rng.normal(0, 3000, n), -32768, 32767).astype(np.int16)
    wav.write_wav(path, x.astype(np.float32), wav.WavSpec(1, rate, 16, "int"))
    os.utime(path, (MTIME, MTIME))
    return wav.load_wav(path)[0]


@pytest.mark.parametrize("rin,rout", PAIRS)
def test_eager_resample_matches_jax(tmp_path, rin, rout):
    """``debug.resample`` in both packages on the same f32 samples."""
    x = _seeded_wav(tmp_path / "in.wav", rin)
    want = np.asarray(jdebug.resample(None, jnp.asarray(x), JRate(rin), JRate(rout), 40.0,
                                      JFreq.from_pi_rad(0.1)))
    got = debug.resample(None, torch.from_numpy(x), Rate(rin), Rate(rout), 40.0,
                         Freq.from_pi_rad(0.1))
    assert polyphase_resample.last_variant == "plain"
    assert got.dtype == torch.float32 and got.shape == want.shape and want.size > 0
    worst = float(np.abs(got.numpy() - want).max()) / float(np.abs(x).max())
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("rin,rout", PAIRS)
def test_resample_tool_matches_jax(tmp_path, monkeypatch, caplog, rin, rout):
    """The tool end to end: the same length and rate, int16 within 1 LSB,
    the input's mtime, and the reference's status strings in order."""
    import logging

    caplog.set_level(logging.INFO)
    _seeded_wav(tmp_path / "in.wav", rin)
    jstatus, status = [], []
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jtool.resample(JContext.resample(lambda p, d: jstatus.append((p, d))), jcfg.Settings(),
                   tmp_path / "in.wav", "out.wav", rout)
    monkeypatch.chdir(tmp_path / "port")
    resample_tool.resample(Context.resample(lambda p, d: status.append((p, d))), cfg.Settings(),
                           tmp_path / "in.wav", "out.wav", rout, device="cpu")
    assert status == jstatus and status[-1] == (1.0, "Finished")
    got, spec = wav.load_wav(tmp_path / "port" / "out.wav", raw_int16=True)
    want, jspec = jwav.load_wav(tmp_path / "jax" / "out.wav", raw_int16=True)
    assert astuple(spec) == astuple(jspec) == (1, rout, 16, "int")
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    assert int(os.stat(tmp_path / "port" / "out.wav").st_mtime) == MTIME
    assert "Resampling" in caplog.text


def test_resample_tool_errors_match_jax(tmp_path):
    """Too few samples for one output, and a rate pair whose interpolated
    rate overflows u32: the same error class and message in both."""
    short = tmp_path / "short.wav"
    wav.write_wav(short, np.arange(1, 11, dtype=np.float32), wav.WavSpec(1, 48000, 16, "int"))
    prime = tmp_path / "prime.wav"
    wav.write_wav(prime, np.arange(1, 200, dtype=np.float32), wav.WavSpec(1, 99371, 16, "int"))
    for path, rate, jexc, exc in ((short, 11025, jerr.InternalError, err.InternalError),
                                  (prime, 93911, jerr.RateOverflowError, err.RateOverflowError)):
        with pytest.raises(jexc) as jinfo:
            jtool.resample(JContext.resample(), jcfg.Settings(), path, tmp_path / "j.wav", rate)
        with pytest.raises(exc) as info:
            resample_tool.resample(Context.resample(), cfg.Settings(), path, tmp_path / "p.wav",
                                   rate, device="cpu")
        assert str(info.value) == str(jinfo.value)
    assert not (tmp_path / "p.wav").exists()


def test_resample_tool_refuses_unported_export_and_missing_cuda(tmp_path, monkeypatch):
    """``--export-resample-filtered`` (once refused here) with ``--wav-steps``
    against the JAX tool at 11025 -> 48000 (l 640, m 147): the output WAV on
    the export grid within 1 LSB, the same step WAVs, the expanded signal
    (640 samples a sample) within 1e-5 of its peak; without CUDA the tool
    raises unless asked for the CPU."""
    _seeded_wav(tmp_path / "in.wav", 11025, seconds=0.2)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "jax":
            jtool.resample(JContext.resample(export_wav=True, export_resample_filtered=True),
                           jcfg.Settings(), tmp_path / "in.wav", "out.wav", 48000)
        else:
            resample_tool.resample(Context.resample(export_wav=True, export_resample_filtered=True),
                                   cfg.Settings(), tmp_path / "in.wav", "out.wav", 48000, device="cpu")
    names = sorted(p.name for p in (tmp_path / "port").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.wav")) == [
        "00_input.wav", "01_resample_filter.wav", "02_resample_filtered.wav", "03_resample_result.wav",
        "out.wav"]
    got, spec = wav.load_wav(tmp_path / "port" / "out.wav", raw_int16=True)
    want, jspec = jwav.load_wav(tmp_path / "jax" / "out.wav", raw_int16=True)
    assert astuple(spec) == astuple(jspec) and got.shape == want.shape
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    ef, ef_spec = wav.load_wav(tmp_path / "port" / "02_resample_filtered.wav")
    jef, jef_spec = jwav.load_wav(tmp_path / "jax" / "02_resample_filtered.wav")
    assert ef_spec.sample_rate == jef_spec.sample_rate == 11025 * 640 and ef.shape == jef.shape
    assert float(np.abs(ef - jef).max()) <= 1e-5 * float(np.abs(jef).max())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resample_tool.resample(Context.resample(), cfg.Settings(), tmp_path / "in.wav",
                                   tmp_path / "gone.wav", 6240)
    assert not (tmp_path / "gone.wav").exists()
