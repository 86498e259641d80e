"""The port's step-exporting decode (``graph/debug.decode_with_steps``,
``--wav-steps``) and the ``--export-resample-filtered`` grid against the
JAX package's, on the CPU.

The same seeded recordings go through both packages' ``decode_with_steps``
with a step-exporting context each: the same step WAVs (names, so the
same order of ``context.step_*`` calls, lengths and rates), the same sync
positions, and floats within 1e-4 of each step's peak (the WAV writer
scales each step by its peak; measured worst: 6.0e-7 of the peak, in the
demodulated, synced and export-grid steps).  The export grid (K1 at m = 1,
``ops/resample.expanded_filtered``, cut to the reference's grid) is held
against ``expanded_filtered`` and the JAX grid on short inputs, since it
holds l times as many samples as its input.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noaa_apt_tpu import err as jerr
from noaa_apt_tpu.core import LowpassDcRemoval as JLowpassDcRemoval
from noaa_apt_tpu.core import NoFilter as JNoFilter
from noaa_apt_tpu.core.frequency import Freq as JFreq
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.graph import debug as jdebug
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.io.context import Context as JContext
from noaa_apt_tpu.ops import resample as jrs
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch.core import LowpassDcRemoval, NoFilter
from noaa_apt_tpu_torch.core.frequency import Freq, Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph import debug
from noaa_apt_tpu_torch.graph.decode import Decoder, _plan_resample_with_filter
from noaa_apt_tpu_torch.io import wav
from noaa_apt_tpu_torch.io.context import Context
from noaa_apt_tpu_torch.ops import resample as rs

torch.set_num_threads(1)

TOL = 1e-4


def _steps(path: Path) -> dict:
    """name -> (spec, samples) of every step WAV in ``path``."""
    out = {}
    for p in sorted(path.glob("*.wav")):
        x, spec = wav.load_wav(p)
        out[p.name] = (spec, x)
    return out


def _close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape, what
    peak = float(np.abs(want).max(initial=0.0))
    assert float(np.abs(got - want).max(initial=0.0)) <= TOL * max(peak, 1e-30), what


def _run_both(tmp_path, signal, rate: int, profile: str, sync: bool, export: bool):
    """Both packages' decode_with_steps into ``tmp_path/{port,jax}`` ->
    (port flat, JAX flat, port sync list or None, JAX sync list)."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    work = PROFILES[profile].work_rate
    ctx = Context.decode(work_rate=Rate(work), export_wav=True, export_resample_filtered=export,
                         output_dir=tmp_path / "port")
    jctx = JContext.decode(work_rate=JRate(work), export_wav=True, export_resample_filtered=export,
                           output_dir=tmp_path / "jax")
    flat, positions = debug.decode_with_steps(ctx, PROFILES[profile], signal, Rate(rate), sync, "cpu")
    jpositions: list = []
    real = jdebug.sy.find_sync_peaks

    def spy(corr, work_rate):
        jpositions.extend(real(corr, work_rate))
        return list(jpositions)

    jdebug.sy.find_sync_peaks = spy
    try:
        jflat = jdebug.decode_with_steps(jctx, JPROFILES[profile], signal, JRate(rate), sync)
    finally:
        jdebug.sy.find_sync_peaks = real
    return flat, np.asarray(jflat), positions, jpositions


@pytest.mark.parametrize("rate_hz,profile,sync,export", [
    (11025, "standard", True, False), (24960, "standard", True, True), (48000, "standard", True, True),
    (11025, "standard", False, False),
])
def test_decode_with_steps_matches_jax(tmp_path, rate_hz, profile, sync, export):
    """l = 832, l == 1 (with the full-rate causal FIR exported) and l = 13
    through the export grid; and without sync."""
    signal, _ = synth_recording(n_rows=14, sample_rate=rate_hz, noise_db=18.0, seed=4)
    flat, jflat, positions, jpositions = _run_both(tmp_path, signal, rate_hz, profile, sync, export)
    assert (positions is None) == (not sync) and (positions or []) == jpositions
    assert (len(jpositions) > 5) == sync
    _close(flat, jflat, "decoded signal")
    got, want = _steps(tmp_path / "port"), _steps(tmp_path / "jax")
    assert list(got) == list(want)
    expected = {"00_input.wav", "01_resample_filter.wav", "03_resample_decimated.wav",
                "04_demodulated_unfiltered.wav", "05_demodulation_filter.wav", "06_demodulated.wav",
                "08_synced.wav", "09_resample_filter.wav", "11_resample_decimated.wav"}
    expected |= {"07_sync_correlation.wav"} if sync else set()
    expected |= {"02_resample_filtered.wav", "10_resample_filtered.wav"} if export else set()
    assert set(got) == expected
    for name in got:
        (spec, x), (jspec, jx) = got[name], want[name]
        assert spec == jspec, name
        _close(x, jx, name)


@pytest.mark.parametrize("rate_hz,export", [(48000, False), (24960, True)])
def test_decode_with_steps_is_the_offline_decode(tmp_path, rate_hz, export):
    """Off the export grid the step path's rows are the offline decode's
    (``Decoder.decode``), bit for bit: K1 on the float32 samples, K2, K3,
    and the NoFilter decimation as K1 over ``causal_input``.  At l == 1
    the export flag keeps the grid: the full-rate causal FIRs it writes
    (K1 at m = 1) decimate to the offline samples."""
    signal, _ = synth_recording(n_rows=14, sample_rate=rate_hz, noise_db=18.0, seed=6)
    pcm = np.round(signal / np.abs(signal).max() * 30000).astype(np.int16)
    ctx = Context.decode(export_wav=True, export_resample_filtered=export, output_dir=tmp_path)
    flat, positions = debug.decode_with_steps(ctx, PROFILES["standard"], pcm, Rate(rate_hz), True, "cpu")
    offline = Decoder(PROFILES["standard"], device="cpu").decode(pcm, Rate(rate_hz))
    assert positions == offline.sync_positions
    np.testing.assert_array_equal(flat, offline.signal())
    assert (tmp_path / "02_resample_filtered.wav").exists() == export


def test_decode_with_steps_errors_match_jax(tmp_path):
    """Fewer than 10 rows: the same error class and message."""
    signal, _ = synth_recording(n_rows=8, sample_rate=11025, seed=0)
    with pytest.raises(err.InternalError) as info:
        debug.decode_with_steps(Context.decode(), PROFILES["standard"], signal, Rate(11025), device="cpu")
    with pytest.raises(jerr.InternalError) as jinfo:
        jdebug.decode_with_steps(JContext.decode(), JPROFILES["standard"], signal, JRate(11025))
    assert str(info.value) == str(jinfo.value)


def _filters(rin: int, rout: int, profile: str = "standard"):
    """(port, JAX) stage-1 filter of ``profile`` at ``rin`` (NoFilter for
    the 4160 Hz step)."""
    if rout == 4160:
        return NoFilter(), JNoFilter()
    p = PROFILES[profile]
    kw = dict(atten=p.resample_atten)
    return (LowpassDcRemoval(cutout=Freq.hz(p.resample_cutout, Rate(rin)),
                             delta_w=Freq.hz(p.resample_delta_freq, Rate(rin)), **kw),
            JLowpassDcRemoval(cutout=JFreq.hz(p.resample_cutout, JRate(rin)),
                              delta_w=JFreq.hz(p.resample_delta_freq, JRate(rin)), **kw))


@pytest.mark.parametrize("rin,rout", [(11025, 12480), (48000, 12480), (24960, 12480), (12480, 4160)])
def test_export_grid_matches_jax(tmp_path, rin, rout):
    """``resample_with_filter`` with the export flag on a short input:
    ``resample_filtered`` (l > 1: ``expanded_filtered``; l == 1: the
    full-rate causal FIR) and ``resample_decimated`` (the export grid)
    against the JAX package's; at l > 1 the port's ``ef`` against
    ``expanded_filtered`` directly, and the grid against the non-export
    resample, which it must not equal."""
    x = np.random.default_rng(rin).standard_normal(3001).astype(np.float32) * 1000
    filt, jfilt = _filters(rin, rout)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ctx = Context.resample(export_wav=True, export_resample_filtered=True, output_dir=tmp_path / "port")
    jctx = JContext.resample(export_wav=True, export_resample_filtered=True, output_dir=tmp_path / "jax")
    ctx.step_signal("input", x, Rate(rin))  # slot 0 of the resample table, as the tool sends it
    jctx.step_signal("input", x, JRate(rin))
    y = debug.resample_with_filter(ctx, torch.from_numpy(x), Rate(rin), Rate(rout), filt).numpy()
    jy = np.asarray(jdebug.resample_with_filter(jctx, jnp.asarray(x), JRate(rin), JRate(rout), jfilt))
    _close(y, jy, "resample_decimated")
    got, want = _steps(tmp_path / "port"), _steps(tmp_path / "jax")
    assert list(got) == list(want) == ["00_input.wav", "01_resample_filter.wav",
                                       "02_resample_filtered.wav", "03_resample_result.wav"]
    for name in got:
        assert got[name][0] == want[name][0], name
        _close(got[name][1], want[name][1], name)
    l, m, coeff = _plan_resample_with_filter(Rate(rin), Rate(rout), filt)
    plain = debug.resample_with_filter(None, torch.from_numpy(x), Rate(rin), Rate(rout), filt).numpy()
    if l > 1:
        ef = rs.expanded_filtered(torch.from_numpy(x), l, coeff).numpy()
        _close(ef, np.asarray(jrs.expanded_filtered(jnp.asarray(x), l, coeff)), "expanded_filtered")
        offset = (len(coeff) - 1) // 2
        np.testing.assert_array_equal(y, ef[offset + (m - 1 - offset) % m - offset :: m])
        assert y.shape != plain.shape or not np.array_equal(y, plain)
    else:
        np.testing.assert_array_equal(y, plain)  # the grid does not move at l == 1
