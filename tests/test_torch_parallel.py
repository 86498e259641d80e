"""The port's sequence-sharded decode (``noaa_apt_tpu_torch/parallel/shard.py``)
against its one-device decode and the JAX package's ``ShardedDecoder``, on
the CPU.

The counterpart of ``tests/test_parallel.py`` and of the sharded tests of
``tests/test_parallel_conv.py``.  The port shards over ``["cpu"] * n``
(a device may repeat), the JAX package over the 8 virtual CPU devices of
``tests/conftest.py``.  On the same seeded recordings:

- the port's sharded images are ``torch.equal`` to its one-device decode,
  and its sharded u8 renders byte-equal to the one-device renders;
- the sync lists equal the JAX ``ShardedDecoder``'s;
- the images lie within 1e-5 of their peak of the JAX package's, and the
  u8 renders within +-1 on at most 0.1% of pixels (the two backends' float
  sums round differently, ``tests/test_torch_decode.py``).

Rates: 11025 Hz (K1 "class"), 48000 Hz ("block"), 24960 and 12480 Hz
(the l == 1 decimation, m = 2 and m = 1).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from PIL import Image

from noaa_apt_tpu.cli import inner_main as jax_cli
from noaa_apt_tpu.core.filters import LowpassDcRemoval as JLowpassDcRemoval
from noaa_apt_tpu.core.frequency import Freq as JFreq
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import STANDARD as JSTANDARD
from noaa_apt_tpu.graph import decode as jdecode
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.parallel import ShardedDecoder as JShardedDecoder
from noaa_apt_tpu.parallel import batch_decode as jbatch_decode
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch import cli
from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import STANDARD
from noaa_apt_tpu_torch.err import InternalError
from noaa_apt_tpu_torch.graph.decode import Decoder, PendingRender
from noaa_apt_tpu_torch.graph.process import process
from noaa_apt_tpu_torch.io import png
from noaa_apt_tpu_torch.io.context import Context
from noaa_apt_tpu_torch.parallel import Mesh, ShardedDecoder, batch_decode
from noaa_apt_tpu_torch.types import Contrast, Rotate

torch.set_num_threads(1)


def _mesh(n: int, axis: str = "seq") -> Mesh:
    return Mesh(["cpu"] * n, (axis,))


def _jmesh(n: int, axis: str = "seq") -> JMesh:
    return JMesh(np.array(jax.devices()[:n]), (axis,))


def _u8_close(got: np.ndarray, want: np.ndarray, label: str) -> int:
    """+-1 on at most 0.1% of pixels; returns the count that differ."""
    assert got.shape == want.shape, label
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n_diff = int((d > 0).sum())
    assert d.max(initial=0) <= 1, label
    assert n_diff <= 1e-3 * d.size, label
    return n_diff


def _close_to_jax(got: np.ndarray, want: np.ndarray, label: str) -> None:
    assert got.shape == want.shape, label
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got - want).max()) <= 1e-5 * scale, label


# (rate, devices): "class", "block", and l == 1 at m = 2 and m = 1.
SHARD_CASES = [(11025, 2), (11025, 4), (11025, 8), (48000, 4), (24960, 2), (24960, 4), (12480, 4)]


@pytest.mark.parametrize("rate_hz,n_dev", SHARD_CASES)
def test_sharded_equals_single_and_jax(rate_hz, n_dev):
    signal, _ = synth_recording(n_rows=24, sample_rate=rate_hz, noise_db=15.0)
    single = Decoder(STANDARD, device="cpu").decode(signal, Rate(rate_hz))
    sdec = ShardedDecoder(STANDARD, _mesh(n_dev))
    sharded = sdec.decode(signal, Rate(rate_hz))
    assert sharded.sync_positions == single.sync_positions and sharded.n_rows == single.n_rows
    assert torch.equal(sharded.image, single.image)
    assert sdec.chunk_bit_exact and sdec.n_dev == n_dev
    assert list(sdec.last_stage_ms) == ["upload", "halo", "resample", "demod_fir_corr", "gather",
                                        "select", "rows"]
    jdec = JShardedDecoder(JSTANDARD, _jmesh(n_dev))
    jres = jdec.decode(signal, JRate(rate_hz))
    assert sharded.sync_positions == jres.sync_positions
    _close_to_jax(sharded.image_np(), jres.image_np(), f"{rate_hz} Hz on {n_dev}")
    _u8_close(Decoder.render_u8(sharded, "percent"), jdec.render_u8(jres, "percent"), f"{rate_hz}/{n_dev}")


def test_sharded_int16_input_equals_single():
    """16-bit PCM goes to the devices as int16 (K1 converts in-register),
    as the CLI uploads it; the rows equal the one-device decode's."""
    signal, _ = synth_recording(n_rows=20, sample_rate=48000, noise_db=15.0, seed=4)
    pcm = np.round(signal / np.abs(signal).max() * 30000).astype(np.int16)
    single = Decoder(STANDARD, device="cpu").decode(pcm, Rate(48000))
    sdec = ShardedDecoder(STANDARD, _mesh(3))
    sharded = sdec.decode(pcm, Rate(48000))
    assert sharded.sync_positions == single.sync_positions
    assert torch.equal(sharded.image, single.image)
    assert sdec.last_upload["bytes"] == len(pcm) * 2  # the samples, not the padding


def test_sharded_no_sync():
    signal, _ = synth_recording(n_rows=24, sample_rate=11025)
    single = Decoder(STANDARD, device="cpu").decode(signal, Rate(11025), sync=False)
    sharded = ShardedDecoder(STANDARD, _mesh(4)).decode(signal, Rate(11025), sync=False)
    assert sharded.sync_positions is None and torch.equal(sharded.image, single.image)
    jres = JShardedDecoder(JSTANDARD, _jmesh(4)).decode(signal, JRate(11025), sync=False)
    _close_to_jax(sharded.image_np(), jres.image_np(), "no sync")


@pytest.mark.parametrize("kind", ["percent", "minmax", "telemetry"])
def test_sharded_fused_render_matches_single_and_jax(kind):
    """The fused renders: u8 rows and sync list byte-equal to the
    one-device render, and the JAX sharded render's within +-1."""
    n_rows = 240 if kind == "telemetry" else 32  # telemetry needs >= 200 decoded rows
    signal, _ = synth_recording(n_rows=n_rows, sample_rate=11025, noise_db=15.0)
    u8_1, sync_1 = Decoder(STANDARD, device="cpu").decode_render_input(signal, len(signal), Rate(11025), kind)
    u8_s, sync_s = ShardedDecoder(STANDARD, _mesh(4)).decode_render_input(signal, len(signal), Rate(11025),
                                                                          kind)
    assert sync_s == sync_1 and np.array_equal(u8_s, u8_1)
    ju8, jsync = JShardedDecoder(JSTANDARD, _jmesh(4)).decode_render_input(signal, len(signal), JRate(11025),
                                                                          kind)
    assert sync_s == jsync
    _u8_close(u8_s, ju8, kind)


def test_sharded_fused_render_deferred_and_48k():
    """``fetch=False`` returns a PendingRender; a pre-uploaded tensor must
    be ``n_pad`` long."""
    signal, _ = synth_recording(n_rows=24, sample_rate=48000, noise_db=15.0)
    u8_1, sync_1 = Decoder(STANDARD, device="cpu").decode_render_input(signal, len(signal), Rate(48000))
    sdec = ShardedDecoder(STANDARD, _mesh(8))
    pending = sdec.decode_render_input(signal, len(signal), Rate(48000), "percent", fetch=False)
    assert isinstance(pending, PendingRender)
    u8_s, sync_s = pending.get()
    assert sync_s == sync_1 and np.array_equal(u8_s, u8_1)
    assert "fetch_image" in sdec.last_stage_ms
    n_pad = sdec.plan(len(signal), Rate(48000)).n_pad
    x = torch.zeros(n_pad, dtype=torch.float32)
    x[: len(signal)] = torch.from_numpy(signal.astype(np.float32))
    u8_t, sync_t = sdec.decode_render_input(x, len(signal), Rate(48000))
    assert sync_t == sync_1 and np.array_equal(u8_t, u8_1)
    with pytest.raises(InternalError, match="pre-uploaded input is"):
        sdec.decode_render_input(x[:-1], len(signal), Rate(48000))
    ju8, jsync = JShardedDecoder(JSTANDARD, _jmesh(8)).decode_render_input(signal, len(signal), JRate(48000),
                                                                          "percent")
    assert sync_s == jsync
    _u8_close(u8_s, ju8, "48k on 8")


def test_sharded_2d_mesh_data_and_seq():
    """A ("data", "seq") mesh: each recording time-sharded over its seq
    axis of 4 devices."""
    mesh = Mesh([["cpu"] * 4] * 2, ("data", "seq"))
    assert mesh.shape == {"data": 2, "seq": 4}
    sdec = ShardedDecoder(STANDARD, mesh, axis="seq")
    assert sdec.n_dev == 4
    for seed in (1, 2):
        s, _ = synth_recording(n_rows=24, sample_rate=11025, seed=seed)
        got = sdec.decode(s, Rate(11025))
        want = Decoder(STANDARD, device="cpu").decode(s, Rate(11025))
        assert got.sync_positions == want.sync_positions and torch.equal(got.image, want.image)


def test_sharded_decode_reports_progress_and_rejects_host_work():
    signal, _ = synth_recording(n_rows=16, sample_rate=11025)
    dec = ShardedDecoder(STANDARD, _mesh(2))
    seen = []
    dec.decode(signal, Rate(11025), context=Context.decode(ui_callback=lambda p, d: seen.append((p, d))))
    assert (0.1, "Resampling to 12480 (2-chip)") in seen
    assert any(d == "Syncing" for _, d in seen) and any(d == "Resampling to 4160" for _, d in seen)
    with pytest.raises(InternalError, match="host_work"):
        dec.decode(signal, Rate(11025), host_work=np.zeros(200000, np.float32))


def test_halo_wider_than_chunk_raises():
    """Too many devices for the recording: a halo wider than a chunk
    raises the JAX package's error, before the too-short check."""
    signal, _ = synth_recording(n_rows=16, sample_rate=11025)
    with pytest.raises(InternalError, match="Chunk too small for halo exchange: Ci=1470, halo=1488; "):
        ShardedDecoder(STANDARD, _mesh(64)).decode(signal, Rate(11025))
    with pytest.raises(InternalError, match="less than 10 rows"):
        ShardedDecoder(STANDARD, _mesh(2)).decode(signal[: 11025 * 4], Rate(11025))


def test_sharded_result_device_render_matches_single():
    """``process`` renders a sharded result on its device exactly as a
    one-device result."""
    signal, _ = synth_recording(n_rows=24, sample_rate=11025, noise_db=15.0)
    single = Decoder(STANDARD, device="cpu").decode(signal, Rate(11025))
    sharded = ShardedDecoder(STANDARD, _mesh(4)).decode(signal, Rate(11025))
    for contrast in (Contrast.from_percent(0.98), Contrast.minmax()):
        np.testing.assert_array_equal(process(sharded, contrast, Rotate.NO), process(single, contrast, Rotate.NO))


@pytest.mark.parametrize("rate_hz", [24960, 12480, 11025, 48000])
def test_sharded_work_length_matches_jax(rate_hz):
    """The sharded work length is the one-device plan's for every length
    (``tests/test_parallel_conv.py:65-87``)."""
    p = JSTANDARD
    rate = JRate(rate_hz)
    filt = JLowpassDcRemoval(cutout=JFreq.hz(p.resample_cutout, rate), atten=p.resample_atten,
                             delta_w=JFreq.hz(p.resample_delta_freq, rate))
    _, out_len, _ = jdecode._plan_resample_with_filter(2_000_000, rate, JRate(p.work_rate), filt)
    plan = ShardedDecoder(STANDARD, _mesh(2)).plan(2_000_000, Rate(rate_hz))
    assert plan.n_pad >= 2_000_000 and plan.n_pad % 2 == 0
    for n_true in (199_680, 249_600, 249_601, 500_000, 1_999_999):
        assert plan.work_len(n_true) == out_len(n_true), (rate_hz, n_true)


def test_batch_decode_matches_loop_and_jax():
    sigs = [synth_recording(n_rows=24, sample_rate=11025, noise_db=12.0, seed=seed)[0] for seed in range(4)]
    batch = np.stack(sigs)
    dec = Decoder(STANDARD, device="cpu")
    singles = [dec.decode(s, Rate(11025)) for s in sigs]
    results = batch_decode(dec, batch, Rate(11025), _mesh(3, "data"))
    jresults = jbatch_decode(jdecode.Decoder(JSTANDARD), batch, JRate(11025), _jmesh(4, "data"))
    assert len(results) == len(jresults) == 4
    for s, r, j in zip(singles, results, jresults):
        assert r.sync_positions == s.sync_positions == j.sync_positions
        assert torch.equal(r.image, s.image)
        _close_to_jax(r.image_np(), j.image_np(), "batch member")
    nosync = batch_decode(dec, torch.from_numpy(batch[:2]), Rate(11025), _mesh(2, "data"), sync=False)
    assert all(torch.equal(r.image, dec.decode(s, Rate(11025), sync=False).image) for r, s in zip(nosync, sigs))


@pytest.fixture
def pass_wav(tmp_path, monkeypatch):
    """A 30-row 11025 Hz 16-bit WAV in the test's own working directory."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.chdir(tmp_path)
    sig, _ = synth_recording(n_rows=30, sample_rate=11025, noise_db=15.0, seed=5)
    jwav.write_wav(tmp_path / "pass.wav", sig, jwav.WavSpec(1, 11025, 16, "int"))
    return tmp_path / "pass.wav"


@pytest.mark.parametrize("flags", [[], ["--ingest", "host16"]])
def test_cli_distributed_matches_jax(pass_wav, flags):
    """``--distributed 4``: the PNG equals the port's one-device run's and
    the JAX CLI's ``--distributed 4`` (u8 within +-1).  With a host
    ``--ingest`` both CLIs take the unfused path on the raw recording
    (``noaa_apt_tpu/cli.py:455-462``): the port's PNG is then its device-
    ingest run's."""
    report: dict = {}
    assert cli.main([str(pass_wav), "-o", "port.png", "--device", "cpu", "-q", "--distributed", "4", *flags],
                    report=report) == 0
    assert cli.main([str(pass_wav), "-o", "one.png", "--device", "cpu", "-q"]) == 0
    assert Path("port.png").read_bytes() == Path("one.png").read_bytes()
    fused = not flags
    assert ("fetch_image" in report["stage_ms"]) is fused and ("rows" in report["stage_ms"]) is not fused
    assert "gather" in report["stage_ms"]
    assert jax_cli([str(pass_wav), "-o", "jax.png", "-q", "--distributed", "4", *flags]) == 0
    _u8_close(png.read_png("port.png"), np.asarray(Image.open("jax.png")), f"--distributed 4 {flags}")


def test_cli_distributed_raw_out_and_no_sync(pass_wav):
    """``--raw-out`` and ``--no-sync`` take ``ShardedDecoder.decode``: the
    raw signal and PNG equal the one-device run's."""
    for flags in (["--raw-out", "a.npy"], ["--no-sync"]):
        assert cli.main([str(pass_wav), "-o", "s.png", "--device", "cpu", "-q", "--distributed", "3",
                         *flags]) == 0
        one = [f.replace("a.npy", "b.npy") for f in flags]
        assert cli.main([str(pass_wav), "-o", "o.png", "--device", "cpu", "-q", *one]) == 0
        assert Path("s.png").read_bytes() == Path("o.png").read_bytes()
    assert np.array_equal(np.load("a.npy"), np.load("b.npy"))
