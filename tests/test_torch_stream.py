"""The port's live decode (``noaa_apt_tpu_torch/stream.py``) and its PCM
stream reader (``io/wav.PcmStreamReader``) against the JAX package's, on
the CPU.

The same seeded recordings go through the port's ``StreamingDecoder`` (in
random push sizes), the port's offline ``Decoder.decode`` and the JAX
package's ``StreamingDecoder``.  The sync positions must be equal in all
three; the streamed rows must equal the port's offline rows bit for bit,
and the JAX package's rows within 1e-4 of their peak (the two backends'
float sums round differently; measured worst: 5.7e-7 of the peak, at
48000 Hz fast).
The reader must return, chunk by chunk, exactly the JAX reader's samples.
"""

import io
import struct

import numpy as np
import pytest
import torch

from noaa_apt_tpu import err as jerr
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.stream import StreamingDecoder as JStreamingDecoder
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph.decode import DecodeTables, Decoder
from noaa_apt_tpu_torch.io import wav
from noaa_apt_tpu_torch.stream import StreamingDecoder, chunk_alignment

torch.set_num_threads(1)

ROWS = 24


def _push_in_chunks(sd, signal, rng) -> np.ndarray:
    rows, i = [], 0
    while i < len(signal):
        n = int(rng.integers(1, 40000))
        out = sd.push(signal[i : i + n])
        if out.size:
            rows.append(out)
        i += n
    rows.append(sd.finish())
    return np.concatenate(rows)


@pytest.fixture(scope="module")
def recordings():
    """rate -> a seeded recording of ``ROWS`` rows at that rate."""
    return {rate: synth_recording(n_rows=ROWS, sample_rate=rate, noise_db=16.0, seed=3)[0]
            for rate in (11025, 24960, 48000)}


@pytest.mark.parametrize("rate_hz,profile", [(11025, "standard"), (24960, "standard"), (48000, "fast")])
def test_stream_matches_offline_and_jax(recordings, rate_hz, profile):
    """l = 832 ("class" on the card), l == 1 (the causal FIR decimated by
    2) and l = 26: rows bit-equal to the port's offline decode."""
    signal = recordings[rate_hz]
    offline = Decoder(PROFILES[profile], device="cpu").decode(signal, Rate(rate_hz))
    sd = StreamingDecoder(PROFILES[profile], Rate(rate_hz), device="cpu")
    rows = _push_in_chunks(sd, signal, np.random.default_rng(rate_hz))
    jsd = JStreamingDecoder(JPROFILES[profile], JRate(rate_hz))
    jrows = _push_in_chunks(jsd, signal, np.random.default_rng(rate_hz + 1))

    assert sd.chunk_bit_exact and sd.chunks >= 3
    assert sd.sync_positions == offline.sync_positions == jsd.sync_positions
    assert sd.n_rows == rows.shape[0] == offline.n_rows
    np.testing.assert_array_equal(rows, offline.image_np())
    assert rows.shape == jrows.shape
    assert float(np.abs(rows - jrows).max()) <= 1e-4 * float(np.abs(jrows).max())
    assert len(sd.chunk_ms) == sd.chunks and sd.fold_s > 0


def test_stream_no_sync_matches_offline(recordings):
    signal = recordings[11025]
    offline = Decoder(PROFILES["standard"], device="cpu").decode(signal, Rate(11025), sync=False)
    sd = StreamingDecoder(PROFILES["standard"], Rate(11025), sync=False, device="cpu")
    rows = _push_in_chunks(sd, signal, np.random.default_rng(0))
    np.testing.assert_array_equal(rows, offline.image_np())
    assert rows[0, 0] == 0.0 and sd.sync_positions is None and sd.fold_s == 0.0
    jsd = JStreamingDecoder(JPROFILES["standard"], JRate(11025), sync=False)
    jrows = _push_in_chunks(jsd, signal, np.random.default_rng(0))
    assert float(np.abs(rows - jrows).max()) <= 1e-4 * float(np.abs(jrows).max())


def test_stream_one_sample_pushes_emit_rows_early():
    """One-sample pushes for a prefix stay exact, and rows arrive before
    ``finish``."""
    signal, _ = synth_recording(n_rows=14, sample_rate=11025, noise_db=18.0, seed=1)
    offline = Decoder(PROFILES["standard"], device="cpu").decode(signal, Rate(11025))
    sd = StreamingDecoder(PROFILES["standard"], Rate(11025), chunk_rows=4, device="cpu")
    rows = [sd.push(signal[i : i + 1]) for i in range(3000)]
    rows.append(sd.push(signal[3000:]))
    mid = sum(r.shape[0] for r in rows)
    rows.append(sd.finish())
    assert mid > 0, "no rows emitted before finish()"
    np.testing.assert_array_equal(np.concatenate(rows), offline.image_np())
    assert sd.sync_positions == offline.sync_positions


def test_stream_guards():
    """Push after finish raises the JAX package's error; finish twice
    returns no rows."""
    sd = StreamingDecoder(PROFILES["standard"], Rate(11025), device="cpu")
    sd.push(np.zeros(100, np.float32))
    assert sd.finish().shape == (0, 2080)
    with pytest.raises(err.InternalError, match=r"push\(\) after finish\(\)"):
        sd.push(np.zeros(10, np.float32))
    assert sd.finish().shape == (0, 2080)
    jsd = JStreamingDecoder(JPROFILES["standard"], JRate(11025))
    jsd.push(np.zeros(100, np.float32))
    jsd.finish()
    with pytest.raises(jerr.InternalError) as info:
        jsd.push(np.zeros(10, np.float32))
    assert str(info.value) == "push() after finish()"


@pytest.mark.parametrize("chunk_rows", [1, 4, 8])
def test_stream_chunk_rows_give_equal_rows(recordings, chunk_rows):
    """The chunk size moves the chunk boundaries, not the rows."""
    signal = recordings[48000]
    offline = Decoder(PROFILES["fast"], device="cpu").decode(signal, Rate(48000))
    sd = StreamingDecoder(PROFILES["fast"], Rate(48000), chunk_rows=chunk_rows, device="cpu")
    rows = _push_in_chunks(sd, signal, np.random.default_rng(chunk_rows))
    np.testing.assert_array_equal(rows, offline.image_np())
    assert sd.w % chunk_alignment(sd.l) == 0 and sd.l_ctx % sd.l == 0 and sd.g_ctx % sd.l == 0


@pytest.mark.parametrize("rate_hz,profile", [(11025, "standard"), (48000, "standard"), (41600, "slow")])
def test_stream_geometry_matches_jax(rate_hz, profile):
    """Chunk, halos and input strides: the port aligns to whole polyphase
    periods (l), so its chunk is never wider than the JAX package's."""
    sd = StreamingDecoder(PROFILES[profile], Rate(rate_hz), device="cpu")
    jsd = JStreamingDecoder(JPROFILES[profile], JRate(rate_hz))
    t = DecodeTables.design(PROFILES[profile], Rate(rate_hz))
    assert (sd.l, sd.m, sd.guard) == (jsd.l, jsd.m, jsd.guard) == (t.l, t.m, t.template.shape[0])
    assert sd.w <= jsd.w and sd.ci == sd.w * sd.m // sd.l
    assert chunk_alignment(sd.l) == max(1, t.l)
    if t.l == 1:
        assert (sd.l_in, sd.r_in) == (sd.l_ctx * t.m + t.bank.shape[1] - 1, sd.g_ctx * t.m)


class _ChunkedPipe:
    """A binary stream that returns at most ``chunk`` bytes per read."""

    def __init__(self, data: bytes, chunk: int = 777):
        self._data, self._i, self._chunk = data, 0, chunk

    def read(self, n: int) -> bytes:
        n = min(n, self._chunk)
        b = self._data[self._i : self._i + n]
        self._i += len(b)
        return b


def _wav_bytes(samples: np.ndarray, rate: int, bits: int = 16, fmt: str = "int") -> bytes:
    """A mono WAV byte stream of 16-bit PCM or 32-bit float samples."""
    buf = io.BytesIO()
    if fmt == "float":
        data, code = samples.astype("<f4").tobytes(), 3
    else:
        data, code = samples.astype("<i2").tobytes(), 1
    fmt_chunk = struct.pack("<HHIIHH", code, 1, rate, rate * bits // 8, bits // 8, bits)
    buf.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(data)) + b"WAVE")
    buf.write(b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk)
    buf.write(b"data" + struct.pack("<I", len(data)) + data)
    return buf.getvalue()


def _read_all(reader, frames: int) -> list:
    out = []
    while True:
        chunk = reader.read(frames)
        if chunk is None:
            return out
        out.append(chunk)


def _pcm(n: int = 20011, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(-32768, 32768, n).astype(np.int16)


def _same_stream(data: bytes, frames: int = 4096, **kw) -> list:
    """The port's and the JAX reader's chunks over 777-byte pipe reads:
    equal one for one, float32; returns the port's."""
    ours = wav.PcmStreamReader(_ChunkedPipe(data), **kw)
    theirs = jwav.PcmStreamReader(_ChunkedPipe(data), **kw)
    assert ours.spec.__dict__ == theirs.spec.__dict__
    got, want = _read_all(ours, frames), _read_all(theirs, frames)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("case", ["wav_s16", "wav_f32", "raw_s16", "raw_f32", "trailing_metadata",
                                  "size_0", "size_ffffffff", "size_7ffffffe", "short_at_eof"])
def test_pcm_stream_reader_matches_jax(case):
    pcm = _pcm()
    if case == "wav_s16":
        got = _same_stream(_wav_bytes(pcm, 11025))
        np.testing.assert_array_equal(np.concatenate(got), pcm.astype(np.float32))
    elif case == "wav_f32":
        _same_stream(_wav_bytes(pcm.astype(np.float32) / 7, 48000, 32, "float"))
    elif case == "raw_s16":
        got = _same_stream(pcm.astype("<i2").tobytes(), rate=11025)
        np.testing.assert_array_equal(np.concatenate(got), pcm.astype(np.float32))
    elif case == "raw_f32":
        x = pcm.astype(np.float32) / 3
        got = _same_stream(x.astype("<f4").tobytes(), rate=11025, raw_fmt="f32")
        np.testing.assert_array_equal(np.concatenate(got), x)
    elif case == "trailing_metadata":
        data = bytearray(_wav_bytes(pcm, 11025))
        meta = b"LIST" + struct.pack("<I", 12) + b"INFOIART" + struct.pack("<I", 0)
        struct.pack_into("<I", data, 4, struct.unpack_from("<I", data, 4)[0] + len(meta))
        got = _same_stream(bytes(data) + meta)
        assert sum(c.size for c in got) == pcm.size  # the declared size is honoured
    elif case.startswith("size_"):
        data = bytearray(_wav_bytes(pcm, 11025))
        assert data[36:40] == b"data"
        struct.pack_into("<I", data, 40, int(case[5:], 16))
        got = _same_stream(bytes(data) + b"\x01\x00\x02")  # read to the end; the odd byte dropped
        assert sum(c.size for c in got) == pcm.size + 1
    else:
        got = _same_stream(_wav_bytes(pcm, 11025)[:-3], frames=5000)  # a truncated stream
        assert sum(c.size for c in got) == pcm.size - 2


def test_pcm_stream_reader_errors_match_jax():
    """No rate for raw PCM, a bad format, and a WAV without a data chunk:
    the same error classes and messages."""
    raw = _pcm(100).astype("<i2").tobytes()
    for make, jmake in (
        (lambda: wav.PcmStreamReader(io.BytesIO(raw)), lambda: jwav.PcmStreamReader(io.BytesIO(raw))),
        (lambda: wav.PcmStreamReader(io.BytesIO(raw), rate=8000, fmt="u8"),
         lambda: jwav.PcmStreamReader(io.BytesIO(raw), rate=8000, fmt="u8")),
        (lambda: wav.PcmStreamReader(io.BytesIO(_wav_bytes(_pcm(10), 8000)[:36])),
         lambda: jwav.PcmStreamReader(io.BytesIO(_wav_bytes(_pcm(10), 8000)[:36]))),
    ):
        with pytest.raises(err.AptError) as info:
            make()
        with pytest.raises(jerr.AptError) as jinfo:
            jmake()
        assert type(info.value).__name__ == type(jinfo.value).__name__
        assert str(info.value) == str(jinfo.value)
