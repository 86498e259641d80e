"""The decoder's staged upload of a mapped recording (``graph/upload.py``) on the CPU.

On the CPU the ring's slots are plain tensors and each copy has ended when
it returns, so the walk that runs on the card (pool reads into the slots,
each slot copied into the device buffer at its offset, the channel-0 take)
runs here too.  A ring of three 4 KiB slots stands in for the card's, so
that every pass wraps round it.  Each staged upload must be the host copy's
upload bit for bit: ``np.asarray(signal)[:n]``, cast to float32 where it is
not int16 or where float32 is asked for, as ``Decoder._upload`` made it
before the ring.  Inputs whose bytes cannot be found in their file (an
array in RAM, a reversed or copy-on-write map, a dtype K1 does not read,
a file no longer there) take that host copy themselves.
"""

import os
import struct
import sys
import threading

import numpy as np
import pytest
import torch

from noaa_apt_tpu_torch import cli, err
from noaa_apt_tpu_torch.core.profiles import STANDARD
from noaa_apt_tpu_torch.graph import upload
from noaa_apt_tpu_torch.graph.decode import Decoder
from noaa_apt_tpu_torch.io import wav
from noaa_apt_tpu_torch.synth import synth_recording

torch.set_num_threads(1)

SLOT = 4096
FRAMES = 10_007  # not a whole number of slots; stereo float spans 20 slots of a 3-slot ring


def write_wav_frames(path, frames: np.ndarray, tail: bytes = b"", rate: int = 48000) -> None:
    """``frames`` (``[n, channels]`` of ``<i2`` or ``<f4``) as a WAV; float in
    SDR#'s layout (a ``fact`` chunk, the data 58 bytes in); ``tail``: bytes
    after the frames inside the data chunk (a partial frame)."""
    n, ch = frames.shape
    bits, tag = frames.dtype.itemsize * 8, 3 if frames.dtype.kind == "f" else 1
    fmt = struct.pack("<HHIIHH", tag, ch, rate, rate * ch * bits // 8, ch * bits // 8, bits)
    if tag == 3:
        fmt += struct.pack("<H", 0)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if tag == 3:
        body += b"fact" + struct.pack("<II", 4, n)
    data = frames.tobytes() + tail
    body += b"data" + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def pcm(seed: int, n: int = FRAMES, ch: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(-32768, 32768, (n, ch), dtype=np.int64).astype("<i2")


def floats(seed: int, n: int = FRAMES, ch: int = 2) -> np.ndarray:
    """Random float32 frames with NaN, infinities, -0.0 and subnormals in channel 0."""
    x = np.random.default_rng(seed).standard_normal((n, ch)).astype("<f4")
    x[[3, n // 2, n - 1], 0] = [np.nan, np.inf, -np.inf]
    x[[11, 12], 0] = [-0.0, np.float32(1e-42)]
    return x


def loaded(tmp_path, frames, name="p.wav", tail=b""):
    write_wav_frames(tmp_path / name, frames, tail)
    return wav.load_device_ready(tmp_path / name)[0]


def raw_map(tmp_path, data: np.ndarray, offset: int, mode: str = "r") -> np.memmap:
    """``data`` written ``offset`` bytes into a file, mapped as it lies."""
    path = tmp_path / "raw.bin"
    path.write_bytes(b"\x7f" * offset + data.tobytes())
    return np.memmap(path, data.dtype, mode=mode, offset=offset, shape=data.shape)


def channel_1(tmp_path):
    """A view that starts inside a frame: channel 1 of a stereo map."""
    write_wav_frames(tmp_path / "s.wav", pcm(7, ch=2))
    m = np.memmap(tmp_path / "s.wav", np.uint8, mode="r", offset=44)
    return m.view("<i2")[1::2]


def deleted(tmp_path):
    sig = loaded(tmp_path, pcm(9, ch=2))
    os.unlink(tmp_path / "p.wav")  # the map stays readable; the file cannot be opened again
    return sig


# name -> (make signal, n_true or None for all, dtype, goes through the ring)
CASES = {
    "mono_int16": (lambda t: loaded(t, pcm(1)), None, None, True),
    "stereo_int16": (lambda t: loaded(t, pcm(2, ch=2)), None, None, True),
    "stereo_float32": (lambda t: loaded(t, floats(3)), None, None, True),
    "mono_float32": (lambda t: loaded(t, floats(4, ch=1)), None, None, True),
    "n_true_below_the_frames": (lambda t: loaded(t, floats(5)), 7_001, None, True),
    "trailing_partial_frame": (lambda t: loaded(t, pcm(6, ch=2), tail=b"\1\2\3"), None, None, True),
    "odd_file_offset": (lambda t: raw_map(t, pcm(8)[:, 0], 13), None, None, True),
    "offset_past_a_page": (lambda t: raw_map(t, floats(8)[:, 0], 3 * 4096 + 907), None, None, True),
    "slice_from_mid_file": (lambda t: loaded(t, floats(10))[1234:], FRAMES - 1234 - 5, None, True),
    "row_of_a_2d_map": (lambda t: raw_map(t, pcm(11, 3 * 4001).reshape(3, 4001), 44)[1], None, None, True),
    "view_inside_a_frame": (channel_1, None, None, True),
    "int16_as_float32": (lambda t: loaded(t, pcm(12, ch=2)), None, np.float32, True),
    "within_one_slot": (lambda t: loaded(t, floats(13, n=100)), None, None, True),
    "array_in_ram": (lambda t: wav.load_wav(_written(t, floats(14)))[0], None, None, False),
    "reversed_map": (lambda t: loaded(t, pcm(15))[::-1], None, None, False),
    "copy_on_write_map": (lambda t: raw_map(t, pcm(16)[:, 0], 44, mode="c"), None, None, False),
    "float64_map": (lambda t: raw_map(t, floats(17, ch=1)[:, 0].astype("<f8"), 44), None, None, False),
    "file_deleted_after_the_map": (deleted, None, None, False),
}


def _written(tmp_path, frames):
    write_wav_frames(tmp_path / "r.wav", frames)
    return tmp_path / "r.wav"


def host_copy(signal, n: int, dtype=None) -> torch.Tensor:
    """The upload before the ring: the host's copy (or float32 cast) of the samples."""
    arr = np.asarray(signal)[:n]
    if arr.dtype != np.int16 or dtype == np.float32:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {torch.float32: torch.int32, torch.int16: torch.int16}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.fixture
def small_ring(monkeypatch):
    ring = upload.UploadRing("cpu", 3, SLOT)
    monkeypatch.setattr(upload, "upload_ring", lambda device: ring)
    return ring


@pytest.mark.parametrize("case", CASES)
def test_staged_upload_equals_the_host_copy(tmp_path, small_ring, case):
    make, n_true, dtype, staged = CASES[case]
    signal = make(tmp_path)
    n = len(signal) if n_true is None else n_true
    dec = Decoder(STANDARD, device="cpu")
    got = dec._upload(signal, n, dtype)
    assert got.is_contiguous() and got.shape == (n,)
    assert same_bits(got, host_copy(signal, n, dtype))
    chunks = dec.last_upload.get("chunks", 0)
    if staged:
        where = upload.locate(signal, n)
        assert dec.last_upload["bytes"] == where.span == (n - 1) * signal.strides[0] + signal.itemsize
        assert chunks == -(-where.span // SLOT) > 0
    else:
        assert chunks == 0


def test_a_float_pass_wraps_the_ring_many_times(tmp_path, small_ring):
    signal = loaded(tmp_path, floats(18))
    dec = Decoder(STANDARD, device="cpu")
    got = dec._upload(signal, len(signal))
    assert dec.last_upload["chunks"] == -(-(FRAMES * 8 - 4) // SLOT) > 4 * len(small_ring.slots)
    assert same_bits(got, host_copy(signal, len(signal)))


def test_locate_finds_each_sample_in_its_file(tmp_path):
    """The located bytes are the samples: read back from the file at
    ``offset``, ``stride`` apart, they are the view's."""
    for make, n_true, _, staged in CASES.values():
        signal = make(tmp_path)
        where = upload.locate(signal, len(signal) if n_true is None else n_true)
        assert (where is not None) == staged or make is deleted
        if where is not None and os.path.exists(where.path):
            raw = np.fromfile(where.path, np.uint8, count=where.span, offset=where.offset)
            got = np.lib.stride_tricks.as_strided(raw.view(where.dtype), (where.n,), (where.stride,))
            want = np.ascontiguousarray(np.asarray(signal)[: where.n])
            assert np.array_equal(np.ascontiguousarray(got).view(np.uint8), want.view(np.uint8))


def test_the_ring_is_made_once_per_process_and_device(tmp_path, monkeypatch):
    monkeypatch.setattr(upload, "_rings", {})
    monkeypatch.setattr(upload, "_SLOT_BYTES", SLOT)
    made = []
    init = upload.UploadRing.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(upload.UploadRing, "__init__", counted)
    signal = loaded(tmp_path, floats(19))
    dec = Decoder(STANDARD, device="cpu")
    for _ in range(2):
        assert same_bits(dec._upload(signal, len(signal)), host_copy(signal, len(signal)))
        assert Decoder(STANDARD, device="cpu")._upload(signal, 100).shape == (100,)
    assert len(made) == 1 and upload.upload_ring("cpu") is made[0] is upload.upload_ring(torch.device("cpu"))
    assert len(made[0].slots) == 2 * upload._workers() and made[0].slot_bytes == SLOT
    assert not any(s.is_pinned() for s in made[0].slots)  # pinned only for a CUDA device


def test_a_file_cut_after_its_map_raises_and_frees_the_ring(tmp_path, small_ring):
    """The samples are no longer in the file: an error, where the host copy
    would fault reading the map; no read outlives the call, and the ring
    stages the next pass."""
    signal = loaded(tmp_path, floats(20))
    os.truncate(tmp_path / "p.wav", 58 + 8 * 5000)
    with pytest.raises(err.InternalError, match="ended at byte"):
        Decoder(STANDARD, device="cpu")._upload(signal, len(signal))
    assert not small_ring.lock.locked()
    other = loaded(tmp_path, floats(21), name="q.wav")
    assert same_bits(Decoder(STANDARD, device="cpu")._upload(other, len(other)), host_copy(other, len(other)))


def test_threads_sharing_the_ring_each_get_their_own_samples(tmp_path, small_ring):
    """More threads than cores stage different files through one ring at
    once, with a short switch interval: each gets its own samples."""
    signals = [loaded(tmp_path, floats(30 + k, n=3001 + 17 * k), name=f"t{k}.wav") for k in range(12)]
    results, errors = {}, []

    def work(k):
        try:
            for _ in range(3):
                results[k] = Decoder(STANDARD, device="cpu")._upload(signals[k], len(signals[k]))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(len(signals))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    for k, sig in enumerate(signals):
        assert same_bits(results[k], host_copy(sig, len(sig)))


@pytest.mark.parametrize("bits,chunks", [(16, "ring"), (8, 0)])
def test_cli_reports_the_slots_filled(tmp_path, monkeypatch, bits, chunks):
    """``upload_chunks``: the slots of a mapped 16-bit WAV's upload; 0 for an
    8-bit WAV, which is read into RAM and copied as before."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    x, _ = synth_recording(n_rows=40, sample_rate=11025, noise_db=20.0, seed=3)
    q = np.round(x / np.abs(x).max() * 120).astype(np.int16)
    if bits == 16:
        write_wav_frames(tmp_path / "p.wav", q.astype("<i2")[:, None], rate=11025)
    else:
        fmt = struct.pack("<HHIIHH", 1, 1, 11025, 11025, 1, 8)
        data = (q + 128).astype(np.uint8).tobytes()
        body = (b"fmt " + struct.pack("<I", 16) + fmt + b"data" + struct.pack("<I", len(data)) + data
                + b"\0" * (len(data) & 1))
        (tmp_path / "p.wav").write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    report: dict = {}
    assert cli.main([str(tmp_path / "p.wav"), "-o", str(tmp_path / "p.png"), "-q", "--device", "cpu"],
                    report=report) == 0
    if chunks == "ring":
        span = 2 * len(q)
        assert report["upload_chunks"] == -(-span // upload._SLOT_BYTES) > 0 and report["payload_bytes"] == span
    else:
        assert report["upload_chunks"] == 0 and report["wav_mapped"] is False
