"""Stereo and 32-bit float WAVs through the port's CLI on the CPU: the
recorder layouts a station's SDR program writes (SDR#'s 32-bit IEEE
float, stereo), against the mono 16-bit twin of the same pass.

Channel 0 holds the pass (float: the twin's samples / 32768, exact),
channel 1 another pass, so that a read of the wrong channel changes the
image.  The decode is scale-free to the bit (every step is linear or
homogeneous in the samples, and the 98 % levels stretch the result), so
each layout's PNG is the twin's byte for byte, on every path that takes
the samples: the device ingest, the host ingests, the sharded decoder,
the step export and the fleet.  Float and multichannel files are mapped
as the mono 16-bit twin is: ``load_device_ready`` returns channel 0 as a
read-only view of an ``np.memmap`` over the data chunk (strided for
stereo; SDR#'s layout puts the data 2 bytes off a float, so the view is
unaligned too), with ``load_wav``'s samples and chunk semantics, and the
report's ``wav_mapped`` says so.  Every map, the twin's too, records
``apt.wav.read`` and ``apt.wav.convert`` once each and goes to the
device through the decoder's ring (``upload_chunks``), and the card's
float32 take of a float file's channel 0 is ``apt.upload.cast``, once.  Formats
the decoder does not take as they lie (8-, 24- and 32-bit int, 64-bit
float) are read as ``load_wav`` reads them, as before.  The CLI's report
carries the file's size.  Each file loads as the JAX package loads it:
the same samples, dtype, rate and spec, with and without the memmap, and
the same open errors.  Both loaders decode through ``_decode_pcm``.
"""

import dataclasses
import logging
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from aptbench.gen import synth
from aptbench.gen.pool import write_wav
from noaa_apt_tpu import err as jerr
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu_torch import cli, err, serve, spans
from noaa_apt_tpu_torch.graph import decode as graph_decode
from noaa_apt_tpu_torch.graph import upload as graph_upload
from noaa_apt_tpu_torch.io import wav

RATE = 48000
SECONDS = 20.0
ARGS = ["-q", "--device", "cpu", "-p", "standard", "-c", "98_percent"]
KSDATAFORMAT_TAIL = bytes.fromhex("000000001000800000aa00389b71")
LAYOUTS = ("float_tag3_fact", "float_extensible", "int16_stereo", "float_mono")
# (channels, bits, format) of each layout's spec.
SPECS = {"float_tag3_fact": (2, 32, "float"), "float_extensible": (2, 32, "float"), "int16_stereo": (2, 16, "int"),
         "float_mono": (1, 32, "float"), "twin": (1, 16, "int")}


def write_layout(path: Path, layout: str, ch0: np.ndarray, ch1: np.ndarray) -> None:
    """``ch0`` and ``ch1`` (int16 counts) interleaved in ``layout``;
    ``float_mono`` holds ``ch0`` alone, in ``float_tag3_fact``'s layout."""
    chans = [ch0] if layout == "float_mono" else [ch0, ch1]
    if layout == "int16_stereo":
        data, tag, bits, ext = np.stack(chans, axis=1).astype("<i2"), 1, 16, False
    else:
        scale = np.float32(2.0**-15)
        data = np.stack([c.astype(np.float32) * scale for c in chans], axis=1).astype("<f4")
        tag, bits, ext = 3, 32, layout == "float_extensible"
    align = len(chans) * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if ext else tag, len(chans), RATE, RATE * align, align, bits)
    fmt = head + (struct.pack("<HHIH", 22, bits, 3, tag) + KSDATAFORMAT_TAIL if ext else struct.pack("<H", 0))
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if tag == 3:
        body += b"fact" + struct.pack("<II", 4, len(ch0))
    body += b"data" + struct.pack("<I", data.nbytes) + data.tobytes()
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


class Counted(spans.span):
    """``spans.span`` that also keeps the names it was entered with."""

    names: list = []

    def __enter__(self):
        Counted.names.append(self.name)
        return super().__enter__()


def decode(path: Path, *flags: str) -> dict:
    """The CLI on ``path`` with ``flags``: its PNG's bytes, its report and
    the WAV and decoder spans it entered."""
    mp = pytest.MonkeyPatch()
    mp.setattr(Counted, "names", [])
    mp.setattr(wav, "span", Counted)
    mp.setattr(graph_decode, "span", Counted)
    mp.setattr(graph_upload, "span", Counted)
    try:
        report: dict = {}
        out = path.with_name("_".join((path.stem, *flags)).replace("-", "") + ".png")
        assert cli.main([str(path), "-o", str(out), *ARGS, *flags], report=report) == 0
        return {"png": out.read_bytes(), "report": report, "spans": list(Counted.names)}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each layout's CLI run, the twin's, and channel 1's pass alone."""
    d = tmp_path_factory.mktemp("wav_float")
    mp = pytest.MonkeyPatch()
    mp.setenv("XDG_CONFIG_HOME", str(d / "cfg"))
    try:
        cpu = torch.device("cpu")
        ch0 = synth.make_pass(2**40 + 11, SECONDS, RATE, 10.0, 30.0, cpu).numpy()
        ch1 = synth.make_pass(2**40 + 12, SECONDS, RATE, 10.0, 30.0, cpu).numpy()[: len(ch0)]
        assert len(ch1) == len(ch0) and not np.array_equal(ch0, ch1)
        write_wav(d / "twin.wav", ch0, RATE)
        write_wav(d / "other.wav", ch1, RATE)
        out = {"twin": decode(d / "twin.wav"), "other": decode(d / "other.wav")}
        for layout in LAYOUTS:
            write_layout(d / f"{layout}.wav", layout, ch0, ch1)
            out[layout] = decode(d / f"{layout}.wav")
        for name in (*LAYOUTS, "twin"):
            out[name]["path"] = d / f"{name}.wav"
            out[name]["size"] = out[name]["path"].stat().st_size
        out["ch0"], out["ch1"] = ch0, ch1
        yield out
    finally:
        mp.undo()


def test_channel_1_decodes_to_another_image(runs):
    assert runs["other"]["png"] != runs["twin"]["png"]
    assert runs["twin"]["report"]["rows"] >= 30


@pytest.mark.parametrize("layout", LAYOUTS)
def test_png_equals_the_int16_mono_twins(runs, layout):
    assert runs[layout]["png"] == runs["twin"]["png"]
    assert runs[layout]["report"]["rows"] == runs["twin"]["report"]["rows"]


def wav_spans(run: dict) -> list:
    return [n for n in run["spans"] if n.startswith("apt.wav.")]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_wav_spans_once_per_load(runs, layout):
    assert wav_spans(runs[layout]) == ["apt.wav.read", "apt.wav.convert"]


def test_memmap_path_enters_no_wav_span(runs):
    """The twin's map, mono 16-bit, enters each ``apt.wav.*`` span once,
    as every other map does."""
    for name in ("twin", "other"):
        assert wav_spans(runs[name]) == ["apt.wav.read", "apt.wav.convert"]


@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_upload_cast_span_once_for_a_float_file(runs, layout):
    """The card's float32 take of channel 0 runs for a float file only:
    16-bit PCM, stereo or memmapped, ships as int16.  Every map goes
    through the ring once: one ``apt.upload.copy``, one ``apt.upload.h2d``."""
    want = 1 if SPECS[layout][2] == "float" else 0
    assert runs[layout]["spans"].count("apt.upload.cast") == want
    assert runs[layout]["spans"].count("apt.upload.h2d") == 1
    assert runs[layout]["spans"].count("apt.upload.copy") == 1


@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_report_counters_hold_the_files_values(runs, layout):
    rep = runs[layout]["report"]
    assert rep["wav_bytes"] == runs[layout]["size"]
    spec = wav.load_wav(runs[layout]["path"])[1]
    assert (spec.channels, spec.bits_per_sample, spec.sample_format) == SPECS[layout]
    assert rep["wav_mapped"] is True
    assert rep["load_s"] > 0
    assert rep["upload_chunks"] > 0


@pytest.mark.parametrize("use_mmap", [True, False])
@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_load_device_ready_equals_the_jax_packages(runs, layout, use_mmap):
    got, rate = wav.load_device_ready(runs[layout]["path"], use_mmap=use_mmap)
    want, jrate = jwav.load_device_ready(runs[layout]["path"], use_mmap=use_mmap)
    assert got.dtype == want.dtype and np.array_equal(got, want) and rate.get_hz() == jrate.get_hz() == RATE
    # Channel 0, and for the float layouts the twin's counts / 32768 exactly.
    scale = 1.0 if got.dtype == np.int16 else 2.0**-15
    assert np.array_equal(got.astype(np.float64), runs["ch0"] * scale)


@pytest.mark.parametrize("raw_int16", [False, True])
@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_load_wav_equals_the_jax_packages(runs, layout, raw_int16):
    got, spec = wav.load_wav(runs[layout]["path"], raw_int16=raw_int16)
    want, jspec = jwav.load_wav(runs[layout]["path"], raw_int16=raw_int16)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert dataclasses.astuple(spec) == dataclasses.astuple(jspec)
    assert (spec.channels, spec.bits_per_sample, spec.sample_format) == SPECS[layout]


def test_report_counters_none_for_a_raw_signal(tmp_path, monkeypatch):
    """A ``.npy`` input loads no WAV: the counters are there, as None; the
    file's channels, bits and format are not in the report."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    rng = np.random.default_rng(5)
    np.save(tmp_path / "raw.npy", rng.random(2080 * 12, dtype=np.float32))
    report: dict = {}
    assert cli.main([str(tmp_path / "raw.npy"), "-o", str(tmp_path / "raw.png"), *ARGS], report=report) == 0
    assert (report["wav_bytes"], report["wav_mapped"]) == (None, None)
    assert report["upload_chunks"] is None
    assert not {"wav_channels", "wav_bits", "wav_format"} & set(report)


@pytest.mark.parametrize("use_mmap", [True, False])
def test_load_device_ready_counters_match_load_wav(tmp_path, use_mmap):
    """Both paths of ``load_device_ready`` read a mono 16-bit file as
    ``load_wav`` does: the same samples and rate, as int16, a map only
    with ``use_mmap``."""
    x = (np.arange(4000) % 200 - 100).astype(np.float32)
    path = tmp_path / "m.wav"
    wav.write_wav(path, x, wav.WavSpec(1, 11025, 16, "int"))
    got, rate = wav.load_device_ready(path, use_mmap=use_mmap)
    want, spec = wav.load_wav(path)
    assert spec == wav.WavSpec(1, 11025, 16, "int") and rate.get_hz() == 11025
    assert got.dtype == np.int16 and np.array_equal(got.astype(np.float32), want)
    assert isinstance(got, np.memmap) is use_mmap
    assert path.stat().st_size == 44 + 2 * 4000


@pytest.mark.parametrize("use_mmap", [True, False])
@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_load_device_ready_maps_the_data_chunk(runs, layout, use_mmap):
    """With the memmap, channel 0 is a read-only view of the file's map,
    not a copy (SDR#'s layout: 2 bytes off a float); without it,
    ``load_wav``'s array.  Either way it holds ``load_wav``'s channel 0."""
    got, _ = wav.load_device_ready(runs[layout]["path"], use_mmap=use_mmap)
    assert isinstance(got, np.memmap) is use_mmap
    if use_mmap:
        assert not got.flags.owndata and not got.flags.writeable
        assert got.flags.c_contiguous == (SPECS[layout][0] == 1)
        assert got.flags.aligned == (layout not in ("float_tag3_fact", "float_mono"))
    want, _ = wav.load_wav(runs[layout]["path"])
    assert np.array_equal(got.astype(np.float32), want)


@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_mapped_load_logs_the_stereo_warning(runs, layout, caplog):
    with caplog.at_level(logging.WARNING, logger=wav.log.name):
        wav.load_device_ready(runs[layout]["path"])
    warned = [r.getMessage() for r in caplog.records]
    channels = SPECS[layout][0]
    assert warned == ([] if channels == 1 else
                      [f"WAV file has {channels} channels (probably stereo), processing only the first one"])


# --- chunk layouts and formats off the recorders' path -----------------------


def chunk(cid: bytes, body: bytes, size: int | None = None) -> bytes:
    """A RIFF chunk: ``size`` (default the body's) and the pad byte of an odd body."""
    return cid + struct.pack("<I", len(body) if size is None else size) + body + b"\0" * (len(body) & 1)


def riff(tag: int, channels: int, bits: int, *chunks: bytes) -> bytes:
    """A WAV: a 16-byte fmt chunk, then ``chunks``."""
    align = channels * bits // 8
    fmt = chunk(b"fmt ", struct.pack("<HHIIHH", tag, channels, RATE, RATE * align, align, bits))
    body = b"WAVE" + fmt + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


# (tag, channels, bits, dtype) of the formats that are mapped.
MAPPED = {"int16_stereo": (1, 2, 16, "<i2"), "float32_stereo": (3, 2, 32, "<f4"), "float32_mono": (3, 1, 32, "<f4")}


def edge_case(case: str, tag: int, channels: int, bits: int, frames: np.ndarray, other: np.ndarray) -> bytes:
    data = frames.tobytes()
    if case == "data_past_eof":
        return riff(tag, channels, bits, b"data" + struct.pack("<I", len(data) + 4096) + data)
    if case == "partial_frame":
        return riff(tag, channels, bits, chunk(b"data", data + other.tobytes()[:channels * bits // 8 - 1]))
    if case == "odd_chunk_before_data":
        return riff(tag, channels, bits, chunk(b"LIST", b"abc"), chunk(b"data", data))
    assert case == "two_data_chunks"  # the last wins
    return riff(tag, channels, bits, chunk(b"data", other.tobytes()), chunk(b"data", data), chunk(b"id3 ", b"x"))


@pytest.mark.parametrize("case", ["data_past_eof", "partial_frame", "odd_chunk_before_data", "two_data_chunks"])
@pytest.mark.parametrize("kind", list(MAPPED))
def test_mapped_chunk_semantics_are_load_wavs(tmp_path, kind, case):
    tag, channels, bits, dtype = MAPPED[kind]
    rng = np.random.default_rng(len(case) * 7 + channels)
    frames, other = (rng.integers(-32768, 32768, (3001, channels)).astype(np.float32) for _ in range(2))
    if dtype == "<i2":
        frames, other = frames.astype(dtype), other.astype(dtype)
    else:
        frames, other = (frames * np.float32(2.0**-15)).astype(dtype), (other * np.float32(2.0**-15)).astype(dtype)
    path = tmp_path / f"{kind}_{case}.wav"
    path.write_bytes(edge_case(case, tag, channels, bits, frames, other[:1000]))
    got, rate = wav.load_device_ready(path)
    assert isinstance(got, np.memmap) and rate.get_hz() == RATE
    want, spec = wav.load_wav(path)
    assert np.array_equal(got, frames[:, 0]) and np.array_equal(got.astype(np.float32), want)
    assert (spec.channels, spec.bits_per_sample, spec.sample_rate) == (channels, bits, RATE)
    jgot, jrate = jwav.load_device_ready(path)
    assert jgot.dtype == got.dtype and np.array_equal(jgot, got) and jrate.get_hz() == RATE


def other_format(fmt: str, frames: np.ndarray) -> bytes:
    """``frames`` (floats in [-1, 1), two channels) as 8-, 24- or 32-bit
    PCM or as 64-bit float."""
    if fmt == "float64":
        return riff(3, 2, 64, chunk(b"data", frames.astype("<f8").tobytes()))
    bits = {"int8": 8, "int24": 24, "int32": 32}[fmt]
    v = np.round(frames.astype(np.float64) * (2.0 ** (bits - 1) - 1)).astype(np.int64)
    if bits == 8:
        data = (v + 128).astype(np.uint8).tobytes()
    elif bits == 24:
        data = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    else:
        data = v.astype("<i4").tobytes()
    return riff(1, 2, bits, chunk(b"data", data))


@pytest.mark.parametrize("fmt", ["int8", "int24", "int32", "float64"])
def test_formats_numpy_cannot_view_are_read_by_load_wav(tmp_path, fmt, monkeypatch):
    frames = np.random.default_rng(9).uniform(-1, 1, (3001, 2))
    path = tmp_path / f"{fmt}.wav"
    path.write_bytes(other_format(fmt, frames))
    monkeypatch.setattr(Counted, "names", [])
    monkeypatch.setattr(wav, "span", Counted)
    got, rate = wav.load_device_ready(path)
    assert not isinstance(got, np.memmap) and rate.get_hz() == RATE
    assert Counted.names == ["apt.wav.read", "apt.wav.convert"]
    want, _ = wav.load_wav(path)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    jgot, _ = jwav.load_device_ready(path)
    assert jgot.dtype == got.dtype and np.array_equal(jgot, got)


@pytest.mark.parametrize("use_mmap", [True, False])
@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_a_fault_in_decode_pcm_reaches_channel_0(runs, layout, use_mmap, monkeypatch):
    """Both loaders, with and without the map, decode through
    ``_decode_pcm``: where it drops the first sample, channel 0 takes
    channel 1's samples (stereo) or starts one sample late (mono)."""
    orig = wav._decode_pcm
    monkeypatch.setattr(wav, "_decode_pcm", lambda data, fmt, bits: (lambda f, a: (f, a[1:]))(*orig(data, fmt, bits)))
    got, _ = wav.load_device_ready(runs[layout]["path"], use_mmap=use_mmap)
    assert isinstance(got, np.memmap) is use_mmap
    scale = 1.0 if got.dtype == np.int16 else 2.0**-15
    want = runs["ch0"][1:] if SPECS[layout][0] == 1 else runs["ch1"][: len(got)]
    assert np.array_equal(got.astype(np.float64), want * scale)
    assert np.array_equal(wav.load_wav(runs[layout]["path"])[0], got.astype(np.float32))


def not_riff(frames: bytes) -> bytes:
    return b"RIFX" + riff(1, 1, 16, chunk(b"data", frames))[4:]


def no_data_chunk(frames: bytes) -> bytes:
    return riff(1, 1, 16, chunk(b"LIST", frames))


def short_fmt(frames: bytes) -> bytes:
    body = b"WAVE" + chunk(b"fmt ", struct.pack("<HHI", 1, 1, RATE)) + chunk(b"data", frames)
    return b"RIFF" + struct.pack("<I", len(body)) + body


LOADERS = {"load_wav": wav.load_wav, "mapped": wav.load_device_ready,
           "unmapped": lambda p: wav.load_device_ready(p, use_mmap=False)}


@pytest.mark.parametrize("loader", list(LOADERS))
@pytest.mark.parametrize("make", [not_riff, no_data_chunk, short_fmt], ids=lambda f: f.__name__)
def test_open_errors_are_the_jax_packages(tmp_path, make, loader):
    path = tmp_path / f"{make.__name__}.wav"
    path.write_bytes(make(np.arange(-500, 500, dtype="<i2").tobytes()))
    with pytest.raises(jerr.WavOpenError) as want:
        jwav.load_wav(path)
    with pytest.raises(err.WavOpenError) as got:
        LOADERS[loader](path)
    assert str(got.value) == str(want.value) and str(path) in str(got.value)


# --- every path that takes the mapped samples --------------------------------

# The CLI's paths past the device ingest: the host ingests (fast_resample_native
# on float32, ingest_i16_native on int16), the sharded decoder's upload
# (parallel/shard.py) and the step export (graph/debug.py).
CONSUMERS = {"host16": ("--ingest", "host16"), "host": ("--ingest", "host"), "distributed": ("--distributed", "2"),
             "wav_steps": ("--wav-steps",)}


@pytest.fixture(scope="module")
def consumer_pngs(runs, tmp_path_factory):
    """Each consumer's CLI PNG of each layout and of the twin."""
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp_path_factory.mktemp("steps"))  # --wav-steps writes its step WAVs here
    try:
        yield {(c, name): decode(runs[name]["path"], *flags)["png"]
               for c, flags in CONSUMERS.items() for name in (*LAYOUTS, "twin")}
    finally:
        mp.undo()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("consumer", list(CONSUMERS))
def test_each_consumer_of_the_map_gives_the_twins_png(consumer_pngs, consumer, layout):
    assert consumer_pngs[consumer, layout] == consumer_pngs[consumer, "twin"]


@pytest.mark.parametrize("ingest", ["device", "host16"])
def test_fleet_gives_the_twins_pngs(runs, tmp_path, ingest):
    """``serve.decode_fleet``'s loaders: the device ingest copies each
    mapped view into its upload buffer (``_LoaderUpload``), host16 ingests
    it on the host."""
    names = (*LAYOUTS, "twin")
    report = serve.decode_fleet([runs[n]["path"] for n in names], tmp_path, ingest=ingest, device="cpu")
    assert [r.error for r in report.results] == [None] * len(names)
    twin = (tmp_path / "twin.png").read_bytes()
    assert all((tmp_path / f"{n}.png").read_bytes() == twin for n in LAYOUTS)
