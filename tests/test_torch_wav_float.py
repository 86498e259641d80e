"""Stereo and 32-bit float WAVs through the port's CLI on the CPU: the
recorder layouts a station's SDR program writes (SDR#'s 32-bit IEEE
float, stereo), against the mono 16-bit twin of the same pass.

Channel 0 holds the pass (float: the twin's samples / 32768, exact),
channel 1 another pass, so that a read of the wrong channel changes the
image.  The decode is scale-free to the bit (every step is linear or
homogeneous in the samples, and the 98 % levels stretch the result), so
each layout's PNG is the twin's byte for byte.  The load of a file off
the memmap path records ``apt.wav.read`` and ``apt.wav.convert`` once
each, and the decoder's float32 copy of a float file's samples
``apt.upload.cast`` once; the twin's memmapped load records none of
them.  The CLI's report
carries the file's size, channels, bits and sample format.  Each file
loads as the JAX package loads it: the same samples, dtype, rate and
spec, with and without the memmap.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from aptbench.gen import synth
from aptbench.gen.pool import write_wav
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu_torch import cli, spans
from noaa_apt_tpu_torch.graph import decode as graph_decode
from noaa_apt_tpu_torch.io import wav

RATE = 48000
SECONDS = 20.0
ARGS = ["-q", "--device", "cpu", "-p", "standard", "-c", "98_percent"]
KSDATAFORMAT_TAIL = bytes.fromhex("000000001000800000aa00389b71")
LAYOUTS = ("float_tag3_fact", "float_extensible", "int16_stereo")
# (channels, bits, format) the report should carry for each layout.
SPECS = {"float_tag3_fact": (2, 32, "float"), "float_extensible": (2, 32, "float"), "int16_stereo": (2, 16, "int"),
         "twin": (1, 16, "int")}


def write_layout(path: Path, layout: str, ch0: np.ndarray, ch1: np.ndarray) -> None:
    """``ch0`` and ``ch1`` (int16 counts) interleaved in ``layout``."""
    if layout == "int16_stereo":
        data, tag, bits, ext = np.stack([ch0, ch1], axis=1).astype("<i2"), 1, 16, False
    else:
        scale = np.float32(2.0**-15)
        data = np.stack([ch0.astype(np.float32) * scale, ch1.astype(np.float32) * scale], axis=1).astype("<f4")
        tag, bits, ext = 3, 32, layout == "float_extensible"
    align = 2 * bits // 8
    head = struct.pack("<HHIIHH", 0xFFFE if ext else tag, 2, RATE, RATE * align, align, bits)
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


def decode(path: Path) -> dict:
    """The CLI on ``path``: its PNG's bytes, its report and the WAV and
    decoder spans it entered."""
    mp = pytest.MonkeyPatch()
    mp.setattr(Counted, "names", [])
    mp.setattr(wav, "span", Counted)
    mp.setattr(graph_decode, "span", Counted)
    try:
        report: dict = {}
        out = path.with_suffix(".png")
        assert cli.main([str(path), "-o", str(out), *ARGS], report=report) == 0
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
        out["ch0"] = ch0
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
    assert wav_spans(runs["twin"]) == [] and wav_spans(runs["other"]) == []


@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_upload_cast_span_once_for_a_float_file(runs, layout):
    """The decoder's float32 copy of the host samples runs for a float
    file only: 16-bit PCM, stereo or memmapped, ships as int16."""
    want = 1 if SPECS[layout][2] == "float" else 0
    assert runs[layout]["spans"].count("apt.upload.cast") == want
    assert runs[layout]["spans"].count("apt.upload.h2d") == 1


@pytest.mark.parametrize("layout", [*LAYOUTS, "twin"])
def test_report_counters_hold_the_files_values(runs, layout):
    rep = runs[layout]["report"]
    assert rep["wav_bytes"] == runs[layout]["size"]
    assert (rep["wav_channels"], rep["wav_bits"], rep["wav_format"]) == SPECS[layout]
    assert rep["load_s"] > 0


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
    """A ``.npy`` input loads no WAV: the counters are there, as None."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    rng = np.random.default_rng(5)
    np.save(tmp_path / "raw.npy", rng.random(2080 * 12, dtype=np.float32))
    report: dict = {}
    assert cli.main([str(tmp_path / "raw.npy"), "-o", str(tmp_path / "raw.png"), *ARGS], report=report) == 0
    assert {k: report[k] for k in ("wav_bytes", "wav_channels", "wav_bits", "wav_format")} == dict.fromkeys(
        ("wav_bytes", "wav_channels", "wav_bits", "wav_format"))


@pytest.mark.parametrize("use_mmap", [True, False])
def test_load_device_ready_counters_match_load_wav(tmp_path, use_mmap):
    """Both paths of ``load_device_ready`` give the same counters for a
    mono 16-bit file: the memmap's header agrees with ``load_wav``."""
    x = (np.arange(4000) % 200 - 100).astype(np.float32)
    wav.write_wav(tmp_path / "m.wav", x, wav.WavSpec(1, 11025, 16, "int"))
    got: dict = {}
    wav.load_device_ready(tmp_path / "m.wav", use_mmap=use_mmap, info=got)
    want: dict = {}
    wav.load_wav(tmp_path / "m.wav", info=want)
    assert got == want == {"wav_bytes": 44 + 2 * 4000, "wav_channels": 1, "wav_bits": 16, "wav_format": "int"}
