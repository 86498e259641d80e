"""The stereo 32-bit float cell, ``sdr48k_f32.single_wavfmt``: the plain
WAV reader on hand-built headers, and whole runs on the CPU, sound and
with a fault: ``correct`` has to come out false, or the run refused,
for each.

The decode is scale-free (the 98 % levels stretch whatever scale the
samples have), so a float file scaled by any other factor than 2**-15
would decode to the same image within rounding: the entry's read-back
check, not the judge, refuses it.  A read of the wrong channel changes
nothing where both channels hold the same AF, as the configuration
assumes; with another AF on channel 1 the judge has to see it."""

import struct

import numpy as np
import pytest

from aptbench import harness, spec
from aptbench.reference import wavread

ROOT = spec.HERE.parent
SEED = 2**33 + 5
CELL = "sdr48k_f32.single_wavfmt"


def riff(*chunks) -> bytes:
    body = b"WAVE" + b"".join(cid + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1) for cid, b in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def fmt(tag, channels, bits, rate=48000, ext_tag=None):
    align = channels * bits // 8
    body = struct.pack("<HHIIHH", tag, channels, rate, rate * align, align, bits)
    if ext_tag is None:
        return body + struct.pack("<H", 0)
    return body + struct.pack("<HHI", 22, bits, 3) + struct.pack("<H", ext_tag) + wavread.GUID_TAIL


FRAMES = np.arange(-6, 6, dtype=np.int16)
STEREO_I16 = np.stack([FRAMES, FRAMES * 7], axis=1)
STEREO_F32 = (STEREO_I16 / 32768.0).astype("<f4")


@pytest.mark.parametrize("case", ["pcm16_mono", "pcm16_stereo", "float_tag3_fact", "float_extensible",
                                  "pcm16_extensible", "float_three_channels", "odd_chunk_first",
                                  "truncated_data", "last_data_wins"])
def test_wavread_on_hand_built_headers(tmp_path, case):
    path = tmp_path / "x.wav"
    want, tag, ch = FRAMES, 1, 1
    if case == "pcm16_mono":
        raw = riff((b"fmt ", fmt(1, 1, 16)), (b"data", FRAMES.tobytes()))
    elif case == "pcm16_stereo":
        raw, ch = riff((b"fmt ", fmt(1, 2, 16)), (b"data", STEREO_I16.tobytes())), 2
    elif case == "float_tag3_fact":
        raw = riff((b"fmt ", fmt(3, 2, 32)), (b"fact", struct.pack("<I", 12)), (b"data", STEREO_F32.tobytes()))
        want, tag, ch = STEREO_F32[:, 0], 3, 2
    elif case == "float_extensible":
        raw = riff((b"fmt ", fmt(0xFFFE, 2, 32, ext_tag=3)), (b"fact", struct.pack("<I", 12)),
                   (b"data", STEREO_F32.tobytes()))
        want, tag, ch = STEREO_F32[:, 0], 3, 2
    elif case == "pcm16_extensible":
        raw, ch = riff((b"fmt ", fmt(0xFFFE, 2, 16, ext_tag=1)), (b"data", STEREO_I16.tobytes())), 2
    elif case == "float_three_channels":
        three = np.stack([STEREO_F32[:, 0], STEREO_F32[:, 1], -STEREO_F32[:, 0]], axis=1)
        raw = riff((b"fmt ", fmt(3, 3, 32)), (b"data", three.tobytes()))
        want, tag, ch = STEREO_F32[:, 0], 3, 3
    elif case == "odd_chunk_first":
        raw = riff((b"LIST", b"abc"), (b"fmt ", fmt(1, 1, 16)), (b"data", FRAMES.tobytes()))
    elif case == "truncated_data":
        full = riff((b"fmt ", fmt(1, 2, 16)), (b"data", STEREO_I16.tobytes()))
        raw, ch, want = full[:-6], 2, FRAMES[:-2]  # a frame and a half short: one whole frame lost
    else:
        raw = riff((b"fmt ", fmt(1, 1, 16)), (b"data", (FRAMES + 1).tobytes()), (b"data", FRAMES.tobytes()))
    path.write_bytes(raw)
    got, info = wavread.read(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (info.tag, info.channels, info.rate, info.frames) == (tag, ch, 48000, len(want))


@pytest.mark.parametrize("raw", [
    riff((b"fmt ", fmt(1, 1, 24)), (b"data", b"\0" * 6)),
    riff((b"fmt ", fmt(3, 1, 64)), (b"data", b"\0" * 8)),
    riff((b"fmt ", fmt(0xFFFE, 1, 32, ext_tag=3)[:-1] + b"\x72"), (b"data", b"\0" * 8)),  # a foreign GUID
    riff((b"data", b"\0" * 4)),
    b"RIFX" + b"\0" * 40,
], ids=["pcm24", "float64", "foreign_guid", "no_fmt", "not_riff"])
def test_wavread_refuses_what_it_does_not_read(tmp_path, raw):
    (tmp_path / "x.wav").write_bytes(raw)
    with pytest.raises(ValueError):
        wavread.read(tmp_path / "x.wav")


def run() -> dict:
    return harness.run_cell(ROOT, CELL, SEED, 1.0, False, device="cpu", min_calls=2)


def traced_run() -> dict:
    return harness.run_cell(ROOT, CELL, SEED, 1.0, True, device="cpu", min_calls=2)


def entry_module(monkeypatch):
    """The cell's entry module, loaded once and handed to the harness, so
    that a test can alter it."""
    mod = spec.Spec.entry("single_wavfmt")
    monkeypatch.setattr(spec.Spec, "entry", staticmethod(lambda name: mod))
    return mod


def test_sound_run_is_correct(tiny_traffic, cli_home, monkeypatch):
    mod = entry_module(monkeypatch)
    seen = []
    orig_close = mod.Entry.close

    def close(self):
        seen.extend((f, f.exists(), f.stat().st_size if f.exists() else None) for f in self.files)
        orig_close(self)
        assert not any(f.exists() for f in self.files)

    monkeypatch.setattr(mod.Entry, "close", close)
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert r["checks"]["px_gap"]["value"] <= 1 and r["checks"]["rows_off_pct"]["value"] == 0.0
    assert set(r["metrics"]) == {m["name"] for m in spec.Spec(ROOT).metrics_for(CELL, "end_to_end")}
    assert len(seen) == 2 and all(exists for _, exists, _ in seen)
    for f, _, size in seen:  # stereo float: 8 bytes a frame and a 58-byte header
        assert f.name.startswith("SDRSharp_") and f.name.endswith("Z_137100000Hz_AF.wav") and (size - 58) % 8 == 0


def test_traced_run_reads_the_float_path(tiny_traffic, cli_home):
    """On the CPU the trace holds no card events (no roofline), but the
    program's spans and counters are there."""
    r = traced_run()
    assert r["correct"]
    m = r["metrics"]
    assert m["wav_read_ms.single_wavfmt"]["value"] > 0 and m["wav_convert_ms.single_wavfmt"]["value"] > 0
    assert m["wav_bytes_per_sample.single_wavfmt"]["value"] == pytest.approx(8.0, abs=1e-4)
    assert m["upload_cast_ms.single_wavfmt"]["value"] > 0
    assert "polyphase_resample_f32_roofline.single_wavfmt" not in m


def test_float_file_scaled_off_a_power_of_two_is_refused(tiny_traffic, cli_home, monkeypatch):
    """The read-back runs after the window, outside ``setup_s``, and
    before the check: the run raises rather than report."""
    mod = entry_module(monkeypatch)
    monkeypatch.setattr(mod, "SCALE", np.float32(1.1 / 32768))
    calls = []
    orig_call = mod.Entry.call
    monkeypatch.setattr(mod.Entry, "call", lambda self, i, record=False: calls.append(i) or orig_call(self, i, record))
    with pytest.raises(RuntimeError, match="not the 16-bit twin's samples / 32768"):
        run()
    assert len(calls) >= 2


def test_cli_pointed_at_channel_1_is_not_correct(tiny_traffic, cli_home, monkeypatch):
    """Channel 1 carries another AF (the pass played backwards) and the
    program's loader takes channel 1: the judge has to see it.  The same
    files with the loader on channel 0 come out correct."""
    from noaa_apt_tpu_torch.io import wav

    mod = entry_module(monkeypatch)
    write = mod.write_wav
    monkeypatch.setattr(mod, "write_wav", lambda path, chans, rate: write(path, [chans[0], chans[0][::-1]], rate))
    assert run()["correct"]
    orig = wav._decode_pcm
    monkeypatch.setattr(wav, "_decode_pcm", lambda data, fmt, bits: (lambda f, a: (f, a[1:]))(*orig(data, fmt, bits)))
    r = run()
    assert not r["correct"]
    assert [k for k, c in r["checks"].items() if c["value"] > c["limit"]], r["checks"]


def test_metrics_read_nothing_without_the_programs_counters():
    """A program with no ``apt.wav.*`` span and no ``wav_bytes`` counter
    (the commit before them) reads None, and raises nothing."""
    from aptbench import trace

    ms = 1_000_000
    host = [("pass", 0, 10 * ms), ("apt.load", 1 * ms, 3 * ms), ("apt.png.deflate", 4 * ms, 9 * ms)]
    ctx = harness.Context([{"ok": True, "n_samples": 100, "wav_bytes": None}], 0.01, 0.0,
                          trace=trace.Trace(0, 10 * ms, host=host))
    for name in ("wav_read_ms.single_wavfmt", "wav_convert_ms.single_wavfmt", "wav_bytes_per_sample.single_wavfmt",
                 "polyphase_resample_f32_roofline.single_wavfmt", "upload_cast_ms.single_wavfmt"):
        assert spec.Spec.reader(name).read(ctx) is None
    host.append(("apt.wav.read", 1 * ms, 2 * ms))
    assert spec.Spec.reader("wav_read_ms.single_wavfmt").read(ctx) == pytest.approx(1.0)
    host.append(("apt.upload.cast", 3 * ms, 3 * ms + 500_000))
    assert spec.Spec.reader("upload_cast_ms.single_wavfmt").read(ctx) == pytest.approx(0.5)


def test_roofline_counts_only_float_instantiations():
    from aptbench import trace

    count = spec.rooflines()["polyphase_resample_f32"]
    dev = [("void (anonymous namespace)::block_kernel<float, 4, 2>(float const*, long long)", 0, 3000),
           ("void (anonymous namespace)::block_kernel<short, 4, 2>(short const*, long long)", 0, 5000),
           ("(anonymous namespace)::demod_fir_corr_kernel(float const*)", 0, 7000)]
    assert trace.Trace(0, 10_000, device=dev).kernel_seconds(count.NAMES) == pytest.approx(3e-6)
    g = {"n_in": 100, "n_work": 26, "taps_per_output": 74, "in_bytes": 2}
    assert count.count(g) == (2.0 * 74 * 26, 4.0 * 100 + 4.0 * 26)
