"""The port's decode slice (``noaa_apt_tpu_torch``) against the JAX package.

The three golden combos of ``tests/test_decode_e2e.py`` (24 rows, one
per CPU resample regime) go through both packages' raw-input fused
render on the CPU, and so do the telemetry render (230 rows: a telemetry
frame needs 200) and the l == 1 rates (24960 and 12480 Hz standard,
41600 Hz slow).  Integer decisions (sync positions, hence rows) must
be identical; the u8 image may differ from the JAX package's by +-1 on
at most 0.1% of pixels (a ``floor(v+0.5)`` knife edge under the few-ulp
float differences between the two backends).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu import cli as jcli  # noqa: F401  (the JAX CLI's decode branch is mirrored below)
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.err import InternalError as JInternalError
from noaa_apt_tpu.graph import decode as jdecode
from noaa_apt_tpu.graph.process import finish_image as j_finish_image
from noaa_apt_tpu.io import wav as jwav
from noaa_apt_tpu.synth import synth_recording
from noaa_apt_tpu.types import Contrast as JContrast
from noaa_apt_tpu.types import ContrastKind as JContrastKind
from noaa_apt_tpu.types import Rotate as JRotate

from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.err import InternalError
from noaa_apt_tpu_torch.graph import decode as pdecode
from noaa_apt_tpu_torch.graph.decode import Decoder, DecodeTables
from noaa_apt_tpu_torch.io import wav

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    """The CLI reads (and first writes) the user's settings file."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)


ROOT = Path(__file__).resolve().parent.parent
GOLDEN_DIR = ROOT / "tests" / "golden"
GOLDEN_COMBOS = {
    "decode_11025_standard": ("standard", 11025),
    "decode_48000_fast": ("fast", 48000),
    "decode_48000_slow": ("slow", 48000),
}


def _u8_close(got: np.ndarray, want: np.ndarray, label: str) -> int:
    """+-1 on at most 0.1% of pixels; returns the count that differ."""
    assert got.shape == want.shape, label
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    n_diff = int((d > 0).sum())
    print(f"{label}: {n_diff} of {d.size} u8 pixels differ (max {int(d.max(initial=0))})")
    assert d.max(initial=0) <= 1
    assert n_diff <= 1e-3 * d.size
    return n_diff


@pytest.mark.parametrize("name", sorted(GOLDEN_COMBOS))
def test_golden_combo_matches_jax(name):
    profile_name, rate = GOLDEN_COMBOS[name]
    signal, _ = synth_recording(n_rows=24, sample_rate=rate)
    gray, sync_pos = Decoder(PROFILES[profile_name], device="cpu").decode_render_input(
        signal, len(signal), Rate(rate))
    golden_sync = [int(x) for x in (GOLDEN_DIR / f"{name}.sync.txt").read_text().split()]
    assert sync_pos == golden_sync
    # The golden PNG is the JAX package's decode + render_u8, byte-pinned
    # by tests/test_decode_e2e.py; its fused render equals it there.
    _u8_close(gray, np.asarray(Image.open(GOLDEN_DIR / f"{name}.png")), f"{name} vs golden")
    jgray, jsync = jdecode.Decoder(JPROFILES[profile_name]).decode_render_input(
        signal, len(signal), JRate(rate))
    assert sync_pos == jsync
    _u8_close(gray, jgray, f"{name} vs JAX decode_render_input")


@pytest.mark.parametrize("rate,noise_db,seed", [(11025, None, 0), (48000, 14.0, 2), (11011, 10.0, 7)])
def test_synth_equals_jax_synth(rate, noise_db, seed):
    """The port's synthesizer (which ``chip_smoke.py`` uses to make its
    passes) gives the JAX package's signal and pattern bit for bit."""
    from noaa_apt_tpu_torch import synth

    got = synth.synth_recording(n_rows=130, sample_rate=rate, noise_db=noise_db, seed=seed)
    want = synth_recording(n_rows=130, sample_rate=rate, noise_db=noise_db, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("kind", ["percent", "minmax"])
def test_decode_then_render_equals_fused(kind):
    """``decode`` + ``render_u8`` equals ``decode_render_input`` (the
    same rows, levels and u8 map), with i16 input like a WAV."""
    signal, _ = synth_recording(n_rows=16, sample_rate=48000, noise_db=14.0, seed=2)
    s16 = np.round(signal / np.abs(signal).max() * 32767).astype(np.int16)
    dec = Decoder(PROFILES["standard"], device="cpu")
    res = dec.decode(s16, Rate(48000))
    want = dec.render_u8(res, kind)
    gray, sync_pos = dec.decode_render_input(s16, len(s16), Rate(48000), kind)
    assert sync_pos == res.sync_positions
    np.testing.assert_array_equal(gray, want)
    assert res.image_np()[0, 0] == 0.0  # NoFilter causal-path quirk
    lo, hi = (float(v) for v in pdecode._levels(res.image, kind, 0.98))
    np.testing.assert_array_equal(dec.render_u8_levels(res, lo, hi), want)


def _write_wav_bytes(path: Path, signal: np.ndarray, rate: int, fmt: str) -> None:
    """Mono ``signal`` (floats in [-1, 1]) as a WAV of ``fmt``: "int8"
    (unsigned, offset 128), "int24", "int32" (PCM) or "float32" (IEEE
    float), written byte by byte."""
    import struct

    if fmt == "float32":
        data, tag, bits = signal.astype("<f4").tobytes(), 3, 32
    else:
        bits = {"int8": 8, "int24": 24, "int32": 32}[fmt]
        v = np.round(signal.astype(np.float64) * (2.0 ** (bits - 1) - 1)).astype(np.int64)
        if bits == 8:
            data = (v + 128).astype(np.uint8).tobytes()
        elif bits == 24:
            data = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
        else:
            data = v.astype("<i4").tobytes()
        tag = 1
    fmt_chunk = struct.pack("<HHIIHH", tag, 1, rate, rate * bits // 8, bits // 8, bits)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + len(data)) + b"WAVE"
                     + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
                     + b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("fmt", ["int8", "int24", "int32", "float32"])
@pytest.mark.parametrize("rate", [11025, 48000])
def test_non_16_bit_wav_decodes_like_jax(tmp_path, fmt, rate):
    """A short seeded pass written as an 8-, 24- or 32-bit integer or a
    32-bit float WAV reaches the decoder as float32 (the path that runs
    K1 on float32 input on the card) and decodes as the JAX package
    decodes the same file: the same sync positions, u8 within +-1 on
    0.1% of pixels."""
    signal, _ = synth_recording(n_rows=16, sample_rate=rate, noise_db=14.0, seed=3)
    path = tmp_path / f"pass_{fmt}.wav"
    _write_wav_bytes(path, signal / np.abs(signal).max(), rate, fmt)
    x, r = wav.load_device_ready(path)
    assert x.dtype == np.float32 and r.hz == rate
    gray, sync_pos = Decoder(PROFILES["standard"], device="cpu").decode_render_input(x, len(x), r)
    jx, jr = jwav.load_device_ready(path)
    jgray, jsync = jdecode.Decoder(JPROFILES["standard"]).decode_render_input(jx, len(jx), jr)
    assert len(sync_pos) > 0 and sync_pos == jsync
    _u8_close(gray, jgray, f"{fmt} WAV at {rate} Hz vs JAX")


def test_percent_levels_match_host_scan():
    """The device bucket search equals the reference's sequential scan
    (``post/contrast.percent``) on the decoded image, and the device u8
    map equals the host ``map_signal_u8`` at those levels."""
    from noaa_apt_tpu_torch.post import contrast

    signal, _ = synth_recording(n_rows=14, sample_rate=11025, noise_db=10.0, seed=4)
    dec = Decoder(PROFILES["standard"], device="cpu")
    res = dec.decode(signal, Rate(11025))
    lo, hi = pdecode._levels(res.image, "percent", 0.98)
    assert (float(lo), float(hi)) == contrast.percent(res.signal(), 0.98)
    np.testing.assert_array_equal(dec.render_u8(res, "percent"),
                                  contrast.map_signal_u8(res.image_np(), float(lo), float(hi)))


def test_no_sync_path():
    signal, _ = synth_recording(n_rows=16, sample_rate=11025)
    res = Decoder(PROFILES["standard"], device="cpu").decode(signal, Rate(11025), sync=False)
    jres = jdecode.Decoder(JPROFILES["standard"]).decode(signal, JRate(11025), sync=False)
    assert res.sync_positions is None and res.n_rows == jres.n_rows
    assert res.image_np()[0, 0] == 0.0


@pytest.mark.parametrize("profile_name,rate", [("standard", 11025), ("slow", 11025), ("standard", 48000)])
def test_no_sync_image_matches_jax(profile_name, rate):
    """The no-sync image (rows cut at multiples of the row length) against
    the JAX package's on the same seeded signal: the floats within
    1e-5 of the image's scale, the percent u8 renders within +-1 on 0.1%."""
    signal, _ = synth_recording(n_rows=16, sample_rate=rate, seed=0)
    dec = Decoder(PROFILES[profile_name], device="cpu")
    jdec = jdecode.Decoder(JPROFILES[profile_name])
    res = dec.decode(signal, Rate(rate), sync=False)
    jres = jdec.decode(signal, JRate(rate), sync=False)
    got, want = res.image_np(), jres.image_np()
    assert got.shape == want.shape and res.n_rows == jres.n_rows > 0
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got - want).max()) <= 1e-5 * scale
    _u8_close(dec.render_u8(res, "percent"), jdec.render_u8(jres, "percent"),
              f"no-sync {rate}/{profile_name} vs JAX")


def test_tables_override_from_jax_arrays():
    """``Decoder(tables=...)`` runs on the JAX package's own arrays and
    decodes identically to the port's designed tables; a table for
    another rate is refused."""
    jdec = jdecode.Decoder(JPROFILES["standard"])
    from noaa_apt_tpu.ops import demod as jdm
    from noaa_apt_tpu.ops import resample as jrs

    l, m = 13, 50
    coeff = jdec._ingest_filter(JRate(48000)).resample(JRate(48000), JRate(48000 * l)).design()
    p_c, s_c, bank, _, offset = jrs._phase_tables(jrs.resample_plan(1, l, m, coeff))
    carrier, taps, template = jdec._chain_params()
    cosphi2, sinphi = jdm.demod_constants(carrier)
    tables = DecodeTables.from_numpy(
        input_rate=48000, work_rate=12480, l=l, m=m, offset=offset, p_c=p_c, s_c=s_c,
        bank=bank, taps=taps, template=template, cosphi2=cosphi2, sinphi=sinphi)
    signal, _ = synth_recording(n_rows=12, sample_rate=48000, seed=1)
    got = Decoder(PROFILES["standard"], device="cpu", tables=tables).decode_render_input(
        signal, len(signal), Rate(48000))
    want = Decoder(PROFILES["standard"], device="cpu").decode_render_input(
        signal, len(signal), Rate(48000))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(InternalError, match="tables are for"):
        Decoder(PROFILES["standard"], device="cpu", tables=tables).decode(signal, Rate(11025))


def test_guards_raise_the_same_messages():
    """The 10-row guard and the 5-sync guard raise the JAX package's
    messages."""
    short, _ = synth_recording(n_rows=4, sample_rate=11025)
    with pytest.raises(JInternalError) as jexc:
        jdecode.Decoder(JPROFILES["standard"]).decode(short, JRate(11025))
    dec = Decoder(PROFILES["standard"], device="cpu")
    for call in (lambda: dec.decode(short, Rate(11025)),
                 lambda: dec.decode_render_input(short, len(short), Rate(11025))):
        with pytest.raises(InternalError) as exc:
            call()
        assert str(exc.value) == str(jexc.value)
    assert str(pdecode._check_sync_count([0, 1, 2, 3])) == str(jdecode._check_sync_count([0, 1, 2, 3]))
    assert pdecode._check_sync_count([0, 1, 2, 3, 4]) is None
    # 24960 Hz (l == 1) decodes, to the JAX package's rows.
    sig, _ = synth_recording(n_rows=12, sample_rate=24960, seed=3)
    res = dec.decode(sig, Rate(24960))
    jres = jdecode.Decoder(JPROFILES["standard"]).decode(sig, JRate(24960))
    assert res.sync_positions == jres.sync_positions and res.n_rows == jres.n_rows == 10
    # A telemetry render of fewer than 200 rows raises the JAX message.
    for d, r in ((dec, Rate), (jdecode.Decoder(JPROFILES["standard"]), JRate)):
        with pytest.raises(Exception, match="Recording too short for telemetry decoding"):
            d.decode_render_input(sig, len(sig), r(24960), "telemetry")


def test_cli_matches_jax_cli_decode(tmp_path):
    """``python -m noaa_apt_tpu_torch in.wav -o out.png --device cpu``
    writes a 2080-wide RGBA PNG whose pixels match the JAX CLI's decode
    branch (cli.py:451-519) under the +-1 / 0.1% criterion."""
    signal, _ = synth_recording(n_rows=24, sample_rate=11025, noise_db=20.0, seed=9)
    wav_path, png_path = tmp_path / "pass.wav", tmp_path / "out.png"
    wav.write_wav(wav_path, signal, wav.WavSpec(1, 11025, 16, "int"))
    proc = subprocess.run(
        [sys.executable, "-m", "noaa_apt_tpu_torch", str(wav_path), "-o", str(png_path),
         "--device", "cpu", "-q"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr
    got = np.asarray(Image.open(png_path))
    assert got.shape[1:] == (2080, 4)

    jsig, jrate = jwav.load_device_ready(wav_path)
    jgray, _ = jdecode.Decoder(JPROFILES["standard"]).decode_render_input(
        jsig, len(jsig), jrate, "percent", 0.98)
    want = j_finish_image(jgray, JContrastKind.PERCENT, JRotate.NO)
    _u8_close(got, want, "CLI vs JAX CLI decode branch")


def test_cli_rotate_and_minmax(tmp_path):
    from noaa_apt_tpu_torch import cli
    from noaa_apt_tpu_torch.post import processing

    signal, _ = synth_recording(n_rows=12, sample_rate=11025, seed=5)
    wav_path = tmp_path / "pass.wav"
    wav.write_wav(wav_path, signal, wav.WavSpec(1, 11025, 16, "int"))
    report: dict = {}
    assert cli.main([str(wav_path), "-o", str(tmp_path / "a.png"), "--device", "cpu", "-q",
                     "-c", "minmax"], report=report) == 0
    assert cli.main([str(wav_path), "-o", str(tmp_path / "b.png"), "--device", "cpu", "-q",
                     "-c", "minmax", "-R", "yes"]) == 0
    a = np.array(Image.open(tmp_path / "a.png"))
    processing.rotate(a)
    np.testing.assert_array_equal(a, np.asarray(Image.open(tmp_path / "b.png")))
    assert report["rows"] == a.shape[0] and set(report["stage_ms"]) >= {"resample", "select"}
    assert cli.main([str(tmp_path / "missing.wav"), "--device", "cpu", "-q"]) == 1


@pytest.fixture(scope="module")
def telemetry_wav(tmp_path_factory):
    """A 230-row 11025 Hz pass: long enough for a telemetry frame."""
    signal, _ = synth_recording(n_rows=230, sample_rate=11025, seed=5)
    path = tmp_path_factory.mktemp("tel") / "pass.wav"
    wav.write_wav(path, signal, wav.WavSpec(1, 11025, 16, "int"))
    return path


# The reference's tables of -c and -R (noaa_apt_tpu/cli.py:201-220).
REF_CONTRASTS = {"98_percent": JContrast.from_percent(0.98), "telemetry": JContrast.telemetry(),
                 "disable": JContrast.minmax(), "histogram": JContrast.histogram()}
REF_ROTATES = {"auto": JRotate.ORBIT, "yes": JRotate.YES, "no": JRotate.NO}


@pytest.mark.parametrize("option,name", [("-c", n) for n in (*REF_CONTRASTS, "percent", "minmax")]
                         + [("-R", n) for n in REF_ROTATES])
def test_cli_takes_reference_spellings(tmp_path, caplog, telemetry_wav, option, name):
    """Each spelling of the reference's ``-c`` and ``-R`` maps to the
    reference's value (``percent`` and ``minmax`` are the port's aliases of
    ``98_percent`` and ``disable``), and every one decodes; ``-R auto``
    (orbit-based: the file's mtime and NOAA 19, here with a ``-T`` TLE so
    that nothing is downloaded) rotates the image as the pass direction
    asks."""
    from noaa_apt_tpu_torch import cli

    if option == "-c":
        got = cli.CONTRASTS[name]
        want = REF_CONTRASTS[{"percent": "98_percent", "minmax": "disable"}.get(name, name)]
        assert (got.kind.value, got.percent) == (want.kind.value, want.percent)
    else:
        assert cli.ROTATES[name].value == REF_ROTATES[name].value
    png_path = tmp_path / "out.png"
    tle = tmp_path / "tle.txt"
    tle.write_text(TEST_TLE)
    extra = ["-T", str(tle)] if name == "auto" else []
    rc = cli.main([str(telemetry_wav), "-o", str(png_path), "--device", "cpu", "-q", option, name,
                   *extra])
    assert rc == 0 and np.asarray(Image.open(png_path)).shape[1] == 2080
    if name == "auto":
        from datetime import datetime, timezone

        from noaa_apt_tpu_torch.geo.orbit import south_to_north_pass
        from noaa_apt_tpu_torch.types import OrbitSettings, RefTime, SatName

        mtime = datetime.fromtimestamp(int(telemetry_wav.stat().st_mtime), tz=timezone.utc)
        turn = south_to_north_pass(OrbitSettings(SatName.NOAA_19, RefTime.end(mtime), TEST_TLE))
        fixed = tmp_path / "fixed.png"
        assert cli.main([str(telemetry_wav), "-o", str(fixed), "--device", "cpu", "-q", "-R",
                         "yes" if turn else "no"]) == 0
        np.testing.assert_array_equal(np.asarray(Image.open(png_path)), np.asarray(Image.open(fixed)))


# The pinned Jan-2020 TLE of the JAX package's tests (geo.rs:206-214).
TEST_TLE = """NOAA 15
1 25338U 98030A   20028.53684332  .00000010  00000-0  22730-4 0  9996
2 25338  98.7308  54.2052 0009655 316.5487  43.4931 14.25949056128892
NOAA 18
1 28654U 05018A   20028.55430359  .00000064  00000-0  59410-4 0  9998
2 28654  99.0657  83.5290 0013366 267.3059  92.6583 14.12484618757024
NOAA 19
1 33591U 09005A   20028.54874297  .00000001  00000-0  25623-4 0  9996
2 33591  99.1936  30.2411 0014855 109.6767 250.6008 14.12393428565240"""


# -- telemetry contrast -------------------------------------------------------
def test_telemetry_stats_match_jax():
    """The port's device band statistics on the JAX package's decoded
    image are within 1e-6 (relative to each array's scale) of
    ``Decoder._telemetry_stats_stage``."""
    signal, _ = synth_recording(n_rows=40, sample_rate=11025, noise_db=15.0, seed=6)
    jres = jdecode.Decoder(JPROFILES["standard"]).decode(signal, JRate(11025))
    img = np.array(jres.image_np()[: jres.n_rows])
    got = pdecode._telemetry_stats(torch.from_numpy(img)).numpy()
    want = [np.asarray(a)[: jres.n_rows] for a in jdecode.Decoder._telemetry_stats_stage(jres.image)]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (jres.n_rows,)
        assert float(np.abs(g - w).max()) <= 1e-6 * float(np.abs(w).max())


def _spy_telemetry(monkeypatch, module) -> list:
    """Record each ``Telemetry.from_bands`` row and the Telemetry made."""
    seen, orig = [], module.Telemetry.from_bands.__func__

    def spy(cls, means_a, means_b, row):
        t = orig(cls, means_a, means_b, row)
        seen.append((row, t))
        return t

    monkeypatch.setattr(module.Telemetry, "from_bands", classmethod(spy))
    return seen


@pytest.mark.parametrize("profile_name,rate", [("standard", 11025), ("fast", 48000)])
def test_telemetry_render_matches_jax(monkeypatch, profile_name, rate):
    """The fused telemetry render against the JAX package's: sync lists,
    the frame row and channel names equal, (low, high) within 1e-4
    relative, u8 under the +-1 / 0.1% rule; and it equals decode +
    telemetry_stats + render_u8_levels."""
    from noaa_apt_tpu.post import telemetry as jtel

    from noaa_apt_tpu_torch.post import telemetry as ptel

    signal, _ = synth_recording(n_rows=230, sample_rate=rate, noise_db=20.0, seed=8)
    seen, jseen = _spy_telemetry(monkeypatch, ptel), _spy_telemetry(monkeypatch, jtel)
    dec = Decoder(PROFILES[profile_name], device="cpu")
    gray, sync_pos = dec.decode_render_input(signal, len(signal), Rate(rate), "telemetry")
    jgray, jsync = jdecode.Decoder(JPROFILES[profile_name]).decode_render_input(
        signal, len(signal), JRate(rate), "telemetry")
    assert sync_pos == jsync and len(seen) == len(jseen) == 1
    (row, t), (jrow, jt) = seen[0], jseen[0]
    assert row == jrow
    for ch in ("a", "b"):
        assert t.get_channel_name(ch) == jt.get_channel_name(ch)
    for wedge in (9, 8):
        got, want = t.get_wedge_value(wedge, None), jt.get_wedge_value(wedge, None)
        assert abs(got - want) <= 1e-4 * abs(want)
    _u8_close(gray, jgray, f"telemetry {rate}/{profile_name} vs JAX")
    assert set(dec.last_stage_ms) >= {"telemetry", "rows_levels_u8"}

    res = dec.decode(signal, Rate(rate))
    low, high = pdecode._telemetry_levels(*dec.telemetry_stats(res))
    assert (low, high) == (t.get_wedge_value(9, None), t.get_wedge_value(8, None))
    np.testing.assert_array_equal(dec.render_u8_levels(res, low, high), gray)


# -- the l == 1 decimation path -----------------------------------------------
L1_CASES = [("standard", 24960, 2), ("standard", 12480, 1), ("slow", 41600, 2)]


@pytest.mark.parametrize("profile_name,rate,m", L1_CASES)
def test_l1_path_matches_jax(profile_name, rate, m):
    """The causal-FIR-and-decimate ingest (l == 1) through K1's twin: sync
    lists equal, the float image within 1e-4 of JAX's scale, u8 under the
    +-1 / 0.1% rule (int16 input, as a WAV gives it)."""
    signal, _ = synth_recording(n_rows=18, sample_rate=rate, noise_db=20.0, seed=rate % 7)
    s16 = np.round(signal / np.abs(signal).max() * 30000).astype(np.int16)
    dec = Decoder(PROFILES[profile_name], device="cpu")
    t = dec.tables(Rate(rate))
    assert (t.l, t.m) == (1, m) and t.work_len(len(s16)) == len(s16) // m
    jdec = jdecode.Decoder(JPROFILES[profile_name])
    res, jres = dec.decode(s16, Rate(rate)), jdec.decode(s16, JRate(rate))
    assert res.sync_positions == jres.sync_positions and res.n_rows == jres.n_rows >= 16
    got, want = res.image_np(), jres.image_np()[: jres.n_rows]
    assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max())
    gray, sync_pos = dec.decode_render_input(s16, len(s16), Rate(rate))
    jgray, jsync = jdec.decode_render_input(s16, len(s16), JRate(rate))
    assert sync_pos == jsync == res.sync_positions
    _u8_close(gray, jgray, f"l == 1 {rate}/{profile_name} vs JAX")
    assert "causal_prefix" in dec.last_stage_ms


@pytest.mark.parametrize("profile_name,rate,m", L1_CASES)
def test_l1_tables_from_jax_coeff(profile_name, rate, m):
    """The port designs the JAX package's l == 1 filter bit for bit
    (``_plan_resample_with_filter``'s ``coeff``, designed at the input
    rate); ``DecodeTables.from_numpy`` takes tables made from it."""
    from noaa_apt_tpu.ops import demod as jdm

    from noaa_apt_tpu_torch.ops import resample as rs

    jdec = jdecode.Decoder(JPROFILES[profile_name])
    _, work_len, coeff = jdecode._plan_resample_with_filter(
        1000, JRate(rate), jdec.work_rate, jdec._ingest_filter(JRate(rate)))
    assert work_len(1001) == 1001 // m
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate))
    np.testing.assert_array_equal(t.bank[0].view(np.uint32), np.asarray(coeff, np.float32)[::-1].view(np.uint32))
    p_c, s_c, bank = rs.causal_tables(coeff)
    carrier, taps, template = jdec._chain_params()
    cosphi2, sinphi = jdm.demod_constants(carrier)
    tables = DecodeTables.from_numpy(
        input_rate=rate, work_rate=jdec.work_rate.get_hz(), l=1, m=m, offset=0, p_c=p_c, s_c=s_c,
        bank=bank, taps=taps, template=template, cosphi2=cosphi2, sinphi=sinphi)
    signal, _ = synth_recording(n_rows=12, sample_rate=rate, seed=2)
    got = Decoder(PROFILES[profile_name], device="cpu", tables=tables).decode_render_input(
        signal, len(signal), Rate(rate))
    want = Decoder(PROFILES[profile_name], device="cpu").decode_render_input(
        signal, len(signal), Rate(rate))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match=r"l = 1 \(decimation\) tables need s_c = \[0\]"):
        DecodeTables.from_numpy(**{**tables.as_numpy(), "s_c": [3]})


@pytest.mark.parametrize("profile_name,rate,m", L1_CASES)
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_l1_table_emulation_equals_plain(profile_name, rate, m, dtype):
    """A torch emulation of the l == 1 sum, straight from its formula
    ``y[n] = sum_{j < min(K, n*m)} coeff[j] * x[n*m - j]`` (descending j
    from +0, one op per step), is ``torch.equal`` to K1's plain twin fed
    by ``causal_tables`` over ``causal_input``; ``y[0]`` is +0."""
    from noaa_apt_tpu_torch.ops import resample as rs

    t = DecodeTables.design(PROFILES[profile_name], Rate(rate))
    coeff = torch.from_numpy(t.bank[0].copy()).flip(0)
    k = coeff.shape[0]
    rng = np.random.default_rng(rate)
    if dtype == "int16":
        x = torch.from_numpy(rng.integers(-32768, 32768, 3 * k + 101, dtype=np.int16))
    else:
        x = torch.from_numpy(rng.normal(0, 1e4, 3 * k + 101).astype(np.float32))
    n_out = t.work_len(x.shape[0])
    xf = x.to(torch.float32)
    idx = torch.arange(n_out, dtype=torch.int64) * m
    want = torch.zeros(n_out, dtype=torch.float32)
    for j in range(k - 1, -1, -1):
        q = idx - j
        want = want + coeff[j] * torch.where(q >= 1, xf[q.clamp(min=0)], torch.zeros(()))
    args = [torch.from_numpy(a) for a in (t.bank, t.p_c, t.s_c)]
    got = rs.polyphase_resample(rs.causal_input(x, k), *args, m, n_out)
    assert rs.polyphase_resample.last_variant == "plain"
    assert torch.equal(got, want)
    assert got[0].item() == 0.0 and not torch.signbit(got[0])
