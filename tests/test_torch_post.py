"""The port's host modules of the contrast and colour slice against the
JAX package: PNG reading, settings, the step-export context, telemetry,
the equalizers, false colour and ``process()`` on a flat signal.

The same seeded numpy inputs go through both packages; every module here
is a copy of the JAX package's, so the results must be bit-equal.
"""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from noaa_apt_tpu import PX_PER_ROW
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.graph.process import finish_image as j_finish_image
from noaa_apt_tpu.graph.process import process as j_process
from noaa_apt_tpu.io import config as jcfg
from noaa_apt_tpu.io.context import Context as JContext
from noaa_apt_tpu.post import imageext as jimageext
from noaa_apt_tpu.post import palette as jpalette
from noaa_apt_tpu.post import telemetry as jtel
from noaa_apt_tpu.synth import apt_pattern
from noaa_apt_tpu.types import ColorSettings as JColorSettings
from noaa_apt_tpu.types import Contrast as JContrast
from noaa_apt_tpu.types import ContrastKind as JContrastKind
from noaa_apt_tpu.types import Rotate as JRotate

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.graph.process import finish_image, process
from noaa_apt_tpu_torch.io import config as cfg
from noaa_apt_tpu_torch.io import png
from noaa_apt_tpu_torch.io.context import Context
from noaa_apt_tpu_torch.post import imageext, palette, processing
from noaa_apt_tpu_torch.post import telemetry as tel
from noaa_apt_tpu_torch.types import ColorSettings, Contrast, ContrastKind, Rotate

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PALETTES = ROOT / "noaa_apt_tpu" / "res" / "palettes"
PORT_PALETTES = ROOT / "noaa_apt_tpu_torch" / "res" / "palettes"
PALETTES = sorted(p.name for p in JAX_PALETTES.glob("*.png"))


@pytest.fixture(autouse=True)
def _own_settings_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)


# -- io/png ------------------------------------------------------------------
def test_port_ships_the_22_palettes():
    assert len(PALETTES) == 22
    assert sorted(p.name for p in PORT_PALETTES.glob("*.png")) == PALETTES
    for name in PALETTES:
        assert (PORT_PALETTES / name).read_bytes() == (JAX_PALETTES / name).read_bytes(), name


@pytest.mark.parametrize("name", PALETTES)
def test_read_png_equals_pil_on_palettes(name):
    got = png.read_png(PORT_PALETTES / name)
    want = np.asarray(Image.open(JAX_PALETTES / name))
    assert got.shape == (256, 256, want.shape[2])
    np.testing.assert_array_equal(got, want)


def _with_ihdr(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields (bit depth, colour type, interlace)
    replaced and its CRC recomputed."""
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", data[16:29])
    depth, color, interlace = (fields.get(k, v) for k, v in
                               (("depth", depth), ("color", color), ("interlace", interlace)))
    body = b"IHDR" + struct.pack(">IIBBBBB", w, h, depth, color, comp, filt, interlace)
    return data[:12] + body + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + data[33:]


def test_read_png_rejects_what_it_does_not_read(tmp_path):
    gray16 = np.arange(64 * 48, dtype=np.uint16).reshape(48, 64) * 13
    Image.fromarray(gray16).save(tmp_path / "g16.png")
    Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(tmp_path / "pal.png")
    rgb = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    (tmp_path / "interlaced.png").write_bytes(_with_ihdr(rgb, interlace=1))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    for name, match in (("g16.png", "bit depth 16"), ("pal.png", "colour type 3"),
                        ("interlaced.png", "interlace 1"), ("not.png", "not a PNG"),
                        ("missing.png", "Could not read")):
        with pytest.raises(err.InvalidInputError, match=match):
            png.read_png(tmp_path / name)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_round_trips_through_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (9, 31, channels), dtype=np.uint8)
    arr = img[..., 0] if channels == 1 else img
    png.write_png(tmp_path / "a.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), arr)
    np.testing.assert_array_equal(png.read_png(tmp_path / "a.png"), img)
    # Every filter type, as PIL's optimizing encoder picks them.
    Image.fromarray(arr).save(tmp_path / "b.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(tmp_path / "b.png"), img)


# -- io/config and io/context ------------------------------------------------
@pytest.mark.parametrize("profile_name", [None, "standard", "fast", "slow", "bogus"])
def test_settings_equal_jax(profile_name):
    assert cfg.DEFAULT_SETTINGS_TOML == jcfg.DEFAULT_SETTINGS_TOML
    de, jde = cfg.load_de_settings(), jcfg.load_de_settings()
    assert de == jde
    got, want = cfg.build_settings(de, profile_name), jcfg.build_settings(jde, profile_name)
    for name in ("work_rate", "resample_atten", "resample_delta_freq", "resample_cutout",
                 "demodulation_atten", "filename_formats", "default_states_color"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.default_palette_filename == PORT_PALETTES / "noaa-apt-daylight.png"
    assert got.default_palette_filename.read_bytes() == want.default_palette_filename.read_bytes()
    assert got.profile().work_rate == want.profile().work_rate


def test_settings_file_is_shared_and_migrated(tmp_path, monkeypatch):
    path = tmp_path / "cfg" / "noaa-apt-tpu" / "settings.toml"
    cfg.load_de_settings()
    assert path.read_text() == cfg.DEFAULT_SETTINGS_TOML
    path.write_text(cfg.DEFAULT_SETTINGS_TOML.replace("default_profile = \"standard\"",
                                                      "default_profile = \"slow\""))
    assert cfg.build_settings(cfg.load_de_settings()).work_rate == 20800
    path.write_text("version = 3\n")
    assert cfg.load_de_settings() == jcfg.load_de_settings()
    assert path.with_suffix(".OLD").read_text() == "version = 3\n"
    monkeypatch.setenv("NOAA_APT_RES_DIR", str(tmp_path / "res"))
    assert cfg.res_path("palettes", "x.png") == tmp_path / "res" / "palettes" / "x.png"


def test_context_exports_the_same_steps(tmp_path):
    """Status calls reach the callback, and the ordered step export writes
    the JAX package's files (the telemetry steps 12-16 included)."""
    seen, jseen = [], []
    ctx = Context.decode(lambda p, d: seen.append((p, d)), Rate(12480), Rate(4160), True, False,
                         tmp_path / "port")
    jctx = JContext.decode(lambda p, d: jseen.append((p, d)), JRate(12480), JRate(4160), True,
                           False, tmp_path / "jax")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    rng = np.random.default_rng(0)
    for meta in ctx.steps_metadata:
        sig = rng.standard_normal(50).astype(np.float32)
        given = meta.rate is None and meta.variant == "signal"  # the input's rate
        for c, rate in ((ctx, Rate(11025) if given else None), (jctx, JRate(11025) if given else None)):
            c.status(0.5, meta.description)
            c.step(meta.variant, "not_a_step", sig)  # ignored: out of order
            c.step(meta.variant, meta.id, sig, rate)
    assert seen == jseen and len(seen) == 17
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(files) == 15  # the two resample_filtered steps are off
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == files
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# -- post/telemetry ----------------------------------------------------------
def _sample_wedge():
    return np.array([1.0, 1.2, 0.8, 1.1, 0.9, 0.7, 1.3, 1.0], dtype=np.float32)


def test_telemetry_from_bands_truth_table():
    """tests/test_post.py's port of telemetry.rs:256-311, through both."""
    w = _sample_wedge()
    factors = [-5234.0] + list(range(1, 17)) + list(range(1, 10)) + [-5234.0]
    means_a = np.concatenate([w * f for f in factors]).astype(np.float32)
    means_b = means_a + 1.0
    t = tel.Telemetry.from_bands(means_a, means_b, row=8)
    jt = jtel.Telemetry.from_bands(means_a, means_b, row=8)
    np.testing.assert_array_equal(t.values_a.view(np.uint32), jt.values_a.view(np.uint32))
    np.testing.assert_array_equal(t.values_b.view(np.uint32), jt.values_b.view(np.uint32))
    for wedge in range(1, 17):
        assert t.get_wedge_value(wedge, "a") == pytest.approx(wedge, rel=1e-5)
        assert t.get_wedge_value(wedge, None) == jt.get_wedge_value(wedge, None)


# The truth table of telemetry.rs:332-341 (tests/test_post.py), with its
# exact tie: Rust min_by keeps the FIRST equal minimum.
CHANNEL_CASES = [("1", 1.0, "2", 2.0), ("3a", 3.0, "3b", 6.0), ("4", 4.0, "5", 5.0),
                 ("Unknown", 7.0, "Unknown", 8.0), ("Unknown", 9.0, "Unknown", 1000.0),
                 ("1", 1.4, "2", 1.6), ("3a", 2.6, "3a", 3.4), ("1", -1000.0, "5", 5.4),
                 ("1", 1.5, "3a", 3.5)]


@pytest.mark.parametrize("name_a,val_a,name_b,val_b", CHANNEL_CASES)
def test_telemetry_channel_names_truth_table(name_a, val_a, name_b, val_b):
    sample = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0]
    t = tel.Telemetry(np.array(sample + [val_a]), np.array(sample + [val_b]))
    jt = jtel.Telemetry(np.array(sample + [val_a]), np.array(sample + [val_b]))
    assert (t.get_channel_name("a"), t.get_channel_name("b")) == (name_a, name_b)
    assert (jt.get_channel_name("a"), jt.get_channel_name("b")) == (name_a, name_b)


def _spy_best_row(monkeypatch, module) -> list:
    """Record the frame row each ``Telemetry.from_bands`` call gets."""
    rows, orig = [], module.Telemetry.from_bands.__func__

    def spy(cls, means_a, means_b, row):
        rows.append(row)
        return orig(cls, means_a, means_b, row)

    monkeypatch.setattr(module.Telemetry, "from_bands", classmethod(spy))
    return rows


@pytest.mark.parametrize("seed,n_rows", [(0, 400), (1, 230), (2, 200), (3, 1200)])
def test_telemetry_from_stats_bit_equal_jax(monkeypatch, seed, n_rows):
    """Frame search (first strict maximum from 0), wedge values and channel
    names on the same stats: the synthesized pattern's bands with seeded
    noise, and seed 1 with ties in the quality (a flat band)."""
    pattern = apt_pattern(n_rows=n_rows, telemetry_start_row=7 * seed)
    noisy = pattern + np.random.default_rng(seed).normal(0, 6, pattern.shape).astype(np.float32)
    if seed == 1:
        noisy[:, 2034:2078] = noisy[:, 994:1038]
    ma, mb, var = tel.band_statistics(noisy.reshape(-1))
    for a, b in zip((ma, mb, var), jtel.band_statistics(noisy.reshape(-1))):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    rows, jrows = _spy_best_row(monkeypatch, tel), _spy_best_row(monkeypatch, jtel)
    t = tel.telemetry_from_stats(ma, mb, var)
    jt = jtel.telemetry_from_stats(ma, mb, var)
    assert rows == jrows and len(rows) == 1
    np.testing.assert_array_equal(t.values_a.view(np.uint32), jt.values_a.view(np.uint32))
    np.testing.assert_array_equal(t.values_b.view(np.uint32), jt.values_b.view(np.uint32))
    for ch in ("a", "b"):
        assert t.get_channel_name(ch) == jt.get_channel_name(ch)
    if n_rows >= 400:
        assert (t.get_channel_name("a"), t.get_channel_name("b")) == ("2", "4")


def test_read_telemetry_too_short_same_message():
    with pytest.raises(err.InternalError) as exc:
        tel.read_telemetry(np.zeros(PX_PER_ROW * 100, np.float32))
    with pytest.raises(Exception) as jexc:
        jtel.read_telemetry(np.zeros(PX_PER_ROW * 100, np.float32))
    assert str(exc.value) == str(jexc.value) == "Recording too short for telemetry decoding"


# -- post/imageext -------------------------------------------------------------
def test_lab_equalize_golden():
    g = np.load(ROOT / "tests" / "golden" / "lab_equalize.npz")
    img = g["input"].copy()
    np.testing.assert_array_equal(imageext.rgb_to_lab(img[..., :3]).astype(np.float32), g["lab"])
    imageext.equalize_histogram_color(img)
    np.testing.assert_array_equal(img, g["expected"])
    jimg = g["input"].copy()
    jimageext.equalize_histogram_color(jimg)
    np.testing.assert_array_equal(img, jimg)


@pytest.mark.parametrize("seed", range(3))
def test_imageext_bit_equal_jax_on_seeded_rgba(seed):
    rng = np.random.default_rng(seed)
    rgba = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    lab = imageext.rgb_to_lab(rgba[..., :3])
    np.testing.assert_array_equal(lab.view(np.uint32), jimageext.rgb_to_lab(rgba[..., :3]).view(np.uint32))
    np.testing.assert_array_equal(imageext.lab_to_rgb(lab), jimageext.lab_to_rgb(lab))
    for fn in ("equalize_histogram_color", "equalize_histogram_grayscale"):
        a, b = rgba.copy(), rgba.copy()
        getattr(imageext, fn)(a)
        getattr(jimageext, fn)(b)
        np.testing.assert_array_equal(a, b)


# -- post/processing, post/palette, graph/process ------------------------------
def _gray_rows(seed: int, rows: int = 40) -> np.ndarray:
    """u8 rows with a narrow histogram (so equalization moves them)."""
    rng = np.random.default_rng(seed)
    gray = rng.normal(120, 25, (rows, PX_PER_ROW)).clip(0, 255).astype(np.uint8)
    gray[:, 1040 + 86 : 1040 + 995] //= 2
    return gray


# (palette, tune values): the default, one without filter 0 and RGBA
# palettes read through both readers.
COLOR_CASES = [("noaa-apt-daylight.png", (0.0, 0.0, 0.0, 0.0)), ("WXtoImg-NO.png", (0.0, 0.0, 0.0, 0.0)),
               ("WXtoImg-class.png", (10.0, 20.0, -5.0, 30.0)), ("noaa-apt-night.png", (0.0, 0.0, 0.0, 0.0))]


@pytest.mark.parametrize("name,tune", COLOR_CASES)
@pytest.mark.parametrize("kind", ["percent", "histogram"])
def test_false_color_and_equalization_bit_equal_jax(name, tune, kind):
    gray = _gray_rows(len(name))
    color = ColorSettings(PORT_PALETTES / name, *tune)
    jcolor = JColorSettings(JAX_PALETTES / name, *tune)
    got = finish_image(gray, ContrastKind(kind), Rotate.YES, color)
    want = j_finish_image(gray, JContrastKind(kind), JRotate.YES, jcolor)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(2))
def test_grey_histogram_equalization_bit_equal_jax(seed):
    gray = _gray_rows(seed)
    got = finish_image(gray, ContrastKind.HISTOGRAM, Rotate.NO)
    np.testing.assert_array_equal(got, j_finish_image(gray, JContrastKind.HISTOGRAM, JRotate.NO))
    img = np.repeat(gray[..., None], 4, axis=2)
    jimg = img.copy()
    processing.histogram_equalization(img, False)
    from noaa_apt_tpu.post import processing as jprocessing

    jprocessing.histogram_equalization(jimg, False)
    np.testing.assert_array_equal(img, jimg)


def test_palette_errors_keep_the_jax_messages(tmp_path):
    Image.fromarray(np.zeros((16, 256, 3), np.uint8)).save(tmp_path / "small.png")
    gray = _gray_rows(0, rows=2)
    for path, msg in ((tmp_path / "small.png", "Invalid palette image dimensions"),
                      (tmp_path / "missing.png", "Could not load")):
        with pytest.raises(err.InvalidInputError, match=msg):
            finish_image(gray, ContrastKind.PERCENT, Rotate.NO, ColorSettings(path))


def test_default_palette_fallback(tmp_path):
    np.testing.assert_array_equal(palette.generate_daylight_palette(),
                                  jpalette.generate_daylight_palette())
    path = palette.ensure_default_palette(tmp_path / "gen" / "daylight.png")
    np.testing.assert_array_equal(png.read_png(path), jpalette.generate_daylight_palette())
    assert palette.ensure_default_palette(path) == path


def _flat_signal(n_rows: int = 420) -> np.ndarray:
    """A decoded-looking flat signal: the synthesized pattern with noise."""
    pattern = apt_pattern(n_rows=n_rows, telemetry_start_row=5)
    rng = np.random.default_rng(11)
    return (pattern + rng.normal(0, 4, pattern.shape)).astype(np.float32).reshape(-1) * 1e-3


@pytest.mark.parametrize("kind", ["percent", "minmax", "histogram", "telemetry"])
@pytest.mark.parametrize("colored", [False, True])
def test_process_flat_signal_equals_jax(kind, colored):
    """``process()`` on a flat signal (the ``.npy`` path) equals the JAX
    package's for every contrast kind, grey and false colour, with the
    same status calls."""
    sig = _flat_signal()
    contrast = {"percent": Contrast.from_percent(0.98), "minmax": Contrast.minmax(),
                "histogram": Contrast.histogram(), "telemetry": Contrast.telemetry()}[kind]
    jcontrast = JContrast(JContrastKind(kind), contrast.percent)
    color = ColorSettings(PORT_PALETTES / "noaa-apt-daylight.png") if colored else None
    jcolor = JColorSettings(JAX_PALETTES / "noaa-apt-daylight.png") if colored else None
    seen, jseen = [], []
    got = process(sig, contrast, Rotate.NO, color,
                  context=Context.decode(lambda p, d: seen.append(d)))
    want = j_process(sig, jcontrast, JRotate.NO, jcolor,
                     context=JContext.decode(lambda p, d: jseen.append(d)))
    assert got.shape == (420, PX_PER_ROW, 4)
    np.testing.assert_array_equal(got, want)
    assert seen == jseen


def test_process_refuses_a_ragged_signal():
    with pytest.raises(err.InternalError, match="wrong buffer length"):
        process(np.zeros(PX_PER_ROW * 3 + 1, np.float32), Contrast.minmax(), Rotate.NO)
