"""The port's orbit and map overlay (``geo/``, ``io/misc``, the orbit
branches of ``graph/process.finish_image``) against the JAX package's,
on the CPU.

Both are host numpy/Python doing the same f64 operations in the same
order, so every comparison here is exact: geometry, SGP4, ground track
and pass direction with ``==``, shapefiles, overlays and finished images
with ``np.array_equal``.  No test reaches the network: TLEs are given as
strings, and the states layer is either skipped through each package's
failure memo or read from a ``states.shp`` the test writes into the
settings directory's cache.
"""

import io
import math
import os
import urllib.request
import zipfile
from datetime import datetime, timedelta, timezone
from pathlib import Path

import numpy as np
import pytest
import torch

from noaa_apt_tpu.geo import geometry as jgeometry
from noaa_apt_tpu.geo import map_overlay as jmap
from noaa_apt_tpu.geo import orbit as jorbit
from noaa_apt_tpu.geo import sgp4 as jsg
from noaa_apt_tpu.geo import shapefile as jshp
from noaa_apt_tpu.geo import states as jstates
from noaa_apt_tpu.graph.process import finish_image as j_finish_image
from noaa_apt_tpu.io import misc as jmisc
from noaa_apt_tpu.io.config import Settings as JSettings
from noaa_apt_tpu import types as jtypes

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch import types
from noaa_apt_tpu_torch.geo import geometry, map_overlay, orbit, sgp4, shapefile, states, tle
from noaa_apt_tpu_torch.graph.process import finish_image
from noaa_apt_tpu_torch.io import misc
from noaa_apt_tpu_torch.io.config import DEFAULT_SETTINGS_TOML, Settings, res_path

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

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
GEO_TLE = """GOES 16
1 41866U 16071A   20028.50000000  .00000100  00000-0  00000+0 0  9993
2 41866   0.0500 270.0000 0001000  90.0000 180.0000  1.00271000 11001"""
# 2020-01-26T09:23:20Z: a NOAA 19 pass that starts over Bolivia and runs
# south across Argentina (the JAX package's overlay ink test).
PASS_START = datetime.fromtimestamp(1580030600, tz=timezone.utc)
SATS = ("NOAA 15", "NOAA 18", "NOAA 19")


@pytest.fixture(autouse=True)
def _offline(tmp_path, monkeypatch):
    """Own settings directory; the states download fails fast in both
    packages through their failure memo."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.delenv("NOAA_APT_RES_DIR", raising=False)
    monkeypatch.setattr(jstates, "_download_failed", [True])
    monkeypatch.setattr(states, "_download_failed", [True])


def _seeded_points(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-math.pi / 2, math.pi / 2, (n, 2))
    lon = rng.uniform(-math.pi, math.pi, (n, 2))
    return [((float(a[0]), float(b[0])), (float(a[1]), float(b[1]))) for a, b in zip(lat, lon)]


def test_geometry_equals_jax():
    """distance, azimuth and reckon on 64 seeded point pairs, exactly."""
    rng = np.random.default_rng(1)
    for p, q in _seeded_points(64, 0):
        assert geometry.distance(p, q) == jgeometry.distance(p, q)
        assert geometry.azimuth(p, q) == jgeometry.azimuth(p, q)
        rng_, az = float(rng.uniform(0, math.pi)), float(rng.uniform(-math.pi, math.pi))
        assert geometry.reckon(p, rng_, az) == jgeometry.reckon(p, rng_, az)


def test_parse_tle_and_satellite_latlon_equal_jax():
    """Every parsed field and SGP4 state, and the sub-satellite point of
    NOAA 15/18/19 at 50 seeded times within a week of the epoch."""
    sats, jsats = sgp4.parse_tle(TEST_TLE), jsg.parse_tle(TEST_TLE)
    assert [s.name for s in sats] == list(SATS)
    fields = ("name", "satnum", "epoch_jd", "bstar", "inclo", "nodeo", "ecco", "argpo", "mo",
              "no_kozai", "_init")
    for s, j in zip(sats, jsats):
        assert all(getattr(s, f) == getattr(j, f) for f in fields)
    secs = np.random.default_rng(2).integers(-3 * 86400, 4 * 86400, 50)
    for name in SATS:
        s, j = sgp4.find_satellite(sats, name), jsg.find_satellite(jsats, name)
        for d in secs:
            t = datetime(2020, 1, 28, 13, tzinfo=timezone.utc) + timedelta(seconds=int(d))
            assert sgp4.satellite_latlon(s, t) == jsg.satellite_latlon(j, t)
            assert sgp4.datetime_to_jd(t) == jsg.datetime_to_jd(t)
    with pytest.raises(err.InternalError, match="not found"):
        sgp4.find_satellite(sats, "NOAA 99")


def test_deep_space_boundary_equals_jax():
    """A geostationary TLE is refused with the JAX package's message; a
    200-minute orbit still parses and propagates alike."""
    with pytest.raises(err.FeatureNotAvailableError, match="deep-space") as info:
        sgp4.parse_tle(GEO_TLE)
    with pytest.raises(Exception) as jinfo:
        jsg.parse_tle(GEO_TLE)
    assert str(info.value) == str(jinfo.value)
    l2 = f"2 25338  98.7308  54.2052 0009655 316.5487  43.4931 {1440.0 / 200.0:11.8f}128892"
    text = "\n".join(["NEAR", TEST_TLE.splitlines()[1], l2])
    (s,), (j,) = sgp4.parse_tle(text), jsg.parse_tle(text)
    assert s.name == "NEAR" and sgp4.sgp4(s, 90.0) == jsg.sgp4(j, 90.0)


def test_ground_track_and_pass_direction_equal_jax():
    """The per-line track of a 1200-row pass from both reference kinds,
    and the rotation decision at seeded times for each satellite."""
    s = sgp4.find_satellite(sgp4.parse_tle(TEST_TLE), "NOAA 19")
    j = jsg.find_satellite(jsg.parse_tle(TEST_TLE), "NOAA 19")
    for kind in ("start", "end"):
        track = orbit.ground_track(s, types.RefTime(kind, PASS_START), 1200)
        assert len(track) == 1200
        assert track == jorbit.ground_track(j, jtypes.RefTime(kind, PASS_START), 1200)
    secs = np.random.default_rng(3).integers(0, 6 * 86400, 12)
    for name, sat in zip(SATS, types.SatName):
        for d in secs:
            t = PASS_START + timedelta(seconds=int(d))
            o = types.OrbitSettings(sat, types.RefTime.start(t), TEST_TLE)
            jo = jtypes.OrbitSettings(jtypes.SatName(sat.value), jtypes.RefTime.start(t), TEST_TLE)
            assert orbit.south_to_north_pass(o) is jorbit.south_to_north_pass(jo)


def test_vendored_shapefiles_are_a_copy_and_read_alike(tmp_path):
    """The port's res/shapefiles are byte-equal to the JAX package's and
    read into equal parts; write_parts/read_parts round-trips."""
    for name in ("countries.shp", "lakes.shp"):
        path = res_path("shapefiles", name)
        assert path.read_bytes() == (ROOT / "noaa_apt_tpu" / "res" / "shapefiles" / name).read_bytes()
        parts, jparts = shapefile.read_parts(path), jshp.read_parts(path)
        assert len(parts) == len(jparts) > 100
        assert all(np.array_equal(a, b) for a, b in zip(parts, jparts))
    parts = [np.array([[0.0, 0.0], [10.0, 5.0], [20.0, -5.0]]), np.array([[-30.0, 40.0], [-31.0, 41.0]])]
    shapefile.write_parts(tmp_path / "a.shp", parts, shapefile.SHAPE_POLYGON)
    jshp.write_parts(tmp_path / "b.shp", parts, jshp.SHAPE_POLYGON)
    assert (tmp_path / "a.shp").read_bytes() == (tmp_path / "b.shp").read_bytes()
    back = shapefile.read_parts(tmp_path / "a.shp")
    assert len(back) == 2 and all(np.array_equal(a, b) for a, b in zip(back, parts))
    (tmp_path / "bad.shp").write_bytes(b"x" * 200)
    for bad in (tmp_path / "missing.shp", tmp_path / "bad.shp"):
        with pytest.raises(err.InternalError, match="Could not load"):
            shapefile.read_parts(bad)


def _grey_rgba(rows: int, seed: int) -> np.ndarray:
    g = np.random.default_rng(seed).integers(0, 256, (rows, 2080), dtype=np.uint8)
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)


def _ink(img: np.ndarray, center: int) -> int:
    win = img[:, center - 456 : center + 456].astype(np.int16)
    return int((np.abs(win[..., 0] - win[..., 2]) > 10).sum())


def _states_cache(tmp_path: Path) -> None:
    """A small states.shp in the settings directory's cache: polylines
    along the pass's ground track, 1 and 3 degrees east of it."""
    s = sgp4.find_satellite(sgp4.parse_tle(TEST_TLE), "NOAA 19")
    track = orbit.ground_track(s, types.RefTime.start(PASS_START), 1200)
    parts = [np.array([[p[1] * 180 / math.pi + d, p[0] * 180 / math.pi] for p in track[::7]])
             for d in (1.0, 3.0)]
    (tmp_path / "cfg" / "noaa-apt-tpu").mkdir(parents=True)
    shapefile.write_parts(tmp_path / "cfg" / "noaa-apt-tpu" / "states.shp", parts)


@pytest.mark.parametrize("with_states", [False, True])
def test_draw_map_equals_jax(tmp_path, with_states):
    """The overlay on a 1200-row seeded grey image, byte-equal to JAX's:
    countries and lakes from the vendored files, states skipped or read
    from the cache."""
    if with_states:
        _states_cache(tmp_path)
    settings = types.MapSettings(yaw=0.01, hscale=1.1, vscale=0.95)
    jsettings = jtypes.MapSettings(yaw=0.01, hscale=1.1, vscale=0.95)
    img, jimg = _grey_rgba(1200, 4), _grey_rgba(1200, 4)
    map_overlay.draw_map(img, types.RefTime.start(PASS_START), settings, types.SatName.NOAA_19,
                         TEST_TLE)
    jmap.draw_map(jimg, jtypes.RefTime.start(PASS_START), jsettings, jtypes.SatName.NOAA_19,
                  TEST_TLE)
    assert _ink(img, 539) > 1000 and _ink(img, 1579) > 1000
    np.testing.assert_array_equal(img, jimg)
    assert (states.get_states_shp() is not None) == with_states


def test_rasterizer_batch_equals_scalar_and_jax():
    """The batch Wu + ordered blend equals the scalar contract
    (``xiaolin_wu`` + ``_blend_pixel``, the reference's sequential loop)
    and the JAX package's batch path, on chained seeded segments with
    collisions, dots, steep and long segments."""
    rng = np.random.default_rng(7)
    h = 120
    pts = np.stack([rng.uniform(-700, 700, 60), rng.uniform(-40, h + 40, 60)], axis=1)
    segs = [(*pts[i], *pts[i - 1]) for i in range(1, len(pts))]
    segs += [(5.0, 10.0, 5.0, 10.0), (-455.9, 1.0, 455.9, h - 1.0), (0.0, 0.5, 0.0, h - 0.5)]
    arr = np.asarray(segs, dtype=np.float64)
    color = (200, 120, 40, 180)
    scalar = np.zeros((h, 2080, 4), np.uint8)
    scalar[..., 3] = 255
    batch, jbatch = scalar.copy(), scalar.copy()
    for x1, y1, x2, y2 in segs:
        if (-456.0 < x1 < 456.0 and 0.0 < y1 < h) or (-600.0 < x1 < 600.0 and 0.0 < y1 < h):
            for (x, y), value in map_overlay.xiaolin_wu((x1, y1), (x2, y2)):
                if -456 < x < 456 and 0 < y < h:
                    rgba = (*color[:3], int(value * color[3]))
                    map_overlay._blend_pixel(scalar, x + 539, y, rgba)
                    map_overlay._blend_pixel(scalar, x + 1579, y, rgba)
    map_overlay._rasterize_segments(batch, *arr.T, color)
    jmap._rasterize_segments(jbatch, *arr.T, color)
    assert (batch[..., :3] > 0).sum() > 500
    np.testing.assert_array_equal(batch, scalar)
    np.testing.assert_array_equal(batch, jbatch)
    assert map_overlay.xiaolin_wu((0.0, 0.0), (10.0, 3.0)) == jmap.xiaolin_wu((0.0, 0.0), (10.0, 3.0))


def test_draw_map_missing_shapefiles_draws_nothing(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("NOAA_APT_RES_DIR", str(tmp_path / "nores"))
    img = np.zeros((20, 2080, 4), np.uint8)
    map_overlay.draw_map(img, types.RefTime.start(PASS_START), types.MapSettings(),
                         types.SatName.NOAA_19, TEST_TLE)
    assert img[..., :3].sum() == 0 and "not found, skipping" in caplog.text
    with pytest.raises(err.InternalError, match="states.shp unavailable"):
        map_overlay.draw_map(img, types.RefTime.start(PASS_START), types.MapSettings(),
                             types.SatName.NOAA_19, TEST_TLE, strict=True)


FINISH_CASES = {
    "map_orbit_rotation": ("percent", types.Rotate.ORBIT, False),
    "false_colour_map": ("percent", types.Rotate.NO, True),
    "histogram_map": ("histogram", types.Rotate.ORBIT, False),
    "false_colour_histogram_map": ("histogram", types.Rotate.YES, True),
}


@pytest.mark.parametrize("case", sorted(FINISH_CASES))
def test_finish_image_with_orbit_equals_jax(case):
    """The same u8 grey through both ``finish_image`` with orbit settings:
    overlay after colour and equalization, before the rotation."""
    kind, rotate, coloured = FINISH_CASES[case]
    palette = res_path("palettes", "noaa-apt-daylight.png")
    gray = _grey_rgba(300, 5)[..., 0]
    ref = types.RefTime.start(PASS_START)
    o = types.OrbitSettings(types.SatName.NOAA_19, ref, TEST_TLE, types.MapSettings())
    jo = jtypes.OrbitSettings(jtypes.SatName.NOAA_19, jtypes.RefTime.start(PASS_START), TEST_TLE,
                              jtypes.MapSettings())
    got = finish_image(gray, types.ContrastKind(kind), rotate,
                       types.ColorSettings(palette) if coloured else None, o)
    want = j_finish_image(gray, jtypes.ContrastKind(kind), jtypes.Rotate(rotate.value),
                          jtypes.ColorSettings(palette) if coloured else None, jo)
    np.testing.assert_array_equal(got, want)
    plain = finish_image(gray, types.ContrastKind(kind), types.Rotate.NO,
                         types.ColorSettings(palette) if coloured else None)
    assert not np.array_equal(got, plain)  # the overlay (and rotation) did something


def test_finish_image_orbit_rotation_without_orbit_warns(caplog):
    gray = _grey_rgba(3, 6)[..., 0]
    img = finish_image(gray, types.ContrastKind.PERCENT, types.Rotate.ORBIT)
    np.testing.assert_array_equal(img, finish_image(gray, types.ContrastKind.PERCENT, types.Rotate.NO))
    assert "Can't rotate automatically if no orbit information is provided" in caplog.text


class _Frozen(datetime):
    """``datetime`` whose ``now`` is a fixed instant, for formats that
    leave fields to the current time."""

    @classmethod
    def now(cls, tz=None):
        return datetime(2021, 7, 4, 5, 6, 7, tzinfo=timezone.utc).astimezone(tz)


def _seeded_filenames() -> list[str]:
    """One seeded name for each default format (``%N``, ``%!`` and the
    ``%2`` skip among them), plus names that match no format."""
    rng = np.random.default_rng(8)
    out = []
    for _ in range(6):
        y, mo, d = int(rng.integers(2000, 2030)), int(rng.integers(1, 13)), int(rng.integers(1, 29))
        h, mi, s = int(rng.integers(0, 24)), int(rng.integers(0, 60)), int(rng.integers(0, 60))
        sat = int(rng.choice([15, 18, 19]))
        f = int(rng.integers(137_000_000, 138_000_000))
        out += [
            f"gqrx_{y}{mo:02}{d:02}_{h:02}{mi:02}{s:02}_{f}.wav",
            f"SDRSharp_{y}{mo:02}{d:02}_{h:02}{mi:02}{s:02}Z_{f}Hz_AF.wav",
            f"{y}{mo:02}{d:02}-{h:02}{mi:02}-noaa-{sat}.wav",
            f"NOAA{sat}-{y}{mo:02}{d:02}-{h:02}{mi:02}{s:02}.wav",
            f"N{sat}{y}{mo:02}{d:02}{h:02}{mi:02}{s:02}.wav",
            f"{y}-{mo:02}-{d:02}-{h:02}-{mi:02}-{s:02}-NOAA_{sat}.wav",
            f"{y}{mo:02}{d:02}-{h:02}{mi:02}{s:02}NOAA{sat}El{int(rng.integers(10, 99))}.wav",
            f"audio_{f}Hz_{h:02}-{mi:02}-{s:02}_{d:02}-{mo:02}-{y}.wav",
            f"NOAA{sat}-{y}{mo:02}{d:02}.wav",  # too short: no format matches
        ]
    return out + ["N2020010203040.wav", "N1720200102030405.wav", "recording.wav"]


def test_infer_time_sat_equals_jax(tmp_path, monkeypatch):
    """The settings file's default formats on seeded names, the mtime
    fallback, a non-zero timezone, ``prefer_timestamps`` and the
    mini-format edge cases (``%1``-``%9`` past the end, a trailing ``%``,
    an unknown option), with ``now`` frozen in both packages."""
    import tomllib

    monkeypatch.setattr(misc, "datetime", _Frozen)
    monkeypatch.setattr(jmisc, "datetime", _Frozen)
    formats = tomllib.loads(DEFAULT_SETTINGS_TOML)["timestamps"]["filenames"]
    names = _seeded_filenames()
    fallbacks = 0
    for tz_hours, prefer in ((0.0, False), (-3.0, False), (5.5, True)):
        settings = Settings(prefer_timestamps=prefer, filename_formats=formats,
                            filename_timezone=tz_hours)
        jsettings = JSettings(prefer_timestamps=prefer, filename_formats=formats,
                              filename_timezone=tz_hours)
        for i, name in enumerate(names):
            path = tmp_path / name
            path.write_bytes(b"")
            os.utime(path, (1_600_000_000 + i, 1_600_000_000 + i))
            (ref, sat), (jref, jsat) = misc.infer_time_sat(settings, path), jmisc.infer_time_sat(jsettings, path)
            assert (ref.kind, ref.time, sat.value) == (jref.kind, jref.time, jsat.value), name
            fallbacks += ref.kind == "end"
    assert 9 < fallbacks < 3 * len(names)  # both the parsed and the fallback branch ran
    tz = timezone(timedelta(hours=2))
    for name, fmt in (("abc", "%9"), ("ab%", "ab%"), ("x1", "x%Q"), ("N19x", "N%Nx"),
                      ("20201301", "%Y%m%d"), ("137100000", "%!")):
        got, want = misc.parse_filename(name, fmt, tz), jmisc.parse_filename(name, fmt, tz)
        assert (got is None) == (want is None), (name, fmt)
        if got is not None:
            assert (got[0].time, got[1].value) == (want[0].time, want[1].value)
    with pytest.raises(err.InternalError, match="Could not read metadata"):
        misc.read_timestamp(tmp_path / "missing.wav")


def test_states_download_cache_and_failure_memo(tmp_path, monkeypatch):
    """Vendored, then the cache, then one download into the cache (a fake
    ``urlopen``); a corrupt archive warns, returns None and trips the
    memo, after which nothing is fetched."""
    monkeypatch.setattr(states, "_download_failed", [False])
    payload = tmp_path / "payload.shp"
    shapefile.write_parts(payload, [np.array([[10.0, 0.0], [11.0, 1.0]])])
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("ne_10m_admin_1_states_provinces_lines.shp", payload.read_bytes())
    calls = []
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda url, timeout=0: calls.append(url) or io.BytesIO(buf.getvalue()))
    p1 = states.get_states_shp()
    assert p1 == tmp_path / "cfg" / "noaa-apt-tpu" / "states.shp" and calls == [states.URL]
    assert p1.read_bytes() == payload.read_bytes()
    assert states.get_states_shp() == p1 and len(calls) == 1
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg2"))
    assert states.get_states_shp(allow_download=False) is None
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=0: io.BytesIO(b"not a zip"))
    assert states.get_states_shp() is None and states._download_failed[0] is True
    monkeypatch.setattr(urllib.request, "urlopen", lambda url, timeout=0: calls.append(url))
    assert states.get_states_shp() is None and len(calls) == 1


def test_tle_cache_and_download_error(tmp_path, monkeypatch):
    """A fresh cached TLE is read without a download; a stale one is
    replaced by a download (here a fake), and a failing download raises
    the reference's request error."""
    download = tle._download_tle
    cache = tmp_path / "cfg" / "noaa-apt-tpu" / "weather.txt"
    cache.parent.mkdir(parents=True)
    cache.write_text(TEST_TLE)
    monkeypatch.setattr(tle, "_download_tle", lambda: pytest.fail("downloaded with a fresh cache"))
    assert tle.get_current_tle() == TEST_TLE
    os.utime(cache, (0, 0))
    monkeypatch.setattr(tle, "_download_tle", lambda: "NEW")
    assert tle.get_current_tle() == "NEW" and cache.read_text() == "NEW"

    def offline(url, timeout=0):
        raise OSError("no network here")

    monkeypatch.setattr(urllib.request, "urlopen", offline)
    with pytest.raises(err.RequestError, match="Unable to download satellite TLE"):
        download()


def test_prefetch_states_runs_once_in_a_thread(monkeypatch):
    """``prefetch_states_async`` resolves states.shp in one daemon thread
    (here the failure memo is set, so it finds nothing and fetches
    nothing); a second call starts no other thread."""
    monkeypatch.setattr(states, "_prefetch_thread", [None])
    monkeypatch.setattr(states, "download_states_shp", lambda dest: pytest.fail("downloaded"))
    states.prefetch_states_async()
    thread = states._prefetch_thread[0]
    thread.join(timeout=30)
    assert thread.daemon and not thread.is_alive()
    states.prefetch_states_async()
    assert states._prefetch_thread[0] is thread
