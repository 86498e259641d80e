"""Map overlay: project shapefile vectors into APT image coordinates
and rasterize with anti-aliased lines.

Behavioral contract: reference ``src/map.rs`` — per-line SGP4 ground
track (500 ms/line), Napier right-spherical-triangle projection with a
+-pi/3 distance clamp and yaw shear, per-line X-offset correction, and
Xiaolin-Wu anti-aliased lines alpha-blended into BOTH channels at
x+539 and x+1579, clipped to +-456 px.

The reference draws one Python-equivalent scalar loop per vertex
(map.rs:160-197).  Real Natural Earth data is ~240k vertices, so here
the whole overlay is computed as NumPy batch stages instead:

1. project every vertex of a shapefile at once (``_project_batch``),
2. per-segment Xiaolin-Wu coverage with the crate's exact iterative
   ``y += gradient`` accumulation reproduced via ``np.add.accumulate``
   over count-bucketed 2-D matrices (``_wu_batch``),
3. alpha-blend hits grouped into collision rounds so that every pixel
   receives its blends in the same order as the sequential reference
   (``_blend_ordered``).

The scalar ``xiaolin_wu`` / ``_blend_pixel`` helpers remain as the
single-pixel contract; tests assert the batch path is bit-identical.

Divergence (documented): missing shapefiles are skipped with a warning
instead of aborting the decode — the reference errors out
(``map.rs:136-137``), but its own checkout ships without ``states.shp``.
Set ``strict=True`` for reference behavior.

A copy of ``noaa_apt_tpu/geo/map_overlay.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import logging
import math

import numpy as np

from .. import err
from ..io.config import res_path
from ..types import MapSettings, RefTime, SatName
from . import sgp4 as sg
from .geometry import azimuth, distance
from .orbit import ground_track
from .shapefile import read_parts

log = logging.getLogger(__name__)

PI = math.pi

# Pixel clip window around each channel center (map.rs:122-127).
X_CLIP = 456
CH_A_OFFSET = 539
CH_B_OFFSET = 1579


def _rust_round(v: float) -> int:
    """f64::round — half away from zero (Python's round is banker's)."""
    return int(math.floor(v + 0.5)) if v >= 0 else int(math.ceil(v - 0.5))


def xiaolin_wu(p1: tuple[float, float], p2: tuple[float, float]):
    """Anti-aliased line: yields ((x, y), coverage in 0..1).

    Matches the ``line_drawing`` crate's ``XiaolinWu`` iterator the
    reference uses (map.rs:119): x steps from round(x1) to round(x2)
    inclusive, emitting (x, floor(y)) with weight 1-fpart and — when
    fpart > 0 — (x, floor(y)+1) with weight fpart; y starts at the raw
    endpoint (no endpoint-gap weighting, unlike the textbook version).
    """
    x1, y1 = p1
    x2, y2 = p2
    steep = abs(y2 - y1) > abs(x2 - x1)
    if steep:
        x1, y1, x2, y2 = y1, x1, y2, x2
    if x1 > x2:
        x1, x2 = x2, x1
        y1, y2 = y2, y1
    dx = x2 - x1
    gradient = (y2 - y1) / dx if dx != 0.0 else 1.0

    out = []
    x = _rust_round(x1)
    end_x = _rust_round(x2)
    y = y1
    while x <= end_x:
        fl = math.floor(y)
        fpart = y - fl
        fl = int(fl)
        pt = (fl, x) if steep else (x, fl)
        out.append((pt, 1.0 - fpart))
        if fpart > 0.0:
            pt2 = (fl + 1, x) if steep else (x, fl + 1)
            out.append((pt2, fpart))
        x += 1
        y += gradient
    return out


def _blend_pixel(img: np.ndarray, x: int, y: int, rgba: tuple[int, int, int, int]) -> None:
    """Alpha-composite one RGBA pixel — the image crate v0.24's
    ``Rgba::<u8>::blend`` op for op: f32 compositing in the normalized
    0..1 domain, premultiplied channels, ``alpha_final = bg_a + fg_a -
    bg_a*fg_a``, truncating cast back to u8.  Matching the dtype and
    association keeps overlay pixels byte-identical to the reference
    renderer."""
    sr, sg_, sb, sa = rgba
    if sa == 0:
        return
    if sa == 255:
        img[y, x] = (sr, sg_, sb, 255)
        return
    f32 = np.float32
    dr, dg, db, da = (f32(v) / f32(255.0) for v in img[y, x])
    fr, fg_, fb, fa = (f32(v) / f32(255.0) for v in (sr, sg_, sb, sa))
    ao = da + fa - da * fa
    if ao == 0.0:
        return
    inv = f32(1.0) - fa
    img[y, x, 0] = int(f32(255.0) * ((fr * fa + dr * da * inv) / ao))
    img[y, x, 1] = int(f32(255.0) * ((fg_ * fa + dg * da * inv) / ao))
    img[y, x, 2] = int(f32(255.0) * ((fb * fa + db * da * inv) / ao))
    img[y, x, 3] = int(f32(255.0) * ao)


def _project_batch(
    lat: np.ndarray,
    lon: np.ndarray,
    start_latlon: tuple[float, float],
    ref_az: float,
    x_res: float,
    y_res: float,
    yaw: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``latlon_to_rel_px`` (map.rs:71-95) over arrays of
    radians.  Same operation order as the scalar geometry helpers so
    results agree to the ulp."""
    lat1, lon1 = start_latlon
    delta_lon = lon - lon1
    cos_dlon = np.cos(delta_lon)
    # azimuth(start, p) — geo.rs:53-61
    az = np.arctan2(
        np.sin(delta_lon),
        math.cos(lat1) * np.tan(lat) - math.sin(lat1) * cos_dlon,
    )
    b = az - ref_az
    # distance(p, start) — geo.rs:35-45 (symmetric in its arguments)
    cos_c = np.clip(
        math.sin(lat1) * np.sin(lat) + math.cos(lat1) * np.cos(lat) * cos_dlon,
        -1.0,
        1.0,
    )
    c = np.minimum(PI / 3.0, np.maximum(-PI / 3.0, np.arccos(cos_c)))
    a = np.arctan(np.cos(b) * np.tan(c))
    bb = np.arcsin(np.sin(b) * np.sin(c))
    x = -bb / x_res
    y = a / y_res + yaw * x
    return x, y


def _rust_round_arr(v: np.ndarray) -> np.ndarray:
    return np.where(v >= 0.0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)


# Count buckets for the Wu accumulation matrices: (max count, chunking).
_WU_BUCKETS = (16, 64, 256, 1024)
_WU_CHUNK = 1024  # k-chunk width for segments longer than the last bucket


def _wu_batch(
    x1: np.ndarray, y1: np.ndarray, x2: np.ndarray, y2: np.ndarray
) -> tuple[np.ndarray, ...]:
    """Vectorized Xiaolin-Wu over n segments.

    Returns (seg, step, sub, px, py, weight) hit arrays in arbitrary
    order plus the (seg, step, sub) keys needed to restore the exact
    sequential emission order.  ``y`` is advanced by repeated addition
    (``np.add.accumulate`` row-wise), matching the scalar loop's
    floating-point accumulation bit-for-bit.
    """
    steep = np.abs(y2 - y1) > np.abs(x2 - x1)
    sx1 = np.where(steep, y1, x1)
    sy1 = np.where(steep, x1, y1)
    sx2 = np.where(steep, y2, x2)
    sy2 = np.where(steep, x2, y2)
    swap = sx1 > sx2
    a1 = np.where(swap, sx2, sx1)
    b1 = np.where(swap, sy2, sy1)
    a2 = np.where(swap, sx1, sx2)
    b2 = np.where(swap, sy1, sy2)
    dx = a2 - a1
    with np.errstate(divide="ignore", invalid="ignore"):
        grad = np.where(dx != 0.0, (b2 - b1) / np.where(dx == 0.0, 1.0, dx), 1.0)
    x0 = _rust_round_arr(a1)
    count = _rust_round_arr(a2) - x0 + 1

    segs, steps, subs, pxs, pys, ws = [], [], [], [], [], []

    def emit(idx: np.ndarray, k0: int, ys: np.ndarray, valid: np.ndarray) -> None:
        """ys: [len(idx), M] accumulated y values for steps k0..k0+M-1."""
        m = ys.shape[1]
        fl = np.floor(ys)
        fpart = ys - fl
        ks = k0 + np.arange(m, dtype=np.int64)[None, :]
        xs = x0[idx][:, None] + ks
        st = steep[idx][:, None]
        fli = fl.astype(np.int64)
        # main pixel: (fl, x) if steep else (x, fl)
        px_main = np.where(st, fli, xs)
        py_main = np.where(st, xs, fli)
        px_sub = np.where(st, fli + 1, xs)
        py_sub = np.where(st, xs, fli + 1)
        seg_grid = np.broadcast_to(idx[:, None], ys.shape)
        k_grid = np.broadcast_to(ks, ys.shape)
        sub_valid = valid & (fpart > 0.0)
        for sub_flag, px, py, w, v in (
            (0, px_main, py_main, 1.0 - fpart, valid),
            (1, px_sub, py_sub, fpart, sub_valid),
        ):
            sel = np.nonzero(v)
            segs.append(seg_grid[sel])
            steps.append(k_grid[sel])
            subs.append(np.full(len(sel[0]), sub_flag, dtype=np.int8))
            pxs.append(px[sel])
            pys.append(py[sel])
            ws.append(w[sel])

    lo = 0
    for hi in _WU_BUCKETS:
        idx = np.nonzero((count > lo) & (count <= hi))[0]
        if len(idx):
            m = int(count[idx].max())
            mat = np.empty((len(idx), m), dtype=np.float64)
            mat[:, 0] = b1[idx]
            mat[:, 1:] = grad[idx][:, None]
            ys = np.add.accumulate(mat, axis=1)
            valid = np.arange(m, dtype=np.int64)[None, :] < count[idx][:, None]
            emit(idx, 0, ys, valid)
        lo = hi

    # Long segments: chunked accumulation with an exact carry.
    idx = np.nonzero(count > _WU_BUCKETS[-1])[0]
    if len(idx):
        carry = b1[idx].copy()
        remaining = count[idx].copy()
        k0 = 0
        while np.any(remaining > 0):
            act = np.nonzero(remaining > 0)[0]
            m = int(min(_WU_CHUNK, remaining[act].max()))
            mat = np.empty((len(act), m), dtype=np.float64)
            mat[:, 0] = carry[act]
            mat[:, 1:] = grad[idx[act]][:, None]
            ys = np.add.accumulate(mat, axis=1)
            valid = np.arange(m, dtype=np.int64)[None, :] < remaining[act][:, None]
            emit(idx[act], k0, ys, valid)
            # carry = last value + one more gradient step (exact order)
            carry[act] = ys[:, -1] + grad[idx[act]]
            remaining[act] -= m
            k0 += m

    if not segs:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z.astype(np.int8), z, z, np.zeros(0)
    return (
        np.concatenate(segs),
        np.concatenate(steps),
        np.concatenate(subs),
        np.concatenate(pxs),
        np.concatenate(pys),
        np.concatenate(ws),
    )


def _blend_ordered(
    img: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    sa: np.ndarray,
    color: tuple[int, int, int, int],
) -> None:
    """Alpha-composite ordered hits into ``img`` with ``_blend_pixel``
    semantics.  Hits on distinct pixels are blended as one vector op;
    pixels hit multiple times are processed in collision rounds so each
    pixel sees its blends in the given (reference-sequential) order."""
    keep = sa > 0
    xs, ys, sa = xs[keep], ys[keep], sa[keep]
    if len(xs) == 0:
        return
    width = img.shape[1]
    pix = ys.astype(np.int64) * width + xs
    order = np.argsort(pix, kind="stable")
    spix = pix[order]
    new_group = np.empty(len(spix), dtype=bool)
    new_group[0] = True
    np.not_equal(spix[1:], spix[:-1], out=new_group[1:])
    group_start = np.maximum.accumulate(np.where(new_group, np.arange(len(spix)), 0))
    rank = np.arange(len(spix)) - group_start
    sr, sg_, sb, _ = color
    f32 = np.float32
    for r in range(int(rank.max()) + 1):
        sel = order[rank == r]
        x_r, y_r, sa_r = xs[sel], ys[sel], sa[sel]
        # image crate v0.24 Rgba::<u8>::blend, vectorized: f32 in the
        # normalized 0..1 domain, premultiplied, alpha_final =
        # bg_a + fg_a - bg_a*fg_a, truncating u8 cast (see
        # _blend_pixel).  fg_a == 255 is the crate's full-replace
        # early-out; fg_a == 0 was filtered above.
        dst = img[y_r, x_r].astype(f32) / f32(255.0)
        fa = sa_r.astype(f32) / f32(255.0)
        da = dst[:, 3]
        ao = da + fa - da * fa
        inv = f32(1.0) - fa
        fgc = np.array([sr, sg_, sb], dtype=f32) / f32(255.0)
        out = np.empty_like(dst)
        safe_ao = np.where(ao == 0.0, f32(1.0), ao)
        for c in range(3):
            out[:, c] = (fgc[c] * fa + dst[:, c] * da * inv) / safe_ao
        out[:, 3] = ao
        res = np.clip(np.trunc(out * f32(255.0)), 0.0, 255.0).astype(np.uint8)
        replace = sa_r == 255
        if replace.any():
            res[replace] = np.array([sr, sg_, sb, 255], dtype=np.uint8)
        skip = ao == 0.0
        if skip.any():
            res[skip] = img[y_r, x_r][skip]
        img[y_r, x_r] = res


def _rasterize_segments(
    img: np.ndarray,
    x1: np.ndarray,
    y1: np.ndarray,
    x2: np.ndarray,
    y2: np.ndarray,
    color: tuple[int, int, int, int],
) -> None:
    """Cull, Wu-rasterize and blend a batch of projected segments,
    reproducing the reference's per-segment sequential semantics
    (map.rs:113-128) including its redundant first-endpoint guard."""
    h = img.shape[0]
    vis = (
        ((x1 > -456.0) & (x1 < 456.0) & (y1 > 0.0) & (y1 < h))
        | ((x1 > -600.0) & (x1 < 600.0) & (y1 > 0.0) & (y1 < h))
    )
    if not np.any(vis):
        return
    seg, step, sub, px, py, w = _wu_batch(x1[vis], y1[vis], x2[vis], y2[vis])
    # Restore exact sequential emission order: segment, then step, then
    # main-before-fractional pixel.
    order = np.lexsort((sub, step, seg))
    px, py, w = px[order], py[order], w[order]
    clip = (px > -X_CLIP) & (px < X_CLIP) & (py > 0) & (py < h)
    px, py, w = px[clip], py[clip], w[clip]
    sa = (w * color[3]).astype(np.int64)  # int(value * a): truncation
    # The two channel copies target disjoint x ranges (539±455 vs
    # 1579±455), so blending all A hits then all B hits preserves each
    # pixel's blend order.
    _blend_ordered(img, px + CH_A_OFFSET, py, sa, color)
    _blend_ordered(img, px + CH_B_OFFSET, py, sa, color)


def draw_map(
    img: np.ndarray,
    ref_time: RefTime,
    settings: MapSettings,
    sat_name: SatName,
    tle: str,
    strict: bool = False,
) -> None:
    """Draw country/state/lake vectors over the image, in place."""
    log.info("Drawing map overlay")
    height = img.shape[0]

    sat = sg.find_satellite(sg.parse_tle(tle), sat_name.to_string())
    sat_positions = ground_track(sat, ref_time, height)
    start_latlon = sat_positions[0]
    end_latlon = sat_positions[-1]

    y_res = distance(start_latlon, end_latlon) / height / settings.vscale
    x_res = 0.0005 / settings.hscale
    ref_az = azimuth(start_latlon, end_latlon)

    sat_arr = np.asarray(sat_positions)
    row_offsets, _ = _project_batch(
        sat_arr[:, 0], sat_arr[:, 1], start_latlon, ref_az, x_res, y_res, settings.yaw
    )
    h = height

    def draw_shapefile(name, color):
        if name == "states.shp":
            # Not vendored (2 MB, absent upstream too): resolved via
            # the cached auto-fetch (geo/states.py) so `-m yes` draws
            # states out of the box like map.rs:135-140.
            from .states import get_states_shp

            path = get_states_shp()
            if path is None:
                if strict:
                    raise err.InternalError("states.shp unavailable")
                return
        else:
            path = res_path("shapefiles", name)
        try:
            parts = read_parts(path)
        except err.InternalError:
            if strict:
                raise
            log.warning("Shapefile %s not found, skipping its overlay layer", path)
            return
        if not parts:
            return
        # Segment i of a part runs CURRENT point -> PREVIOUS point with
        # prev[0] = pts[0] (map.rs:160-170: the first segment is the
        # degenerate pts[0]->pts[0], drawn as a dot).
        pts = np.concatenate(parts)  # [N, 2] (lon_deg, lat_deg)
        starts = np.cumsum([0] + [len(p) for p in parts[:-1]])
        prev_idx = np.arange(len(pts)) - 1
        prev_idx[starts] = starts
        lat = pts[:, 1] * (PI / 180.0)
        lon = pts[:, 0] * (PI / 180.0)
        x, y = _project_batch(lat, lon, start_latlon, ref_az, x_res, y_res, settings.yaw)
        # Per-line X-offset correction at the estimated row (map.rs:106-110).
        est_y = np.minimum(np.maximum(y, 0.0).astype(np.int64), h - 1)
        x = x - row_offsets[est_y]
        _rasterize_segments(img, x, y, x[prev_idx], y[prev_idx], color)

    draw_shapefile("states.shp", settings.states_color)
    draw_shapefile("countries.shp", settings.countries_color)
    draw_shapefile("lakes.shp", settings.lakes_color)
