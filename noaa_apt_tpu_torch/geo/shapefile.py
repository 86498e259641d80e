"""Minimal ESRI shapefile (.shp) reader for polylines and polygons.

The reference uses the ``shapefile`` crate to read Natural Earth
countries/states/lakes vectors (``map.rs:135-197``).  This reads the
same format directly: the 100-byte header and Polyline (type 3) /
Polygon (type 5) records, returning each part/ring as an Nx2 array of
(lon_deg, lat_deg).

A copy of ``noaa_apt_tpu/geo/shapefile.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .. import err

SHAPE_NULL = 0
SHAPE_POLYLINE = 3
SHAPE_POLYGON = 5


def read_parts(path) -> list[np.ndarray]:
    """All parts/rings of all shapes in the file, each [N, 2] float64
    (x=lon deg, y=lat deg)."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError:
        raise err.InternalError(f'Could not load "{path}"')
    if len(data) < 100:
        raise err.InternalError(f'Could not load "{path}"')
    (file_code,) = struct.unpack_from(">i", data, 0)
    if file_code != 9994:
        raise err.InternalError(f'Could not load "{path}"')

    parts_out: list[np.ndarray] = []
    off = 100
    n = len(data)
    while off + 8 <= n:
        _, content_len = struct.unpack_from(">ii", data, off)
        off += 8
        rec_end = off + content_len * 2
        if rec_end > n:
            break
        (shape_type,) = struct.unpack_from("<i", data, off)
        if shape_type in (SHAPE_POLYLINE, SHAPE_POLYGON):
            num_parts, num_points = struct.unpack_from("<ii", data, off + 36)
            parts_idx = np.frombuffer(data, dtype="<i4", count=num_parts, offset=off + 44)
            pts = np.frombuffer(
                data, dtype="<f8", count=num_points * 2, offset=off + 44 + 4 * num_parts
            ).reshape(num_points, 2)
            bounds = list(parts_idx) + [num_points]
            for i in range(num_parts):
                parts_out.append(pts[bounds[i] : bounds[i + 1]])
        off = rec_end
    return parts_out


def write_parts(path, parts: list[np.ndarray], shape_type: int = SHAPE_POLYLINE) -> None:
    """Write a minimal .shp (used by tests and the resource generator)."""
    records = b""
    for rec_no, pts in enumerate(parts, start=1):
        pts = np.asarray(pts, dtype="<f8")
        content = struct.pack("<i", shape_type)
        xs, ys = pts[:, 0], pts[:, 1]
        content += struct.pack("<4d", xs.min(), ys.min(), xs.max(), ys.max())
        content += struct.pack("<ii", 1, len(pts))
        content += struct.pack("<i", 0)
        content += pts.tobytes()
        records += struct.pack(">ii", rec_no, len(content) // 2) + content

    total_words = (100 + len(records)) // 2
    hdr = struct.pack(">i", 9994) + b"\x00" * 20 + struct.pack(">i", total_words)
    hdr += struct.pack("<ii", 1000, shape_type)
    allpts = np.concatenate([np.asarray(p) for p in parts]) if parts else np.zeros((1, 2))
    hdr += struct.pack(
        "<8d",
        allpts[:, 0].min(), allpts[:, 1].min(), allpts[:, 0].max(), allpts[:, 1].max(),
        0.0, 0.0, 0.0, 0.0,
    )
    Path(path).write_bytes(hdr + records)
