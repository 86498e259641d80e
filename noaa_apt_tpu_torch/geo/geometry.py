"""Spherical trigonometry for georeferencing.

Behavioral contract: reference ``src/geo.rs`` (great-circle distance,
azimuth, reckon — spherical formulas; all angles in radians).

A copy of ``noaa_apt_tpu/geo/geometry.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import math

PI = math.pi


def distance(latlon1: tuple[float, float], latlon2: tuple[float, float]) -> float:
    """Great-circle central angle between two points (geo.rs:35-45)."""
    lat1, lon1 = latlon1
    lat2, lon2 = latlon2
    delta_lon = lon2 - lon1
    cos_central = (
        math.sin(lat1) * math.sin(lat2)
        + math.cos(lat1) * math.cos(lat2) * math.cos(delta_lon)
    )
    cos_central = min(1.0, max(-1.0, cos_central))
    return math.acos(cos_central)


def azimuth(latlon1: tuple[float, float], latlon2: tuple[float, float]) -> float:
    """Bearing of the segment from point 1 to point 2 vs North
    (geo.rs:53-61)."""
    lat1, lon1 = latlon1
    lat2, lon2 = latlon2
    delta_lon = lon2 - lon1
    return math.atan2(
        math.sin(delta_lon),
        math.cos(lat1) * math.tan(lat2) - math.sin(lat1) * math.cos(delta_lon),
    )


def reckon(latlon: tuple[float, float], rng: float, az: float) -> tuple[float, float]:
    """End point of a great-circle displacement (geo.rs:74-98)."""
    lat, lon = latlon
    tmp = math.sin(lat) * math.cos(rng) + math.cos(lat) * math.sin(rng) * math.cos(az)
    tmp = min(1.0, max(-1.0, tmp))
    lato = PI / 2 - math.acos(tmp)
    cos_y = (math.cos(rng) - math.sin(lato) * math.sin(lat)) / (
        math.cos(lato) * math.cos(lat)
    )
    sin_y = math.sin(az) * math.sin(rng) / math.cos(lato)
    y = math.atan2(sin_y, cos_y)
    lono = lon + y
    # Rust % is fmod (sign of the dividend), not Python's floored mod:
    # for lono + PI < 0 the reference stays negative (its documented
    # out-of-range quirk, geo.rs:95) — keep that behavior.
    lono = math.fmod(lono + PI, 2 * PI) - PI
    return lato, lono
