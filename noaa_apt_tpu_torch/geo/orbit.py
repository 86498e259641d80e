"""Orbit-derived decisions: pass direction and per-line ground track.

Behavioral contract: reference ``src/processing.rs:40-81``
(``south_to_north_pass``) and ``src/map.rs:43-65`` (per-line satellite
positions at 2 lines/s).

A copy of ``noaa_apt_tpu/geo/orbit.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import math
from datetime import timedelta

from ..types import OrbitSettings, RefTime
from . import sgp4 as sg
from .geometry import azimuth


def _resolve_tle(orbit_settings: OrbitSettings) -> str:
    if orbit_settings.custom_tle is not None:
        return orbit_settings.custom_tle
    from .tle import get_current_tle

    return get_current_tle()


def south_to_north_pass(orbit_settings: OrbitSettings) -> bool:
    """True if the pass is northbound (image needs rotation),
    processing.rs:40-81: compare azimuth of 2 s of motion vs North.

    Replicated exactly, including the reference's quirk: the condition
    ``az < pi/4 or az > 3*pi/4`` over azimuth in (-pi, pi] is true for
    ALL westward-component headings — and NOAA orbits are retrograde, so
    every 2-second ground-track azimuth is negative and v1.4.1's auto
    mode rotates both ascending and descending passes.  We match the
    reference bit-for-bit; a corrected classifier would use ``|az|``.
    """
    tle = _resolve_tle(orbit_settings)
    sat = sg.find_satellite(sg.parse_tle(tle), orbit_settings.sat_name.to_string())

    start_time = orbit_settings.ref_time.time
    start_pos = sg.satellite_latlon(sat, start_time)
    end_pos = sg.satellite_latlon(sat, start_time + timedelta(seconds=2))
    az = azimuth(start_pos, end_pos)
    return az < math.pi / 4.0 or az > 3.0 * math.pi / 4.0


def ground_track(sat: sg.Satrec, ref_time: RefTime, height: int) -> list[tuple[float, float]]:
    """(lat, lon) of the satellite for each image line (map.rs:43-58);
    lines are 500 ms apart."""
    line = timedelta(milliseconds=500)
    if ref_time.kind == "start":
        start_time = ref_time.time
    else:
        start_time = ref_time.time - line * height
    return [sg.satellite_latlon(sat, start_time + line * i) for i in range(height)]
