"""Timestamps and filename-based time/satellite inference.

Behavioral contract: reference ``src/misc.rs:177-385`` — file mtime
read/write and the mini-format filename parser
(``%Y%m%d%H%M%S %N %! %1-%9``) with the reference's exact fallback
chain: try every configured format, else mtime + NOAA 19; and the
update check against the project site (misc.rs:66-90).

A copy of ``noaa_apt_tpu/io/misc.py``.
"""

from __future__ import annotations

import logging
import os
from datetime import datetime, timedelta, timezone
from pathlib import Path
from typing import Optional

from .. import err
from ..types import RefTime, SatName

log = logging.getLogger(__name__)


def read_timestamp(filename) -> int:
    """File mtime as Unix seconds (misc.rs:181-194)."""
    try:
        return int(os.stat(filename).st_mtime)
    except OSError as e:
        raise err.InternalError(f"Could not read metadata from input file: {e}")


def write_timestamp(timestamp: int, filename) -> None:
    """Set file mtime (misc.rs:200-205)."""
    try:
        os.utime(filename, (timestamp, timestamp))
    except OSError:
        raise err.InternalError("Could not write timestamp to file")


def parse_version(v: str):
    """Semver 2.0 sort key for ``MAJOR.MINOR.PATCH[-PRE][+BUILD]``.

    The reference compares released versions with the ``semver`` crate
    (misc.rs:66-90), so tags like ``1.5.0-beta`` must parse and order
    below ``1.5.0``.  Build metadata is ignored; pre-release
    identifiers compare numerically when numeric, lexically otherwise,
    numeric before alphanumeric, fewer identifiers first.
    """
    core, _, pre = v.strip().split("+", 1)[0].partition("-")
    nums = tuple(int(x) for x in core.split("."))
    if len(nums) != 3:
        raise ValueError(f"not a semver version: {v!r}")
    if pre:
        ids = tuple(
            (0, int(p), "") if p.isdigit() else (1, 0, p) for p in pre.split(".")
        )
        return (*nums, 0, ids)
    return (*nums, 1, ())


def check_updates(current: str) -> tuple[bool, str] | None:
    """Check the project site for a newer release (misc.rs:66-90).

    Returns (newer_available, latest_version) or None on any failure
    (logged, never fatal).
    """
    try:
        from urllib.request import urlopen

        addr = f"https://noaa-apt.mbernardi.com.ar/version_check?{current}"
        with urlopen(addr, timeout=10) as r:
            latest = r.read().decode().rstrip("\n")

        return parse_version(latest) > parse_version(current), latest
    except Exception as e:
        log.warning("Error checking for updates: %s", e)
        return None


_FREQ_REFERENCES = [
    (137_620_000, SatName.NOAA_15),
    (137_912_500, SatName.NOAA_18),
    (137_100_000, SatName.NOAA_19),
]


def _closest_freq(freq: int) -> SatName:
    best = _FREQ_REFERENCES[0]
    for r in _FREQ_REFERENCES:
        if abs(freq - r[0]) < abs(freq - best[0]):
            best = r
    return best[1]


def parse_filename(filename: str, fmt: str, tz: timezone) -> Optional[tuple[RefTime, SatName]]:
    """Parse one filename against one format (misc.rs:210-348).

    Returns None on any mismatch.  Missing date/time fields default to
    the current time's fields in ``tz``.
    """
    now = datetime.now(tz)
    year, month, day = now.year, now.month, now.day
    hour, minute, second = now.hour, now.minute, now.second
    sat = SatName.NOAA_19

    fi = 0  # filename index
    i = 0  # format index
    n = len(filename)
    while i < len(fmt):
        c = fmt[i]
        i += 1
        if c != "%":
            if fi >= n or filename[fi] != c:
                return None
            fi += 1
            continue
        if i >= len(fmt):
            return None  # format ended with %
        spec = fmt[i]
        i += 1

        def take(k: int) -> Optional[str]:
            nonlocal fi
            if fi + k > n:
                return None
            s = filename[fi : fi + k]
            fi += k
            return s

        if spec == "Y":
            s = take(4)
            if s is None or not s.isdigit():
                return None
            year = int(s)
        elif spec in "mdHMS":
            s = take(2)
            if s is None or not s.isdigit():
                return None
            v = int(s)
            if spec == "m":
                month = v
            elif spec == "d":
                day = v
            elif spec == "H":
                hour = v
            elif spec == "M":
                minute = v
            else:
                second = v
        elif spec == "N":
            s = take(2)
            if s is None or not s.isdigit():
                return None
            sat = {15: SatName.NOAA_15, 18: SatName.NOAA_18, 19: SatName.NOAA_19}.get(int(s))
            if sat is None:
                return None
        elif spec == "!":
            s = take(9)
            if s is None or not s.isdigit():
                return None
            sat = _closest_freq(int(s))
        elif spec.isdigit():
            # Reference skip() advances a char iterator with next(),
            # which is a no-op past the end (misc.rs:216-220) — a skip
            # larger than the remaining filename still succeeds.
            fi = min(n, fi + int(spec))
        else:
            return None  # invalid format option

    try:
        t = datetime(year, month, day, hour, minute, second, tzinfo=tz)
    except ValueError:
        return None
    return RefTime.start(t.astimezone(timezone.utc)), sat


def infer_time_sat(settings, path) -> tuple[RefTime, SatName]:
    """Reference ``misc::infer_time_sat`` (misc.rs:351-385)."""
    path = Path(path)
    filename = path.name
    if settings.prefer_timestamps:
        return (
            RefTime.end(datetime.fromtimestamp(read_timestamp(path), tz=timezone.utc)),
            SatName.NOAA_19,
        )
    tz = timezone(timedelta(hours=settings.filename_timezone))
    for fmt in settings.filename_formats:
        result = parse_filename(filename, fmt, tz)
        if result is not None:
            return result
    log.warning("Could not parse date and time from filename %s, using timestamp", filename)
    return (
        RefTime.end(datetime.fromtimestamp(read_timestamp(path), tz=timezone.utc)),
        SatName.NOAA_19,
    )
