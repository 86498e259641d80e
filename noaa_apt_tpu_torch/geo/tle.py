"""TLE acquisition: 7-day disk cache + celestrak download.

Behavioral contract: reference ``src/misc.rs:388-484``.  The offline
path (``--tle FILE``) is first-class so decode works with zero network;
downloads use urllib only when needed.

A copy of ``noaa_apt_tpu/geo/tle.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import logging
import time

from .. import err
from ..io.config import config_dir

log = logging.getLogger(__name__)

TLE_URL = "https://celestrak.org/NORAD/elements/weather.txt"
CACHE_SECONDS = 7 * 24 * 3600


def _download_tle(addr: str = TLE_URL) -> str:
    try:
        from urllib.request import urlopen

        with urlopen(addr, timeout=30) as r:
            return r.read().decode()
    except Exception as e:
        log.error("%s", e)
        raise err.RequestError(
            "Unable to download satellite TLE data. Connect to internet, "
            "provide a custom TLE, or disable image rotation and map overlay."
        )


def get_current_tle() -> str:
    """Cached-or-downloaded weather TLE (misc.rs:434-484)."""
    cache = config_dir() / "weather.txt"
    try:
        age = time.time() - cache.stat().st_mtime
        if age < CACHE_SECONDS:
            log.info("Found recent cached TLE")
            return cache.read_text()
        log.info("Found outdated cached TLE, downloading new TLE")
    except OSError:
        log.warning("Unable to read cached TLE, downloading and caching new TLE")

    tle = _download_tle()
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(tle)
    except OSError as e:
        log.error("Could not cache TLE at %s: %s", cache, e)
    return tle
