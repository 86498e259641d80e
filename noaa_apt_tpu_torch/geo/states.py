"""Out-of-the-box ``states.shp`` acquisition for the map overlay.

The reference draws three layers — states, countries, lakes
(``map.rs:135-141``) — but ships no ``states.shp`` in its checkout
(countries/lakes are vendored here; states is a 2 MB download).  To
make ``-m yes`` draw states without a manual tool step, the overlay
asks this module for the file: vendored copy first, then a per-user
disk cache, then a one-time download from Natural Earth (public
domain), cached forever — the same acquire-with-disk-cache pattern as
the TLE fetch (``geo/tle.py``, mirroring ``misc.rs:388-484``).
Offline hosts skip the layer with a warning — deliberately SOFTER than
the reference, which fails the whole decode with ``Error::Internal``
when a shapefile is missing (``map.rs:135-137`` unwraps the open via
``?``): a missing optional overlay layer should not kill a decode.

Entry points that know a map overlay is coming can call
:func:`prefetch_states_async` so the download (bounded by a 15 s
timeout) overlaps decode instead of stalling the decode/GUI thread.

A copy of ``noaa_apt_tpu/geo/states.py`` (the port imports nothing of
the JAX package); the tests hold the two equal.
"""

from __future__ import annotations

import io
import logging
import threading
import zipfile
from pathlib import Path
from typing import Optional

from ..io.config import config_dir, res_path

log = logging.getLogger(__name__)

# The 10m admin-1 boundary-lines layer, same Natural Earth scale as the
# vendored countries/lakes layers.
URL = (
    "https://naciscdn.org/naturalearth/10m/cultural/"
    "ne_10m_admin_1_states_provinces_lines.zip"
)

# Once a download fails this process, don't re-try on every decoded
# pass (a fleet run over an offline link would otherwise pay one
# timeout + warning per recording).
_download_failed = [False]
_dl_lock = threading.Lock()


def download_states_shp(dest: Path) -> Path:
    """Fetch the Natural Earth admin-1 lines zip and install the .shp
    member at ``dest``.  Raises OSError/ValueError on failure."""
    from urllib.request import urlopen

    log.info("Downloading states overlay layer from %s", URL)
    # 15 s, not minutes: this can run on the decode (or GUI) thread, so
    # a half-open connection must fail fast into the skip-layer path;
    # slow-but-healthy hosts can prefetch asynchronously.
    blob = urlopen(URL, timeout=15).read()
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        members = [n for n in z.namelist() if n.endswith(".shp")]
        if not members:
            raise ValueError("no .shp member in the Natural Earth archive")
        data = z.read(members[0])
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(".shp.part")
    tmp.write_bytes(data)
    tmp.replace(dest)
    log.info("Cached states.shp at %s (%d bytes)", dest, len(data))
    return dest


_prefetch_thread = [None]


def prefetch_states_async() -> None:
    """Resolve (and, if needed, download) states.shp in a daemon thread.

    Call at entry-point startup when a map overlay is requested so the
    one-time download overlaps WAV load/decode instead of stalling the
    decode thread (the ``warm_link_async`` pattern).  Idempotent; any
    failure is memoized exactly as in the synchronous path."""
    if _prefetch_thread[0] is not None:
        return
    t = threading.Thread(target=get_states_shp, daemon=True, name="states-prefetch")
    _prefetch_thread[0] = t
    t.start()


def get_states_shp(allow_download: bool = True) -> Optional[Path]:
    """Resolve states.shp: vendored -> user cache -> download+cache.

    Returns None (caller skips the layer, warning already logged) when
    the file is nowhere to be found and cannot be fetched.
    """
    vendored = res_path("shapefiles", "states.shp")
    if vendored.exists():
        return vendored
    cached = config_dir() / "states.shp"
    if cached.exists():
        return cached
    if not allow_download or _download_failed[0]:
        return None
    try:
        with _dl_lock:
            # The prefetch thread and a decode thread can race here;
            # whoever wins downloads, the other sees the cached file.
            if cached.exists():
                return cached
            return download_states_shp(cached)
    except Exception as e:  # noqa: BLE001 — offline/404 must not kill a decode
        _download_failed[0] = True  # don't re-try (and re-warn) every pass
        log.warning(
            "states.shp unavailable (download failed: %s); skipping the "
            "states overlay layer.  Install it manually: copy the .shp of "
            "%s to %s.", e, URL, cached,
        )
        return None
