"""Procedural false-color palette fallback.

A copy of ``noaa_apt_tpu/post/palette.py`` that saves through the port's
own PNG writer.  The reference ships 22 palette PNGs (``res/palettes/``,
keyed X = channel-A brightness, Y = channel-B brightness;
``processing.rs:108``).  The port keeps its own copy of the set in
``noaa_apt_tpu_torch/res/palettes/`` and uses it directly; this module
synthesizes a compatible daylight palette only as a fallback for
stripped installs without the resource directory.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..io import png
from ..io.config import res_path

log = logging.getLogger(__name__)


def generate_daylight_palette() -> np.ndarray:
    """[256, 256, 3] u8: X = visible (ch A), Y = IR brightness (ch B;
    brighter = colder).  Water/land from the visible level, cloud
    whiteness from the IR level."""
    a = np.linspace(0.0, 1.0, 256)[None, :]  # visible brightness (x)
    b = np.linspace(0.0, 1.0, 256)[:, None]  # IR brightness (y)

    # Base surface color from visible brightness: deep water -> coastal
    # water -> vegetation -> land -> bright desert.
    stops = np.array(
        [
            [0.00, 4, 11, 59],
            [0.18, 10, 48, 106],
            [0.30, 28, 95, 66],
            [0.45, 56, 114, 52],
            [0.60, 116, 121, 68],
            [0.75, 158, 138, 96],
            [1.00, 206, 195, 165],
        ]
    )
    base = np.zeros((256, 256, 3))
    av = np.broadcast_to(a, (256, 256))
    for c in range(3):
        base[..., c] = np.interp(av, stops[:, 0], stops[:, c + 1])

    # Cloud cover: cold IR (high b) whitens toward the visible level.
    cloudiness = np.clip((np.broadcast_to(b, (256, 256)) - 0.55) / 0.45, 0.0, 1.0) ** 1.5
    white = 140.0 + 115.0 * av
    out = base * (1.0 - cloudiness[..., None]) + white[..., None] * cloudiness[..., None]
    return np.clip(out, 0, 255).astype(np.uint8)


def ensure_default_palette(path: Path | None = None) -> Path:
    """Create the default palette PNG if absent; returns its path."""
    if path is None:
        path = res_path("palettes", "noaa-apt-daylight.png")
    path = Path(path)
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        png.write_png(path, generate_daylight_palette())
        log.info("Generated default false-color palette at %s", path)
    return path
