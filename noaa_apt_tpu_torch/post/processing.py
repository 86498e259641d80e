"""Image post-processing: rotate, histogram equalization, false color.

Behavioral contract: reference ``src/processing.rs``, as
``noaa_apt_tpu/post/processing.py`` ports it (a copy).  Images are RGBA
uint8 arrays of shape [H, 2080, 4] (the reference's RgbaImage).
Palettes are read with the port's own PNG reader (``io/png.read_png``),
since the machine with the card has no PIL.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import (
    PX_CHANNEL_IMAGE_DATA,
    PX_PER_CHANNEL,
    PX_SPACE_DATA,
    PX_SYNC_FRAME,
    err,
)
from ..io import png
from . import imageext

log = logging.getLogger(__name__)

_X_OFFSET = PX_SYNC_FRAME + PX_SPACE_DATA  # 86: image data start per channel


def rotate(img: np.ndarray) -> None:
    """180-degree rotate the two channel image areas in place, leaving
    sync/space/telemetry columns untouched (processing.rs:21-37)."""
    log.info("Rotating image")
    for x0 in (_X_OFFSET, _X_OFFSET + PX_PER_CHANNEL):
        sub = img[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA]
        img[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA] = sub[::-1, ::-1]


def histogram_equalization(img: np.ndarray, has_color: bool) -> None:
    """Per-channel (A then B) equalization in place; A is color-aware,
    B always grayscale (processing.rs:87-103)."""
    log.info("Performing histogram equalization, has color: %s", has_color)
    a = img[:, :PX_PER_CHANNEL]
    if has_color:
        imageext.equalize_histogram_color(a)
    else:
        imageext.equalize_histogram_grayscale(a)
    b = img[:, PX_PER_CHANNEL : 2 * PX_PER_CHANNEL]
    imageext.equalize_histogram_grayscale(b)


def false_color(img: np.ndarray, color_settings) -> None:
    """Colorize channel A from a 256x256 palette keyed by (channel A,
    channel B) brightness (processing.rs:108-157), in place."""
    palette = _load_palette(color_settings.palette_filename)

    x_start = _X_OFFSET
    x_end = x_start + PX_CHANNEL_IMAGE_DATA

    factor = np.float32(0.3)
    s_a = np.float32(color_settings.ch_a_tune_start) * factor
    e_a = np.float32(color_settings.ch_a_tune_end) * factor
    s_b = np.float32(color_settings.ch_b_tune_start) * factor
    e_b = np.float32(color_settings.ch_b_tune_end) * factor

    in_a = img[:, x_start:x_end, 0].astype(np.float32)
    in_b = img[:, x_start + PX_PER_CHANNEL : x_end + PX_PER_CHANNEL, 0].astype(np.float32)
    out_a = in_a * (np.float32(1.0) + e_a - s_a) - s_a * np.float32(255.0)
    out_b = in_b * (np.float32(1.0) + e_b - s_b) - s_b * np.float32(255.0)
    # Rust clamp then `as u32` truncates toward zero.
    val_a = np.trunc(np.clip(out_a, 0.0, 255.0)).astype(np.int64)
    val_b = np.trunc(np.clip(out_b, 0.0, 255.0)).astype(np.int64)

    # palette.get_pixel(x=val_a, y=val_b) -> array[val_b, val_a]
    img[:, x_start:x_end, :3] = palette[val_b, val_a]
    img[:, x_start:x_end, 3] = 255


def _load_palette(palette_filename) -> np.ndarray:
    """Load and validate a 256x256 RGB palette image: grey is spread to
    RGB and alpha dropped, as PIL's ``convert("RGB")`` does."""
    try:
        p = png.read_png(palette_filename)
    except err.InvalidInputError:
        raise err.InvalidInputError(f"Could not load {palette_filename!r}")
    if p.shape[0] != 256 or p.shape[1] != 256:
        raise err.InvalidInputError("Invalid palette image dimensions")
    return np.repeat(p, 3, axis=2) if p.shape[2] == 1 else p[..., :3]
