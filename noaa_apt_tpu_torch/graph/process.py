"""High-level post-processing orchestration (contrast -> image ->
false color -> equalize -> map overlay -> rotate).

Behavioral contract: reference ``src/noaa_apt.rs:132-243``
(``process()``), as ``noaa_apt_tpu/graph/process.py`` ports it.  The map
overlay and the orbit-based rotation run on the host (``geo/``).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import PX_PER_ROW, err
from ..geo import tle as tle_mod
from ..geo.map_overlay import draw_map
from ..geo.orbit import south_to_north_pass
from ..post import contrast as ct
from ..post import processing
from ..post.telemetry import read_telemetry, telemetry_from_stats
from ..types import Contrast, ContrastKind, OrbitSettings, Rotate
from .decode import Decoder, DecodeResult

log = logging.getLogger(__name__)


def device_levels(contrast: Contrast, color=None) -> tuple[str, float]:
    """The device levels ``(kind, pct)`` that render ``contrast``, with
    or without ``color`` (``noaa_apt.rs:144-176``): the percent scan for
    percent contrast and for a colorized histogram run (the reference's
    98 % pre-stretch; histogram equalization runs on the u8 image), the
    telemetry wedges for telemetry, else min/max."""
    if contrast.kind == ContrastKind.PERCENT:
        return "percent", contrast.percent
    if contrast.kind == ContrastKind.HISTOGRAM and color is not None:
        return "percent", 0.98
    if contrast.kind == ContrastKind.TELEMETRY:
        return "telemetry", 0.98
    return "minmax", 0.98


def process(signal, contrast_adjustment: Contrast, rotate: Rotate, color=None,
            orbit: OrbitSettings | None = None, context=None) -> np.ndarray:
    """Decoded signal -> RGBA uint8 image [H, 2080, 4].

    ``signal`` may be a flat float array (reference API, e.g. a ``.npy``
    from ``--raw-out``), whose levels and u8 map run in numpy, or a
    :class:`~noaa_apt_tpu_torch.graph.decode.DecodeResult`, whose levels
    and u8 map run on the device its image lies on; only the u8 image
    (and, for telemetry, the band statistics) comes back to the host."""
    result = signal if isinstance(signal, DecodeResult) else None
    kind = contrast_adjustment.kind

    if result is not None and kind != ContrastKind.TELEMETRY:
        if context is not None:
            context.status(0.1, "Adjusting contrast (on device)")
            context.status(0.3, "Generating image")
        gray = Decoder.render_u8(result, *device_levels(contrast_adjustment, color))
    elif result is not None:
        if context is not None:
            context.status(0.1, "Adjusting contrast from telemetry")
        ma, mb, var = Decoder.telemetry_stats(result)
        telemetry = telemetry_from_stats(ma, mb, var, context)
        low = telemetry.get_wedge_value(9, None)
        high = telemetry.get_wedge_value(8, None)
        if context is not None:
            context.status(0.3, "Generating image")
        gray = Decoder.render_u8_levels(result, low, high)
    else:
        signal = np.asarray(signal, np.float32).reshape(-1)
        if kind == ContrastKind.TELEMETRY:
            if context is not None:
                context.status(0.1, "Adjusting contrast from telemetry")
            telemetry = read_telemetry(signal, context)
            low = telemetry.get_wedge_value(9, None)
            high = telemetry.get_wedge_value(8, None)
        elif kind == ContrastKind.PERCENT:
            if context is not None:
                context.status(
                    0.1, f"Adjusting contrast using {contrast_adjustment.percent * 100} percent"
                )
            low, high = ct.percent(signal, contrast_adjustment.percent)
        elif color is not None and kind == ContrastKind.HISTOGRAM:
            # For colorization with histogram equalization, do a 98%
            # contrast stretch first (noaa_apt.rs:167-176) — the minmax
            # scan below would be discarded.
            if context is not None:
                context.status(0.1, "Mapping values")
            low, high = ct.percent(signal, 0.98)
        else:  # MINMAX or grayscale HISTOGRAM
            if context is not None:
                context.status(0.1, "Mapping values")
            low, high = ct.min_max(signal)

        if context is not None:
            context.status(0.3, "Generating image")

        height = signal.shape[0] // PX_PER_ROW
        if height * PX_PER_ROW != signal.shape[0]:
            raise err.InternalError("Could not create image, wrong buffer length")

        gray = ct.map_signal_u8(signal, low, high).reshape(height, PX_PER_ROW)
    return finish_image(gray, kind, rotate, color, orbit, context)


def finish_image(gray: np.ndarray, kind: ContrastKind, rotate: Rotate, color=None,
                 orbit: OrbitSettings | None = None, context=None) -> np.ndarray:
    """Contrast-mapped u8 rows [H, 2080] -> RGBA image [H, 2080, 4]:
    colorize, equalize, overlay, rotate (the tail of reference
    ``process()``, noaa_apt.rs:186-243).  Shared by :func:`process` and
    the fused path (``Decoder.decode_render_input`` produces ``gray``)."""
    height = gray.shape[0]
    img = np.empty((height, PX_PER_ROW, 4), dtype=np.uint8)
    img[..., 0] = gray
    img[..., 1] = gray
    img[..., 2] = gray
    img[..., 3] = 255

    if color is not None:
        processing.false_color(img, color)

    if kind == ContrastKind.HISTOGRAM:
        processing.histogram_equalization(img, color is not None)

    if orbit is not None and orbit.draw_map is not None:
        if context is not None:
            context.status(0.5, "Drawing map")
        tle = orbit.custom_tle if orbit.custom_tle is not None else tle_mod.get_current_tle()
        draw_map(img, orbit.ref_time, orbit.draw_map, orbit.sat_name, tle)

    if rotate == Rotate.YES:
        if context is not None:
            context.status(0.90, "Rotating output image")
        processing.rotate(img)
    elif rotate == Rotate.ORBIT:
        if orbit is not None:
            if south_to_north_pass(orbit):
                if context is not None:
                    context.status(0.90, "Rotating output image")
                processing.rotate(img)
        else:
            log.warning("Can't rotate automatically if no orbit information is provided")
    return img
