"""High-level post-processing orchestration (contrast -> image ->
false color -> equalize -> rotate).

Behavioral contract: reference ``src/noaa_apt.rs:132-243``
(``process()``), as ``noaa_apt_tpu/graph/process.py`` ports it.  The map
overlay and the orbit-based rotation wait for the slice that ports
``geo/`` and raise here.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import PX_PER_ROW, err
from ..post import contrast as ct
from ..post import processing
from ..post.telemetry import read_telemetry, telemetry_from_stats
from ..types import Contrast, ContrastKind, Rotate
from .decode import Decoder, DecodeResult

log = logging.getLogger(__name__)


def process(signal, contrast_adjustment: Contrast, rotate: Rotate, color=None, orbit=None,
            context=None) -> np.ndarray:
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
        if kind == ContrastKind.HISTOGRAM:
            # Histogram equalization happens on the u8 image below; the
            # levels here are min/max, or the reference's 98% pre-stretch
            # for colorized runs (noaa_apt.rs:167-176).
            if color is not None:
                gray = Decoder.render_u8(result, "percent", 0.98)
            else:
                gray = Decoder.render_u8(result, "minmax")
        else:
            gray = Decoder.render_u8(
                result,
                "percent" if kind == ContrastKind.PERCENT else "minmax",
                contrast_adjustment.percent,
            )
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
                 orbit=None, context=None) -> np.ndarray:
    """Contrast-mapped u8 rows [H, 2080] -> RGBA image [H, 2080, 4]:
    colorize, equalize, rotate (the tail of reference ``process()``,
    noaa_apt.rs:186-243).  Shared by :func:`process` and the fused path
    (``Decoder.decode_render_input`` produces ``gray``)."""
    if orbit is not None:
        raise err.InternalError("orbit settings (map overlay) are not ported yet")
    if rotate == Rotate.ORBIT:
        raise err.InternalError("orbit-based rotation is not ported yet")
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

    if rotate == Rotate.YES:
        if context is not None:
            context.status(0.90, "Rotating output image")
        processing.rotate(img)
    return img
