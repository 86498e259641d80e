"""GUI helper functions.

Behavioral contract: reference ``src/gui/misc.rs`` — progress setter,
info bar, threaded update check, browser opener, preview scaling.

A copy of ``noaa_apt_tpu/gui/misc.py``, except that :func:`scale_preview`
resamples in numpy (the port needs no PIL), byte for byte as Pillow's
bilinear ``Image.resize`` does.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from .. import err
from .state import borrow_state, borrow_widgets

log = logging.getLogger(__name__)


def set_progress(fraction: float, description: str) -> None:
    """Set the main progress bar (gui/misc.rs:13-18)."""
    borrow_widgets().progress.set(fraction, description)


def show_info(kind: str, text: str) -> None:
    """Reveal the info bar with a message (gui/misc.rs:21-37)."""
    borrow_widgets().info.show(kind, text)


def check_updates_and_show(version: str) -> threading.Thread:
    """Check for updates on another thread and show the result
    (gui/misc.rs:42-67)."""
    from ..io.misc import check_updates

    widgets = borrow_widgets()

    def callback(result):
        def apply():
            if result is None:
                show_info(
                    "info",
                    "Error checking for updates, do you have an internet connection?",
                )
            elif result[0]:
                show_info("info", f'Version "{result[1]}" available for download!')
            # else: already on latest version, do nothing

        widgets.idle_add(apply)

    t = threading.Thread(target=lambda: callback(check_updates(version)), daemon=True)
    t.start()
    return t


def open_in_browser(url: str) -> None:
    """Open a webpage (gui/misc.rs:82-117; webbrowser handles the
    platform differences the reference needed WinAPI for)."""
    import webbrowser

    if not webbrowser.open(url):
        raise err.InternalError("Could not open browser")


# Fraction bits of the fixed-point taps of Pillow's 8-bit resampler
# (Resample.c: PRECISION_BITS = 32 - 8 - 2).
_PRECISION_BITS = 22


def _bilinear_taps(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    triangle filter over the whole input: per output, the first input
    index and its fixed-point taps (zero past the window), as
    ``(first [out], taps [out, ksize])``.  Python floats are C
    doubles, so each tap is the one Pillow computes."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            taps[xx, x] = int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0 else int(0.5 + v * (1 << _PRECISION_BITS))
        first[xx] = xmin
    return first, taps


def _resample_axis(img: np.ndarray, first: np.ndarray, taps: np.ndarray, axis: int) -> np.ndarray:
    """One pass of Pillow's ``ImagingResampleHorizontal/Vertical_8bpc``
    along ``axis`` of a ``[H, W, C]`` uint8 image: the rounding half,
    plus each tap times its pixel, shifted back and clipped to u8."""
    n = img.shape[axis]
    # int32 as in Pillow: the taps sum to 2**22 (+ at most ksize / 2 from
    # their rounding), so 255 of them and the half stay under 2**31.
    acc = np.full(img.shape[:axis] + (len(first),) + img.shape[axis + 1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    shape = [1] * img.ndim
    shape[axis] = len(first)
    taps = taps.astype(np.int32)
    for k in range(taps.shape[1]):
        idx = np.minimum(first + k, n - 1)  # a zero tap where the window is shorter
        acc += np.take(img, idx, axis=axis) * taps[:, k].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBA -> RGBa: each colour times alpha, ``MULDIV255``."""
    out = rgba.copy()
    t = rgba[..., :3].astype(np.uint32) * rgba[..., 3:].astype(np.uint32) + 128
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's RGBa -> RGBA: each colour times 255 over alpha, by
    integer division, clipped; kept where alpha is 0 or 255."""
    out = rgba.copy()
    a = rgba[..., 3:].astype(np.uint32)
    part = (a != 0) & (a != 255)
    div = np.minimum(rgba[..., :3].astype(np.uint32) * 255 // np.maximum(a, 1), 255)
    out[..., :3] = np.where(part, div, rgba[..., :3]).astype(np.uint8)
    return out


def _bilinear_resize(image: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Pillow's ``Image.fromarray(image).resize((out_w, out_h), BILINEAR)``
    for an L, RGB or RGBA uint8 array: RGBA is premultiplied by alpha
    first and divided after; a horizontal pass, then a vertical pass, each
    rounded and clipped to u8."""
    img = image if image.ndim == 3 else image[:, :, None]
    # Where every pixel is opaque both conversions are the identity (the
    # resampled alpha stays 255), so an opaque image skips them.
    rgba = img.shape[2] == 4 and bool((img[..., 3] != 255).any())
    if rgba:
        img = _premultiply(img)
    h, w = img.shape[:2]
    if out_w != w:
        img = _resample_axis(img, *_bilinear_taps(w, out_w), axis=1)
    if out_h != h:
        img = _resample_axis(img, *_bilinear_taps(h, out_h), axis=0)
    if rgba:
        img = _unpremultiply(img)
    return img if image.ndim == 3 else img[:, :, 0]


def scale_preview(image: np.ndarray, viewport: tuple, normal_size: bool) -> np.ndarray:
    """Fit the processed image into the viewport (gui/misc.rs:122-169):
    full size when the toggle is on, otherwise downscale-only to fit
    (never upscale)."""
    if normal_size:
        return image
    h, w = image.shape[:2]
    max_w, max_h = max(int(viewport[0]), 1), max(int(viewport[1]), 1)
    scale = min(max_w / w, max_h / h)
    if scale >= 1.0:
        return image
    out_w, out_h = max(int(w * scale), 1), max(int(h * scale), 1)
    return _bilinear_resize(image, out_w, out_h)


def output_tips(output_filename: str | None, extension: str) -> dict:
    """Tips for a save-path entry (gui.rs:258-319 ``configure_tips``):
    where a relative path will land, a missing-extension warning, and
    an overwrite warning."""
    import os
    from pathlib import Path

    tips = {"folder": None, "extension_warn": False, "overwrite_warn": False}
    if not output_filename:
        return tips
    if not os.path.isabs(output_filename):
        tips["folder"] = str(Path.cwd())
    if not output_filename.endswith(extension):
        tips["extension_warn"] = True
    if Path(output_filename).exists():
        tips["overwrite_warn"] = True
    return tips


def update_image() -> None:
    """Update the right-pane preview from the processed image, or show
    the placeholder (gui/misc.rs:122-169)."""
    widgets = borrow_widgets()
    image = borrow_state().processed_image
    if image is None:
        widgets.image.set_preview(None)
        return
    preview = scale_preview(
        image, widgets.image.viewport_size(), bool(widgets.img_size_toggle.get())
    )
    widgets.image.set_preview(preview)
