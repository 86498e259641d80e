"""Histogram equalization utilities (grayscale and Lab-color).

A copy of ``noaa_apt_tpu/post/imageext.py``, operation for operation.

Behavioral contract: reference ``src/imageext.rs`` (via the ``image``
and ``lab`` crates): grayscale equalization maps each pixel to
``trunc(255 * cdf[r]/total)`` using the R-channel histogram
(imageext.rs:23-46); color equalization converts sRGB -> CIE Lab,
equalizes the L channel over 101 integer bins, and converts back
(imageext.rs:50-92).  Vectorized NumPy (the Rust code is a per-pixel
loop).

The Lab conversions replicate the ``lab`` crate v0.11.0 (the version
pinned in the reference's Cargo.lock) **operation for operation** in
f32: its 4-digit sRGB<->XYZ matrix literals (0.4124/0.3576/... and
3.2406/-1.5372/...), D65 white point 0.95047/1.08883, the
``powf(1.0/3.0)`` cube root (NOT ``cbrt`` — they differ in the last
ulp), the ``(KAPPA*c + 16)/116`` linear branch, ``powi(3)`` expanded
to a multiply chain, left-associated per-channel multiply-add order,
and the final ``round().min(255.0).max(0.0) as u8`` cast.  ``powf`` in
both Rust and NumPy lowers to the platform libm, so on glibc the
transcendental steps are bit-identical as well.

The constant set was VERIFIED (not assumed) against the crate's own
published test vector: with these exact operations,
``rgb_to_lab([253, 120, 138])`` equals
``Lab { l: 66.6348, a: 52.260696, b: 14.850557 }`` bit-for-bit in f32
— the high-precision "exact chromaticity" and full-Lindbloom variants
do not.  Pinned in ``tests/test_post.py`` (this copy in
``tests/test_torch_post.py``) together with golden RGBA
fixtures for ``equalize_histogram_color``.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32

# lab-0.11.0 constants, verbatim (const-folded in f32 like rustc does).
_KAPPA = _F32(24389.0) / _F32(27.0)  # const KAPPA: f32 = 24389.0 / 27.0
_EPSILON = _F32(216.0) / _F32(24389.0)  # const EPSILON: f32 = 216.0 / 24389.0
_CBRT_EPSILON = _F32(0.20689655172413796)
_WHITE_X = _F32(0.95047)
_WHITE_Z = _F32(1.08883)
_THIRD = _F32(1.0) / _F32(3.0)
_INV_GAMMA = _F32(1.0) / _F32(2.4)


def _rgb_to_xyz_map(c: np.ndarray) -> np.ndarray:
    """lab crate ``rgb_to_xyz_map``: u8 channel -> linear-light f32."""
    c = c.astype(_F32) / _F32(255.0)
    return np.where(
        c > _F32(0.04045),
        ((c + _F32(0.055)) / _F32(1.055)) ** _F32(2.4),
        c / _F32(12.92),
    )


def _xyz_to_lab_map(c: np.ndarray) -> np.ndarray:
    """lab crate ``xyz_to_lab_map``: powf(1/3) above EPSILON, else the
    (KAPPA*c + 16)/116 linear segment."""
    return np.where(
        c > _EPSILON,
        np.maximum(c, _F32(0.0)) ** _THIRD,
        (_KAPPA * c + _F32(16.0)) / _F32(116.0),
    )


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """[..., 3] u8 sRGB -> [..., 3] f32 Lab (L in 0..100).

    Operation order matches ``Lab::from_rgb`` (lab-0.11.0): per-channel
    gamma expansion, three left-associated f32 dot products, white-point
    divides, f() map, then the L/a/b combinations.
    """
    r = _rgb_to_xyz_map(rgb[..., 0])
    g = _rgb_to_xyz_map(rgb[..., 1])
    b = _rgb_to_xyz_map(rgb[..., 2])
    x = r * _F32(0.4124) + g * _F32(0.3576) + b * _F32(0.1805)
    y = r * _F32(0.2126) + g * _F32(0.7152) + b * _F32(0.0722)
    z = r * _F32(0.0193) + g * _F32(0.1192) + b * _F32(0.9505)
    fx = _xyz_to_lab_map(x / _WHITE_X)
    fy = _xyz_to_lab_map(y)
    fz = _xyz_to_lab_map(z / _WHITE_Z)
    l = _F32(116.0) * fy - _F32(16.0)
    a = _F32(500.0) * (fx - fy)
    b_out = _F32(200.0) * (fy - fz)
    return np.stack([l, a, b_out], axis=-1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """[..., 3] f32 Lab -> [..., 3] u8 sRGB.

    Operation order matches ``Lab::to_rgb`` (lab-0.11.0): lab_to_xyz
    with ``powi(3)`` as an explicit multiply chain, ``fx/fz`` branched
    on CBRT_EPSILON and ``L`` on EPSILON*KAPPA (= 8), the 4-digit
    inverse matrix, gamma compression, and
    ``round().min(255.0).max(0.0) as u8``.
    """
    lab = lab.astype(_F32, copy=False)
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (l + _F32(16.0)) / _F32(116.0)
    fx = (a / _F32(500.0)) + fy
    fz = fy - (b / _F32(200.0))
    xr = np.where(
        fx > _CBRT_EPSILON,
        fx * fx * fx,
        (fx * _F32(116.0) - _F32(16.0)) / _KAPPA,
    )
    yr = np.where(
        l > _EPSILON * _KAPPA,
        fy * fy * fy,
        l / _KAPPA,
    )
    zr = np.where(
        fz > _CBRT_EPSILON,
        fz * fz * fz,
        (fz * _F32(116.0) - _F32(16.0)) / _KAPPA,
    )
    x = xr * _WHITE_X
    y = yr
    z = zr * _WHITE_Z
    r = x * _F32(3.2406) + y * _F32(-1.5372) + z * _F32(-0.4986)
    g = x * _F32(-0.9689) + y * _F32(1.8758) + z * _F32(0.0415)
    b_lin = x * _F32(0.0557) + y * _F32(-0.2040) + z * _F32(1.057)
    return np.stack(
        [_xyz_to_rgb_map(r), _xyz_to_rgb_map(g), _xyz_to_rgb_map(b_lin)], axis=-1
    )


def _xyz_to_rgb_map(c: np.ndarray) -> np.ndarray:
    """lab crate ``xyz_to_rgb_map``: gamma-compress, scale by 255,
    round half-away-from-zero, clamp, cast."""
    c = np.where(
        c > _F32(0.0031308),
        _F32(1.055) * np.maximum(c, _F32(0.0)) ** _INV_GAMMA - _F32(0.055),
        _F32(12.92) * c,
    )
    c = c * _F32(255.0)
    # Rust `.round()` is half away from zero; after the min/max clamp
    # every surviving value is >= 0, so floor(x + 0.5) matches it.
    return np.clip(np.floor(c + _F32(0.5)), 0, 255).astype(np.uint8)


def equalize_histogram_grayscale(region: np.ndarray) -> None:
    """In place, on an RGBA u8 view: R-channel CDF drives all of RGB;
    alpha untouched (imageext.rs:23-46)."""
    r = region[..., 0]
    hist = np.bincount(r.reshape(-1), minlength=256).astype(np.uint64)
    cdf = np.cumsum(hist)
    total = np.float32(cdf[255])
    # (255 * fraction) as u8 — Rust cast truncates toward zero.
    lut = np.trunc(np.float32(255.0) * (cdf.astype(np.float32) / total)).astype(np.uint8)
    region[..., 0] = lut[r]
    region[..., 1] = region[..., 0]
    region[..., 2] = region[..., 0]


def equalize_histogram_color(region: np.ndarray) -> None:
    """In place, on an RGBA u8 view: equalize L in Lab space over 101
    integer bins (imageext.rs:50-92).

    ``p.l as usize`` in Rust truncates toward zero and saturates
    negatives at 0; L from RGB is in [0, 100] up to f32 rounding, so
    the trunc + clip below is exact.
    """
    lab = rgb_to_lab(region[..., :3])
    l_idx = np.clip(lab[..., 0].astype(np.int64), 0, 100)  # trunc toward 0
    hist = np.bincount(l_idx.reshape(-1), minlength=101)
    cdf = np.cumsum(hist)
    total = np.float32(cdf[100])
    frac = cdf.astype(np.float32) / total
    # p.l = 100. * fraction (imageext.rs:60) — f32 multiply.
    lab[..., 0] = _F32(100.0) * frac[l_idx]
    region[..., :3] = lab_to_rgb(lab)
