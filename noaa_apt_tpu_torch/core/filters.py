"""FIR filter design (host-side, float32, NumPy-vectorized).

Behavioral contract: reference ``src/filters.rs`` (Kaiser-windowed sinc
lowpass / bandpass-DC-removal designs, odd length derived from
attenuation and transition bandwidth) and ``src/misc.rs:20-57``
(``bessel_i0``).  Filter design is cheap and happens once per
(rate-pair, profile) on the host; the decoder uploads the taps once and
keeps them on the device (``graph/decode.py:DecodeTables``).

A copy of ``noaa_apt_tpu/core/filters.py``: the port imports nothing of
the JAX package, and the tests hold the two designs bit-equal.

All arithmetic is float32 to match the reference's f32 numerics —
in particular the window length ``ceil((atten-8)/(2.285*delta_w_rad))+1``
must not drift by one due to precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np

from .frequency import Freq, Rate

_PI32 = np.float32(math.pi)

# Lookup table 1/(k! * 2^k)^2 for bessel_i0 (reference misc.rs:20-41).
_BESSEL_TABLE = np.array(
    [
        1.0,
        0.25,
        0.015625,
        0.00043402777777777775,
        6.781684027777777e-06,
        6.781684027777778e-08,
        4.709502797067901e-10,
        2.4028075495244395e-12,
        9.385966990329842e-15,
        2.896903392077112e-17,
        7.242258480192779e-20,
        1.4963343967340453e-22,
        2.5978027721077174e-25,
        3.842903509035085e-28,
        4.9016626390753635e-31,
        5.4462918211948485e-34,
        5.318644356635594e-37,
        4.60090342269515e-40,
        3.5500798014623073e-43,
        2.458504017633177e-46,
    ],
    dtype=np.float32,
)


def bessel_i0(x):
    """First-kind modified Bessel function of order zero.

    8-term Horner evaluation with the precomputed table, exactly as the
    reference (``misc.rs:47-57``).  Accepts scalars or arrays; float32.
    """
    x = np.asarray(x, dtype=np.float32)
    x2 = np.float32(x * x) if x.ndim == 0 else x * x
    result = np.zeros_like(x, dtype=np.float32)
    for k in range(8, 0, -1):
        result = (result + _BESSEL_TABLE[k]) * x2
    return np.float32(result + np.float32(1.0)) if x.ndim == 0 else result + np.float32(1.0)


def kaiser(atten: float, delta_w: Freq) -> np.ndarray:
    """Design a Kaiser window (reference ``filters.rs:144-183``).

    Length is always odd and depends on ``atten`` (positive dB) and the
    transition band ``delta_w``.
    """
    atten = np.float32(atten)
    if atten > 50.0:
        beta = np.float32(0.1102) * (atten - np.float32(8.7))
    elif atten < 21.0:
        beta = np.float32(0.0)
    else:
        beta = np.float32(0.5842) * np.float32(
            (atten - np.float32(21.0)) ** np.float32(0.4)
        ) + np.float32(0.07886) * (atten - np.float32(21.0))

    length = int(
        math.ceil(
            float(
                np.float32(atten - np.float32(8.0))
                / (np.float32(2.285) * delta_w.get_rad())
            )
        )
    ) + 1
    if length % 2 == 0:
        length += 1

    half = (length - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float32)
    m = np.float32(length)
    arg = beta * np.sqrt(
        np.maximum(np.float32(1.0) - (n / (m / np.float32(2.0))) ** 2, np.float32(0.0))
    )
    window = bessel_i0(arg) / bessel_i0(beta)
    return window.astype(np.float32)


@dataclass(frozen=True)
class NoFilter:
    """Impulse (reference ``filters.rs:48-54``)."""

    def design(self) -> np.ndarray:
        return np.array([1.0], dtype=np.float32)

    def resample(self, input_rate: Rate, output_rate: Rate) -> "NoFilter":
        return self


@dataclass(frozen=True)
class Lowpass:
    """Kaiser-windowed sinc lowpass (reference ``filters.rs:56-95``).

    Transition band spans ``cutout - delta_w/2`` to ``cutout + delta_w/2``.
    """

    cutout: Freq
    atten: float
    delta_w: Freq

    def design(self) -> np.ndarray:
        window = kaiser(self.atten, self.delta_w)
        assert window.size % 2 == 1, "Kaiser window length should be odd"
        half = (window.size - 1) // 2
        n = np.arange(-half, half + 1, dtype=np.float32)
        cut = self.cutout.get_pi_rad()
        with np.errstate(divide="ignore", invalid="ignore"):
            taps = np.sin(n * _PI32 * cut) / (n * _PI32)
        taps[half] = cut
        return (taps.astype(np.float32) * window).astype(np.float32)

    def resample(self, input_rate: Rate, output_rate: Rate) -> "Lowpass":
        ratio = np.float32(output_rate.get_hz()) / np.float32(input_rate.get_hz())
        return replace(self, cutout=self.cutout / ratio, delta_w=self.delta_w / ratio)


@dataclass(frozen=True)
class LowpassDcRemoval:
    """Bandpass = lowpass minus a narrow DC lobe (``filters.rs:97-139``).

    Has the lowpass transition band plus a 0..delta_w transition removing
    DC.
    """

    cutout: Freq
    atten: float
    delta_w: Freq

    def design(self) -> np.ndarray:
        window = kaiser(self.atten, self.delta_w)
        assert window.size % 2 == 1, "Kaiser window length should be odd"
        half = (window.size - 1) // 2
        n = np.arange(-half, half + 1, dtype=np.float32)
        cut = self.cutout.get_pi_rad()
        dc = (self.delta_w / 2.0).get_pi_rad()
        with np.errstate(divide="ignore", invalid="ignore"):
            taps = np.sin(n * _PI32 * cut) / (n * _PI32) - np.sin(n * _PI32 * dc) / (
                n * _PI32
            )
        taps[half] = np.float32(cut - dc)
        return (taps.astype(np.float32) * window).astype(np.float32)

    def resample(self, input_rate: Rate, output_rate: Rate) -> "LowpassDcRemoval":
        ratio = np.float32(output_rate.get_hz()) / np.float32(input_rate.get_hz())
        return replace(self, cutout=self.cutout / ratio, delta_w=self.delta_w / ratio)
