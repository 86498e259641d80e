"""Discrete-time frequency and sample-rate unit types.

Behavioral contract: reference ``src/frequency.rs`` (Freq stored as
fractions of pi rad/sample, f32; Rate as integer Hz with checked
multiplication).  All float arithmetic here is done in float32 so that
filter lengths derived from these values (``core.filters.kaiser``) match
the reference's f32 arithmetic bit-for-bit in the cases that matter.

A subset of ``noaa_apt_tpu/core/frequency.py`` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

_PI32 = np.float32(math.pi)


def _f32(x) -> np.float32:
    return np.float32(x)


@dataclass(frozen=True)
class Rate:
    """Integer sample rate in Hz (reference ``frequency.rs:97-117``)."""

    hz: int

    def __post_init__(self):
        if not isinstance(self.hz, (int, np.integer)):
            raise TypeError(f"Rate must be an integer Hz, got {self.hz!r}")
        if self.hz < 0 or self.hz > 0xFFFF_FFFF:
            raise OverflowError(f"Rate out of u32 range: {self.hz}")
        object.__setattr__(self, "hz", int(self.hz))

    def get_hz(self) -> int:
        return self.hz

    def checked_mul(self, other: int) -> "Rate | None":
        """u32 checked multiply (``frequency.rs:114-116``); None on overflow."""
        v = self.hz * int(other)
        if v > 0xFFFF_FFFF:
            return None
        return Rate(v)


@dataclass(frozen=True)
class Freq:
    """Discrete-time frequency stored as fractions of pi rad/sample.

    Mirrors reference ``frequency.rs:29-88`` for what the slice uses:
    constructors from pi_rad and (hz, rate), the rad and pi_rad getters
    and division by a scalar.  Stored as float32.
    """

    pi_rad: np.float32

    def __post_init__(self):
        object.__setattr__(self, "pi_rad", _f32(self.pi_rad))

    # -- constructors -------------------------------------------------
    @staticmethod
    def from_pi_rad(f: float) -> "Freq":
        return Freq(_f32(f))

    @staticmethod
    def hz(f: float, rate: Rate) -> "Freq":
        return Freq(_f32(2.0) * _f32(f) / _f32(rate.get_hz()))

    # -- getters ------------------------------------------------------
    def get_rad(self) -> np.float32:
        return _f32(self.pi_rad * _PI32)

    def get_pi_rad(self) -> np.float32:
        return self.pi_rad

    # -- operators (f32 semantics, reference frequency.rs:119-309) ----
    def __truediv__(self, k: float) -> "Freq":
        return Freq(_f32(self.pi_rad / _f32(k)))
