"""Option types of the ported slice.

Behavioral contract: reference ``src/noaa_apt.rs:25-109`` (a subset of
``noaa_apt_tpu/types.py``: contrast and rotation; the orbit, colour and
map settings wait for the slices that port those features).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ContrastKind(enum.Enum):
    TELEMETRY = "telemetry"
    PERCENT = "percent"
    MINMAX = "minmax"
    HISTOGRAM = "histogram"


@dataclass(frozen=True)
class Contrast:
    kind: ContrastKind
    percent: float = 0.98

    @staticmethod
    def telemetry() -> "Contrast":
        return Contrast(ContrastKind.TELEMETRY)

    @staticmethod
    def from_percent(p: float) -> "Contrast":
        return Contrast(ContrastKind.PERCENT, p)

    @staticmethod
    def minmax() -> "Contrast":
        return Contrast(ContrastKind.MINMAX)

    @staticmethod
    def histogram() -> "Contrast":
        return Contrast(ContrastKind.HISTOGRAM)


class Rotate(enum.Enum):
    ORBIT = "orbit"
    NO = "no"
    YES = "yes"
