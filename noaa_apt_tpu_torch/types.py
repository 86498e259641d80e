"""Option types of the ported slice.

Behavioral contract: reference ``src/noaa_apt.rs:25-109`` (a subset of
``noaa_apt_tpu/types.py``: contrast, rotation and colour; the orbit and
map settings wait for the slice that ports those features).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from pathlib import Path


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


@dataclass(frozen=True)
class ColorSettings:
    palette_filename: Path
    ch_a_tune_start: float = 0.0
    ch_a_tune_end: float = 0.0
    ch_b_tune_start: float = 0.0
    ch_b_tune_end: float = 0.0
