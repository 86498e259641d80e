"""Option types of the ported slice.

Behavioral contract: reference ``src/noaa_apt.rs:25-109`` (Contrast,
Rotate, RefTime, ColorSettings, OrbitSettings, MapSettings, SatName), as
``noaa_apt_tpu/types.py`` ports them (a copy).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Optional


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


class SatName(enum.Enum):
    NOAA_15 = "NOAA 15"
    NOAA_18 = "NOAA 18"
    NOAA_19 = "NOAA 19"

    def to_string(self) -> str:
        return self.value


# CLI option-id <-> SatName mapping (config.rs:590-613 ids).
SAT_IDS = {
    "noaa_15": SatName.NOAA_15,
    "noaa_18": SatName.NOAA_18,
    "noaa_19": SatName.NOAA_19,
}
SAT_TO_ID = {v: k for k, v in SAT_IDS.items()}


@dataclass(frozen=True)
class RefTime:
    """Recording start or end time (noaa_apt.rs:52-61)."""

    kind: str  # "start" | "end"
    time: datetime

    @staticmethod
    def start(t: datetime) -> "RefTime":
        return RefTime("start", t)

    @staticmethod
    def end(t: datetime) -> "RefTime":
        return RefTime("end", t)


@dataclass(frozen=True)
class ColorSettings:
    palette_filename: Path
    ch_a_tune_start: float = 0.0
    ch_a_tune_end: float = 0.0
    ch_b_tune_start: float = 0.0
    ch_b_tune_end: float = 0.0


@dataclass(frozen=True)
class MapSettings:
    yaw: float = 0.0
    hscale: float = 1.0
    vscale: float = 1.0
    countries_color: tuple = (255, 255, 0, 255)
    states_color: tuple = (255, 255, 0, 150)
    lakes_color: tuple = (50, 200, 200, 255)


@dataclass(frozen=True)
class OrbitSettings:
    # ref_time is mandatory in the reference (noaa_apt.rs:75-109).
    sat_name: SatName
    ref_time: RefTime
    custom_tle: Optional[str] = None
    draw_map: Optional[MapSettings] = None
