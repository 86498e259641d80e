"""DSP profiles (standard / fast / slow).

Behavioral contract: reference ``src/default_settings.toml:81-140`` and
the ``Settings`` struct (``config.rs:76-129``).  Values here are the
embedded defaults (a copy of ``noaa_apt_tpu/core/profiles.py``).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DecodeProfile:
    """One [profiles.*] table from the settings schema (version 4)."""

    name: str
    work_rate: int  # Hz, multiple of 4160, >= 12480
    resample_atten: float  # dB
    resample_delta_freq: float  # Hz
    resample_cutout: float  # Hz
    demodulation_atten: float  # dB
    wav_resample_atten: float  # dB (WAV->WAV tool only)
    wav_resample_delta_freq: float  # pi rad/sample (WAV->WAV tool only)


STANDARD = DecodeProfile("standard", 12480, 30.0, 1000.0, 4800.0, 25.0, 40.0, 0.1)
FAST = DecodeProfile("fast", 16640, 30.0, 3000.0, 4800.0, 23.0, 30.0, 0.2)
SLOW = DecodeProfile("slow", 20800, 40.0, 500.0, 4800.0, 25.0, 50.0, 0.05)

PROFILES = {p.name: p for p in (STANDARD, FAST, SLOW)}

