"""Settings file (TOML, schema version 4) and resource resolution.

Behavioral contract: reference ``src/config.rs`` + the
``default_settings.toml`` schema, as ``noaa_apt_tpu/io/config.py``
ports it (a copy of ``Settings``, ``res_path``, ``load_de_settings`` and
``build_settings``).  The user file is the same one,
``$XDG_CONFIG_HOME/noaa-apt-tpu/settings.toml``, so a user's settings
apply to both packages; corrupt or outdated files are moved to ``.OLD``
and regenerated; the CLI's ``-p`` selects the profile.  Resources resolve
through ``NOAA_APT_RES_DIR`` (``config.rs:27-40``), defaulting to the
port's own ``noaa_apt_tpu_torch/res/``.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path

from .. import err
from ..core.profiles import DecodeProfile

SETTINGS_VERSION = 4

# Embedded default settings (same schema/values as the reference's
# settings version 4; regenerated on corrupt/outdated user files).
DEFAULT_SETTINGS_TOML = """\
# noaa-apt-tpu settings (schema version 4, compatible with noaa-apt)

version = 4
check_updates = true

[timestamps]
prefer_timestamps = false
# Filename formats tried in order to infer recording time + satellite.
# %Y %m %d %H %M %S date/time, %N sat number (15/18/19), %! 9-digit
# frequency in Hz, %1..%9 skip N characters.
filenames = [
    "gqrx_%Y%m%d_%H%M%S_%!.wav",
    "SDRSharp_%Y%m%d_%H%M%SZ_%!Hz_AF.wav",
    "%Y%m%d-%H%M-noaa-%N.wav",
    "NOAA%N-%Y%m%d-%H%M%S.wav",
    "N%N%Y%m%d%H%M%S.wav",
    "%Y-%m-%d-%H-%M-%S-NOAA_%N.wav",
    "%Y%m%d-%H%M%SNOAA%NEl%2.wav",
    "audio_%!Hz_%H-%M-%S_%d-%m-%Y.wav",
]
timezone = 0.0

[map_overlay]
default_countries_color = [255, 255, 0, 255]
default_states_color = [255, 255, 0, 150]
default_lakes_color = [50, 200, 200, 255]

[false_color]
default_palette_filename = "noaa-apt-daylight.png"

[profiles]
default_profile = "standard"

    [profiles.standard]
    work_rate = 12480
    resample_atten = 30
    resample_delta_freq = 1000
    resample_cutout = 4800
    demodulation_atten = 25
    wav_resample_atten = 40
    wav_resample_delta_freq = 0.1

    [profiles.fast]
    work_rate = 16640
    resample_atten = 30
    resample_delta_freq = 3000
    resample_cutout = 4800
    demodulation_atten = 23
    wav_resample_atten = 30
    wav_resample_delta_freq = 0.2

    [profiles.slow]
    work_rate = 20800
    resample_atten = 40
    resample_delta_freq = 500
    resample_cutout = 4800
    demodulation_atten = 25
    wav_resample_atten = 50
    wav_resample_delta_freq = 0.05
"""


def res_path(*parts) -> Path:
    """Resource path, honoring NOAA_APT_RES_DIR (config.rs:27-40);
    by default the port's own ``res/`` (shipped as package data)."""
    base = os.environ.get("NOAA_APT_RES_DIR")
    if base is None:
        base = Path(__file__).resolve().parent.parent / "res"
    return Path(base).joinpath(*parts)


def config_dir() -> Path:
    xdg = os.environ.get("XDG_CONFIG_HOME", str(Path.home() / ".config"))
    return Path(xdg) / "noaa-apt-tpu"


@dataclass
class Settings:
    """Merged runtime settings (reference ``config.rs:76-129``)."""

    export_wav: bool = False
    export_resample_filtered: bool = False
    work_rate: int = 12480
    resample_atten: float = 30.0
    resample_delta_freq: float = 1000.0
    resample_cutout: float = 4800.0
    demodulation_atten: float = 25.0
    wav_resample_atten: float = 40.0
    wav_resample_delta_freq: float = 0.1
    prefer_timestamps: bool = False
    filename_formats: list = field(default_factory=list)
    filename_timezone: float = 0.0
    default_countries_color: tuple = (255, 255, 0, 255)
    default_states_color: tuple = (255, 255, 0, 150)
    default_lakes_color: tuple = (50, 200, 200, 255)
    default_palette_filename: Path = None

    def profile(self) -> DecodeProfile:
        return DecodeProfile(
            "settings",
            self.work_rate,
            self.resample_atten,
            self.resample_delta_freq,
            self.resample_cutout,
            self.demodulation_atten,
            self.wav_resample_atten,
            self.wav_resample_delta_freq,
        )


def _parse_toml(text: str) -> dict:
    de = tomllib.loads(text)
    if de.get("version") != SETTINGS_VERSION:
        raise err.DeserializeError(
            f"Wrong settings file version {de.get('version')}. Should be {SETTINGS_VERSION}"
        )
    return de


def load_de_settings() -> dict:
    """Load the settings dict, creating/migrating the user file
    (config.rs:206-252)."""
    filename = config_dir() / "settings.toml"
    try:
        return _parse_toml(filename.read_text())
    except FileNotFoundError:
        pass
    except Exception as e:
        print(f"Error loading settings file {filename}: {e}")
        try:
            dest = filename.with_suffix(".OLD")
            print(
                f"Outdated or corrupted settings file, moving to {dest} and "
                f"saving default settings file on {filename}"
            )
            filename.rename(dest)
        except OSError as e2:
            print(f"Unable to move settings file: {e2}")

    try:
        filename.parent.mkdir(parents=True, exist_ok=True)
        filename.write_text(DEFAULT_SETTINGS_TOML)
        print(f"Saving default settings to {filename}")
    except OSError:
        print(
            f"Could not open or create settings file {filename}, using default settings"
        )
    return _parse_toml(DEFAULT_SETTINGS_TOML)


def build_settings(
    de: dict,
    profile_name: str | None = None,
    export_wav: bool = False,
    export_resample_filtered: bool = False,
) -> Settings:
    """Merge a profile and flags into Settings (config.rs:486-531)."""
    profiles = de["profiles"]
    name = profile_name or profiles["default_profile"]
    if name not in ("standard", "fast", "slow"):
        print(f'Invalid profile "{name}", using standard profile')
        name = "standard"
    p = profiles[name]
    fc = de["false_color"]["default_palette_filename"]
    return Settings(
        export_wav=export_wav,
        export_resample_filtered=export_resample_filtered,
        work_rate=int(p["work_rate"]),
        resample_atten=float(p["resample_atten"]),
        resample_delta_freq=float(p["resample_delta_freq"]),
        resample_cutout=float(p["resample_cutout"]),
        demodulation_atten=float(p["demodulation_atten"]),
        wav_resample_atten=float(p["wav_resample_atten"]),
        wav_resample_delta_freq=float(p["wav_resample_delta_freq"]),
        prefer_timestamps=bool(de["timestamps"]["prefer_timestamps"]),
        filename_formats=list(de["timestamps"]["filenames"]),
        filename_timezone=float(de["timestamps"]["timezone"]),
        default_countries_color=tuple(de["map_overlay"]["default_countries_color"]),
        default_states_color=tuple(de["map_overlay"]["default_states_color"]),
        default_lakes_color=tuple(de["map_overlay"]["default_lakes_color"]),
        default_palette_filename=res_path("palettes", fc),
    )
