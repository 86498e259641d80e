"""APT signal synthesizer — golden-input generation.

The reference repo's test WAVs are stripped (``.MISSING_LARGE_BLOBS``),
so golden inputs are generated here: build a pixel-exact APT line
structure (sync A/B, space, image, telemetry wedges — layout constants
from ``src/decode.rs:11-38`` and https://www.sigidwiki.com/wiki/APT),
amplitude-modulate it onto the 2400 Hz subcarrier and sample at an
arbitrary rate.  This provides exact ground truth for PSNR and
sync-position assertions.  A copy of ``noaa_apt_tpu/synth.py``, so that
``chip_smoke.py`` can make a pass without the JAX package.
"""

from __future__ import annotations

import numpy as np

from . import (
    CARRIER_FREQ,
    FINAL_RATE,
    PX_CHANNEL_IMAGE_DATA,
    PX_PER_CHANNEL,
    PX_PER_ROW,
    PX_SPACE_DATA,
    PX_SYNC_FRAME,
)

# Telemetry wedge nominal values (wedges 1..9 fixed for contrast,
# telemetry.rs:129-133).
WEDGE_VALUES = [31.0, 63.0, 95.0, 127.0, 159.0, 191.0, 224.0, 255.0, 0.0]


def sync_a_pixels() -> np.ndarray:
    """Channel-A sync: 1040 Hz square, 2-px pulses (decode.rs:164-199)."""
    px = np.zeros(PX_SYNC_FRAME, dtype=np.float32)
    pat = [0.0] * 2 + ([0.0] * 2 + [255.0] * 2) * 7 + [0.0] * 8
    px[: len(pat)] = pat
    return px


def sync_b_pixels() -> np.ndarray:
    """Channel-B sync: 832 Hz pulse train, 3-px pulses."""
    px = np.zeros(PX_SYNC_FRAME, dtype=np.float32)
    pat = [0.0] * 4 + ([255.0] * 3 + [0.0] * 2) * 7
    px[: len(pat)] = pat
    return px


def telemetry_column(n_rows: int, channel_id_wedge: float) -> np.ndarray:
    """Per-row telemetry luminance for one channel.

    16 wedges x 8 rows per 128-row frame; wedges 1-9 are the contrast
    staircase, 10-15 sensor data (synthesized as a fixed ramp), 16 the
    channel-identification value.
    """
    frame = np.zeros(128, dtype=np.float32)
    vals = WEDGE_VALUES + [30.0, 60.0, 90.0, 120.0, 150.0, 180.0, channel_id_wedge]
    for w, v in enumerate(vals):
        frame[w * 8 : (w + 1) * 8] = v
    return np.tile(frame, -(-n_rows // 128) + 1)[:n_rows]


# Channel identification wedge values: "2" on A, "4" on B.
CHANNEL_A_ID = 63.0
CHANNEL_B_ID = 127.0
AMP_LOW, AMP_HIGH = 0.2, 1.0


def apt_pattern(n_rows: int) -> np.ndarray:
    """Build a full [n_rows, 2080] luminance matrix (values 0..255): a
    dark-to-bright ramp on channel A, bright-to-dark on channel B."""
    image_a = np.tile(np.linspace(0, 255, PX_CHANNEL_IMAGE_DATA, dtype=np.float32), (n_rows, 1))
    image_b = np.tile(np.linspace(255, 0, PX_CHANNEL_IMAGE_DATA, dtype=np.float32), (n_rows, 1))

    rows = np.zeros((n_rows, PX_PER_ROW), dtype=np.float32)
    x0 = PX_SYNC_FRAME + PX_SPACE_DATA
    # Channel A
    rows[:, :PX_SYNC_FRAME] = sync_a_pixels()
    rows[:, PX_SYNC_FRAME:x0] = 0.0  # deep space (dark)
    rows[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA] = image_a
    rows[:, x0 + PX_CHANNEL_IMAGE_DATA : PX_PER_CHANNEL] = telemetry_column(n_rows, CHANNEL_A_ID)[:, None]
    # Channel B
    b0 = PX_PER_CHANNEL
    rows[:, b0 : b0 + PX_SYNC_FRAME] = sync_b_pixels()
    rows[:, b0 + PX_SYNC_FRAME : b0 + PX_SYNC_FRAME + PX_SPACE_DATA] = 255.0
    rows[:, b0 + x0 : b0 + x0 + PX_CHANNEL_IMAGE_DATA] = image_b
    rows[:, b0 + x0 + PX_CHANNEL_IMAGE_DATA :] = telemetry_column(n_rows, CHANNEL_B_ID)[:, None]
    return rows


def modulate(pattern: np.ndarray, sample_rate: int, noise_db: float | None = None,
             seed: int = 0) -> np.ndarray:
    """AM-modulate a [rows, 2080] pattern onto the 2400 Hz subcarrier.

    Luminance 0 maps to carrier amplitude ``AMP_LOW``, 255 to
    ``AMP_HIGH`` (envelope detection needs a nonzero carrier floor).
    Piecewise-constant amplitude per pixel, sampled at ``sample_rate``.
    """
    flat = pattern.reshape(-1).astype(np.float64)
    n_px = flat.shape[0]
    duration = n_px / FINAL_RATE
    n = int(duration * sample_rate)
    t = np.arange(n, dtype=np.float64) / sample_rate
    px = np.minimum((t * FINAL_RATE).astype(np.int64), n_px - 1)
    amp = AMP_LOW + (AMP_HIGH - AMP_LOW) * flat[px] / 255.0
    sig = amp * np.cos(2 * np.pi * CARRIER_FREQ * t)
    if noise_db is not None:
        rng = np.random.default_rng(seed)
        p_sig = np.mean(sig**2)
        p_noise = p_sig / (10 ** (noise_db / 10))
        sig = sig + rng.normal(0.0, np.sqrt(p_noise), n)
    return sig.astype(np.float32)


def synth_recording(n_rows: int = 128, sample_rate: int = 11025, noise_db: float | None = None,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(signal at sample_rate, ground-truth pattern)."""
    pattern = apt_pattern(n_rows)
    return modulate(pattern, sample_rate, noise_db=noise_db, seed=seed), pattern
