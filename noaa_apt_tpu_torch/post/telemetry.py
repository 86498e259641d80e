"""Telemetry wedge decoding and calibration.

Behavioral contract: reference ``src/telemetry.rs``, as
``noaa_apt_tpu/post/telemetry.py`` ports it (a copy).  The per-row
band means/variances and the frame cross-correlation are vectorized
NumPy (the data is tiny: one value per image row); the wedge averaging,
quality estimation and channel-name classification follow the reference
exactly — including Rust ``Iterator::min_by`` keeping the *first* of
equal minima (it is ``max_by`` that keeps the last).
"""

from __future__ import annotations

import logging

import numpy as np

from .. import PX_PER_ROW, err

log = logging.getLogger(__name__)

# Sample telemetry frame used for correlation: contrast wedges 1-9,
# 7 variable wedges, then wedges 1-9 of the next frame; each value
# repeated 8 rows (telemetry.rs:129-137).
_TELEMETRY_SAMPLE = np.repeat(
    np.array(
        [31, 63, 95, 127, 159, 191, 224, 255, 0]
        + [0] * 7
        + [31, 63, 95, 127, 159, 191, 224, 255, 0],
        dtype=np.float32,
    ),
    8,
)

CHANNEL_NAMES = ["1", "2", "3a", "4", "5", "3b", "Unknown", "Unknown", "Unknown"]


class Telemetry:
    """Wedge values for both bands (reference ``telemetry.rs:19-118``)."""

    def __init__(self, values_a: np.ndarray, values_b: np.ndarray):
        self.values_a = np.asarray(values_a, dtype=np.float32)
        self.values_b = np.asarray(values_b, dtype=np.float32)

    @classmethod
    def from_bands(cls, means_a: np.ndarray, means_b: np.ndarray, row: int) -> "Telemetry":
        """Average 8-row wedges starting at ``row``; wedges 1-9 are
        averaged with the next frame's copies (telemetry.rs:30-71)."""

        def wedge_means(means):
            m = np.asarray(means, dtype=np.float32)[row:]
            k = m.shape[0] // 8
            chunk = m[: k * 8].reshape(k, 8).mean(axis=1, dtype=np.float32)[: 16 + 9]
            vals = np.empty(16, dtype=np.float32)
            for wedge in range(1, 17):
                if wedge <= 9:
                    vals[wedge - 1] = (chunk[wedge - 1] + chunk[wedge + 16 - 1]) / np.float32(2.0)
                else:
                    vals[wedge - 1] = chunk[wedge - 1]
            return vals

        t = cls(wedge_means(means_a), wedge_means(means_b))
        log.debug("Telemetry wedges_a: %s, wedges_b: %s", t.values_a, t.values_b)
        return t

    def get_wedge_value(self, wedge: int, channel: str | None = None) -> float:
        """channel: "a", "b", or None for the average of both."""
        i = wedge - 1
        if channel == "a":
            return float(self.values_a[i])
        if channel == "b":
            return float(self.values_b[i])
        return float((self.values_a[i] + self.values_b[i]) / np.float32(2.0))

    def get_channel_name(self, channel: str) -> str:
        """Classify by nearest contrast wedge to wedge 16
        (telemetry.rs:91-117; ties keep the FIRST minimum, as Rust
        ``min_by`` does)."""
        value = self.get_wedge_value(16, channel)
        best_name = None
        best_diff = None
        for i in range(1, 10):
            diff = abs(self.get_wedge_value(i, None) - value)
            if best_diff is None or diff < best_diff:
                best_diff = diff
                best_name = CHANNEL_NAMES[i - 1]
        return best_name


def band_statistics(signal: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-row telemetry band means and pooled variance
    (telemetry.rs:147-170).  ``signal`` is flat at FINAL_RATE."""
    signal = np.asarray(signal, dtype=np.float32)
    h = signal.shape[0] // PX_PER_ROW
    rows = signal[: h * PX_PER_ROW].reshape(h, PX_PER_ROW)
    a = rows[:, 994 : 994 + 44]
    b = rows[:, 2034 : 2034 + 44]
    mean_a = a.mean(axis=1, dtype=np.float32)
    mean_b = b.mean(axis=1, dtype=np.float32)
    variance = (
        ((a - mean_a[:, None]) ** 2).sum(axis=1, dtype=np.float32)
        + ((b - mean_b[:, None]) ** 2).sum(axis=1, dtype=np.float32)
    ) / np.float32(88.0)
    return mean_a, mean_b, variance


def read_telemetry(signal: np.ndarray, context=None) -> Telemetry:
    """Locate the best telemetry frame and read wedge values
    (reference ``telemetry.rs:125-243``)."""
    mean_a, mean_b, variance = band_statistics(signal)
    return telemetry_from_stats(mean_a, mean_b, variance, context)


def telemetry_from_stats(
    mean_a: np.ndarray, mean_b: np.ndarray, variance: np.ndarray, context=None
) -> Telemetry:
    """Frame correlation + wedge read from per-row band statistics
    (which may have been computed on device)."""
    sample = _TELEMETRY_SAMPLE

    if mean_a.shape[0] < sample.shape[0]:
        raise err.InternalError("Recording too short for telemetry decoding")
    if mean_a.shape[0] < 2 * sample.shape[0]:
        log.warning("Reading telemetry on short recording, expect unreliable results")

    n = mean_a.shape[0] - sample.shape[0]
    # corr[i] = sum_j sample[j]*(mean_a[i+j] + mean_b[i+j])
    both = (mean_a + mean_b).astype(np.float32)
    corr = np.correlate(both, sample, mode="valid")[:n].astype(np.float32)
    sd = np.sqrt(variance.astype(np.float32))
    csum = np.concatenate([[np.float32(0.0)], np.cumsum(sd, dtype=np.float32)])
    denom = (csum[sample.shape[0] :] - csum[:-sample.shape[0]])[:n]
    quality = corr / denom
    # First occurrence of the strict maximum, starting from quality 0
    # (telemetry.rs:187,219-221).
    best_row = 0
    best_q = np.float32(0.0)
    for i in range(n):
        if quality[i] > best_q:
            best_row, best_q = i, quality[i]

    telemetry = Telemetry.from_bands(mean_a, mean_b, best_row)
    log.info(
        "Channel A: %s, Channel B: %s",
        telemetry.get_channel_name("a"),
        telemetry.get_channel_name("b"),
    )
    if context is not None:
        context.step_signal("telemetry_a", mean_a)
        context.step_signal("telemetry_b", mean_b)
        context.step_signal("telemetry_correlation", corr)
        context.step_signal("telemetry_variance", variance)
        context.step_signal("telemetry_quality", quality)
    return telemetry
