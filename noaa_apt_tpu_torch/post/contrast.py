"""Contrast level estimation and u8 mapping.

Behavioral contract: reference ``src/misc.rs:119-175`` (``percent``,
the 1000-bucket histogram level finder) and ``src/noaa_apt.rs:249-259``
(``map_signal_u8``).  All arithmetic is f32 like the reference; bucket
scan semantics (including the ``else if`` that forbids low and high
landing on the same bucket) are preserved exactly.

A copy of ``noaa_apt_tpu/post/contrast.py``: the host path of
``graph/process.process`` for a flat signal, and the oracle that the
decoder's device percent levels (``graph/decode.py:_levels``) are held
against.
"""

from __future__ import annotations

import numpy as np

from .. import err


def percent(signal: np.ndarray, pct: float) -> tuple[float, float]:
    """(low, high) levels such that ~pct of samples fall inside."""
    if pct < 0.0 or pct > 1.0:
        raise err.InternalError("Percent given should be between 0 and 1")
    signal = np.asarray(signal, dtype=np.float32).reshape(-1)
    if signal.size == 0:
        raise err.InternalError("Can't get minimum of a zero length vector")

    remainder = np.float32((np.float32(1.0) - np.float32(pct)) / np.float32(2.0))
    num_buckets = 1000

    mn = np.float32(signal.min())
    mx = np.float32(signal.max())
    total_range = np.float32(mx - mn)

    # A flat signal gives total_range == 0 and 0/0 = NaN here; that is
    # deliberate (NaN buckets clamp to 0 below, matching the reference's
    # f32 semantics), so keep NumPy's warning machinery quiet about it.
    with np.errstate(invalid="ignore", divide="ignore"):
        idx = np.trunc((signal - mn) / total_range * np.float32(num_buckets))
    idx = np.clip(np.nan_to_num(idx, nan=0.0), 0, num_buckets - 1).astype(np.int64)
    buckets = np.bincount(idx, minlength=num_buckets)
    return scan_buckets(buckets, signal.size, remainder, mn, total_range)


def scan_buckets(
    buckets: np.ndarray, n_samples: int, remainder: np.float32,
    mn: np.float32, total_range: np.float32,
) -> tuple[float, float]:
    """The reference's sequential bucket scan (misc.rs:151-174) —
    shared by the host and device-histogram contrast paths.  Note the
    ``elif``: low and high can never land on the same bucket."""
    num_buckets = buckets.shape[0]
    n = np.float32(n_samples)
    accum = 0
    low_bucket = None
    high_bucket = None
    for b in range(num_buckets):
        accum += int(buckets[b])
        frac = np.float32(np.float32(accum) / n)
        if low_bucket is None and frac > remainder:
            low_bucket = b
        elif high_bucket is None and frac > np.float32(1.0) - remainder:
            high_bucket = b
    if high_bucket is None:
        high_bucket = num_buckets - 1

    low = np.float32(np.float32(low_bucket) / np.float32(num_buckets) * total_range + mn)
    high = np.float32(np.float32(high_bucket) / np.float32(num_buckets) * total_range + mn)
    return float(low), float(high)


def min_max(signal: np.ndarray) -> tuple[float, float]:
    """Reference ``Contrast::MinMax`` levels (``noaa_apt.rs:158-164``)."""
    signal = np.asarray(signal)
    if signal.size == 0:
        raise err.InternalError("Can't get minimum of a zero length vector")
    return float(signal.min()), float(signal.max())


def map_signal_u8(signal: np.ndarray, low: float, high: float) -> np.ndarray:
    """Affine map to u8 with clamping; ``low -> 0``, ``high -> 255``.

    Rust f32::round is half-away-from-zero; after clamping to [0, 255]
    that equals floor(v + 0.5).  ``fmax``/``fmin`` (not
    ``maximum``/``minimum``) match Rust ``f32::max``/``min`` returning
    the non-NaN operand: a zero range (flat signal) yields 0/0 = NaN
    and must map to 0 like the reference, not propagate into an
    undefined NaN->u8 cast.
    """
    signal = np.asarray(signal, dtype=np.float32)
    rng = np.float32(high) - np.float32(low)
    # rng == 0 (flat signal) intentionally produces NaN, mapped to 0 by
    # fmax below; suppress the expected 0/0 warning so real ones stand out.
    with np.errstate(invalid="ignore", divide="ignore"):
        v = (signal - np.float32(low)) / rng * np.float32(255.0)
    v = np.fmin(np.fmax(v, np.float32(0.0)), np.float32(255.0))
    return np.floor(v + np.float32(0.5)).astype(np.uint8)
