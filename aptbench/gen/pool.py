"""A traffic mix's pool of seeded passes, written as WAVs.

The mix gives the lengths (``minutes``), the SNR at the pass's edges and
middle (``snr_db``), and how many passes the pool holds (``pool``).  The
seed orders the lengths and draws each pass's content; every seed asks
for the same set of lengths.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np

from . import synth


@dataclass(frozen=True)
class Pass:
    path: Path
    seed: int
    seconds: float
    rate: int
    n_samples: int


def pool_lengths(traffic: dict) -> list:
    """The pool's lengths in seconds: ``pool`` values spread evenly over
    ``minutes = [lo, hi]``, both ends included."""
    lo, hi = traffic["minutes"]
    k = int(traffic["pool"])
    return [60.0 * (lo + (hi - lo) * i / max(1, k - 1)) for i in range(k)]


def pass_seeds(seed: int, k: int) -> list:
    """``k`` independent 63-bit seeds drawn from the run's seed."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    return [int(s) for s in ss.generate_state(k, dtype=np.uint64) % (1 << 63)]


SATS = (15, 18, 19)
FIRST_PASS = datetime(2020, 1, 26, 1, 0, 0)
ORBIT = timedelta(minutes=101)


def file_name(config: dict, k: int) -> str:
    """The ``k``-th pass's file name, as the recording program of the
    configuration names it (``filename``: a format of ``t``, the start
    time, and ``sat``, the NOAA number), one orbit apart."""
    return config["filename"].format(t=FIRST_PASS + k * ORBIT, sat=SATS[k % len(SATS)])


def write_wav(path: Path, pcm: np.ndarray, rate: int) -> None:
    """A mono 16-bit PCM WAV with the canonical 44-byte header."""
    data = np.ascontiguousarray(pcm, dtype="<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, 1, rate, rate * 2, 2, 16)
           + b"data" + struct.pack("<I", len(data)))
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(data)


def read_wav(path: Path) -> np.ndarray:
    """The samples of a WAV that :func:`write_wav` wrote."""
    return np.fromfile(path, dtype="<i2", offset=44)


def make_pool(out_dir: Path, seed: int, config: dict, traffic: dict, device) -> list:
    """Write the pool's WAVs into ``out_dir``; returns its passes in the
    seed's order."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lengths = pool_lengths(traffic)
    order = np.random.default_rng(int(seed) % (1 << 128)).permutation(len(lengths))
    seeds = pass_seeds(seed, len(lengths))
    rate = int(config["sample_rate"])
    edge, mid = traffic["snr_db"]
    passes = []
    for k, (j, s) in enumerate(zip(order, seeds)):
        pcm = synth.make_pass(s, lengths[j], rate, edge, mid, device).cpu().numpy()
        path = out_dir / file_name(config, k)
        write_wav(path, pcm, rate)
        passes.append(Pass(path, s, pcm.shape[0] / rate, rate, pcm.shape[0]))
    return passes
