"""Sync-frame template, selector parameters and the plain correlation.

Behavioral contract: reference ``src/decode.rs:164-263`` as ported by
``noaa_apt_tpu/ops/sync.py``.  On the decode path the correlation runs
inside the fused kernel (``ops/stage.py``) and the greedy selection in
kernel K3 (``ops/select.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import FINAL_RATE, PX_PER_ROW
from ..core.frequency import Rate


def generate_sync_frame(work_rate: Rate) -> np.ndarray:
    """Sync A template at work_rate; int8 values in {-1, +1}
    (``decode.rs:171-199``)."""
    if work_rate.get_hz() % FINAL_RATE != 0:
        raise ValueError("work_rate is not multiple of FINAL_RATE")
    pw = work_rate.get_hz() // FINAL_RATE  # pixel width in samples
    spw = 2 * pw  # sync pulse width
    parts = [-np.ones(spw, np.int8)]
    cycle = np.concatenate([-np.ones(spw, np.int8), np.ones(spw, np.int8)])
    parts.append(np.tile(cycle, 8)[: 7 * 2 * spw])
    parts.append(-np.ones(8 * pw, np.int8))
    return np.concatenate(parts)


def row_samples(work_rate_hz: int) -> int:
    return PX_PER_ROW * work_rate_hz // FINAL_RATE


def selector_params(corr_len: int, work_rate: Rate) -> tuple[int, int, int]:
    """(spr, min-distance, max_peaks) for the greedy selector
    (``noaa_apt_tpu/ops/sync.py:194-198``)."""
    spr = row_samples(work_rate.get_hz())
    return spr, spr * 8 // 10, max(16, corr_len // spr + 16)


def signed_sum(x: torch.Tensor, template, n_out: int) -> torch.Tensor:
    """``out[u] = sum_j template[j] * x[u + j]`` for ``u < n_out`` with
    ``x`` read as 0 past its end: +-1 adds in ascending ``j`` starting
    from ``+-x[u]``, one op per step (the order kernel K2 uses)."""
    g = len(template)
    xp = torch.cat([x, torch.zeros(max(0, n_out + g - 1 - x.shape[0]), dtype=x.dtype, device=x.device)])
    acc = xp[:n_out] if template[0] > 0 else -xp[:n_out]
    for j in range(1, g):
        seg = xp[j : j + n_out]
        acc = acc + seg if template[j] > 0 else acc - seg
    return acc


def sync_correlate(signal: torch.Tensor, template, n_valid: int | None = None) -> torch.Tensor:
    """corr[i] = sum_j template[j] * signal[i+j] for i in [0, N - g):
    the reference loops ``i in 0..N-G`` (``decode.rs:225``), one fewer
    than the number of valid windows, so the last is dropped.
    ``n_valid`` limits the output to the true signal length."""
    g = len(template)
    n_out = max(0, signal.shape[0] - g)
    if n_valid is not None:
        n_out = min(n_out, max(0, n_valid - g))
    return signed_sum(signal, template, n_out)
