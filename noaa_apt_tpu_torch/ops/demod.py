"""AM envelope demodulation: constants and the plain op-by-op body.

Behavioral contract: reference ``src/dsp.rs:350-383`` as ported by
``noaa_apt_tpu/ops/demod.py``:

    y[i] = sqrt(x[i-1]^2 + x[i]^2 - x[i-1]*x[i]*2*cos(phi)) / sin(phi)
    phi  = 2 * (2*pi * carrier_freq / sample_rate),   y[0] = 0

(the doubled phi is the reference's, kept verbatim).  On the decode path
the demod runs inside the fused kernel (``ops/stage.py``); the functions
here are its plain twin's building blocks.

Every operation is one PyTorch op on f32 tensors, so each multiply, add
and subtract rounds once, in the order written; f32 constants travel as
0-dim f32 tensors so no operation is promoted to f64.  The sqrt is the
deterministic bit-hack + Newton form and the division a multiply by the
host-rounded reciprocal, exactly as ``demod_body`` in the JAX package.
(The JAX CPU backend contracts across its optimization barriers, so its
output sits a few ulp from this one: see PERF.md.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frequency import Freq


def demod_constants(carrier: Freq) -> tuple[np.float32, np.float32]:
    """(2*cos(phi), sin(phi)) in f32, phi = 2 * carrier.get_rad()."""
    phi = np.float32(2.0) * carrier.get_rad()
    return np.float32(np.cos(phi) * np.float32(2.0)), np.float32(np.sin(phi))


def inv_sinphi(sinphi) -> np.float32:
    """The reciprocal the demod multiplies by, rounded once on the host
    (``noaa_apt_tpu/ops/demod.py:83-84``)."""
    return np.float32(np.float32(1.0) / np.float32(sinphi))


def _c(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=like.device)


def det_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt for f32 ``x >= +0``: the 0x5F3759DF rsqrt seed and three
    Newton steps, each op rounded once (``_det_sqrt`` of the JAX
    package, bit for bit where both round per op)."""
    i = x.view(torch.int32)
    y = (0x5F3759DF - (i >> 1)).view(torch.float32)
    hx = _c(0.5, x) * x
    three_half = _c(1.5, x)
    for _ in range(3):
        v = hx * y
        v = v * y
        y = y * (three_half - v)
    return x * y


def demod_body(prev: torch.Tensor, curr: torch.Tensor, cosphi2, inv) -> torch.Tensor:
    """The envelope of consecutive sample pairs, one rounding per op.
    ``inv`` is :func:`inv_sinphi` of the carrier's sin(phi).  A body
    that rounds below zero (or to -0) clamps to +0 before the root."""
    p2 = prev * prev
    c2 = curr * curr
    pc = prev * curr
    s = p2 + c2
    t = pc * _c(cosphi2, prev)
    body = s - t
    body = torch.where(body > 0, body, torch.zeros_like(body))
    return det_sqrt(body) * _c(inv, prev)


def demodulate(x: torch.Tensor, cosphi2, inv) -> torch.Tensor:
    """dem[0] = 0, dem[t] = demod_body(x[t-1], x[t]): the demod stage of
    the plain fused twin (``ops/stage.py``)."""
    y = demod_body(x[:-1], x[1:], cosphi2, inv)
    return torch.cat([torch.zeros(min(1, x.shape[0]), dtype=x.dtype, device=x.device), y])
