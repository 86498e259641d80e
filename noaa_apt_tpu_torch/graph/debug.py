"""The reference's eager resample (``dsp::resample``), for the WAV -> WAV
tool.

Behavioral contract: reference ``src/dsp.rs:62-162``, as
``noaa_apt_tpu/graph/debug.py:30-112`` ports it (``resample_with_filter``
and ``resample``).  Both rate regimes run kernel K1
(``ops/resample.polyphase_resample``): l > 1 as the polyphase resample,
l == 1 as the causal FIR decimated by m (``ops/resample.causal_tables``
over ``causal_input``, as ``DecodeTables`` does at l == 1).  The
``--export-resample-filtered`` grid and ``decode_with_steps`` wait for
the step-export slice: with ``context.export_resample_filtered`` set,
:func:`resample_with_filter` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import err
from ..core import Lowpass
from ..core.frequency import Freq, Rate
from ..io.context import Context
from ..ops import resample as rs
from .decode import _plan_resample_with_filter


def resample_with_filter(context: Context | None, signal: torch.Tensor, input_rate: Rate,
                         output_rate: Rate, filt) -> torch.Tensor:
    """``dsp::resample_with_filter`` (``dsp.rs:62-126``) of the f32
    ``signal`` on its device, with the reference's step calls."""
    if context is not None and context.export_resample_filtered:
        raise err.InternalError("--export-resample-filtered is not ported yet")
    l, m, coeff = _plan_resample_with_filter(input_rate, output_rate, filt)
    if context is not None:
        context.step_filter("resample_filter", coeff)
        # Sent always, so the expected-step slot advances (dsp.rs:281-285);
        # without the export flag the context drops it unread.
        context.step_signal("resample_filtered", np.zeros(0, np.float32),
                            Rate(input_rate.get_hz() * l))
    result = rs.polyphase_resample(*k1_inputs(signal, l, m, coeff))
    if context is not None and context.export_steps:  # the fetch only where a step is written
        context.step_signal("resample_decimated", result.cpu().numpy(), output_rate)
    return result


def k1_inputs(signal: torch.Tensor, l: int, m: int, coeff: np.ndarray):
    """The arguments ``(x, bank, p_c, s_c, m, out_len)`` of
    ``ops/resample.polyphase_resample`` that resample ``signal`` by l/m
    with the filter ``coeff``, on ``signal``'s device: the polyphase
    tables for l > 1 (``fast_resampling``, ``dsp.rs:186-289``); for
    l == 1 the causal FIR decimated by m (``dsp.rs:105-123``, 294-307),
    over ``causal_input``."""
    n = int(signal.shape[0])
    if l > 1:
        plan = rs.resample_plan(n, l, m, coeff)
        p_c, s_c, bank, _, _ = rs.phase_tables(plan)
        x, out_len = signal, plan.out_len
    else:
        p_c, s_c, bank = rs.causal_tables(coeff)
        x, out_len = rs.causal_input(signal, bank.shape[1]), n // m
    dev = signal.device
    return (x, torch.from_numpy(bank).to(dev), torch.from_numpy(p_c.astype(np.int32)).to(dev),
            torch.from_numpy(s_c.astype(np.int32)).to(dev), m, out_len)


def resample_lowpass(input_rate: Rate, output_rate: Rate, atten: float, delta_w: Freq) -> Lowpass:
    """The anti-aliasing filter of ``dsp::resample`` (``dsp.rs:132-162``):
    a lowpass cut at half the smaller rate."""
    low_hz = min(input_rate.get_hz(), output_rate.get_hz())
    return Lowpass(cutout=Freq.hz(low_hz / 2.0, input_rate), atten=atten, delta_w=delta_w)


def resample(context: Context | None, signal: torch.Tensor, input_rate: Rate, output_rate: Rate,
             atten: float, delta_w: Freq) -> torch.Tensor:
    """``dsp::resample`` (``dsp.rs:132-162``) with :func:`resample_lowpass`."""
    return resample_with_filter(context, signal, input_rate, output_rate,
                                resample_lowpass(input_rate, output_rate, atten, delta_w))
