"""The reference's eager resample (``dsp::resample``) and the
step-exporting decode (``--wav-steps``, ``--export-resample-filtered``).

Behavioral contract: reference ``src/dsp.rs:62-162`` and
``src/decode.rs:43-162`` with every ``Context::step`` call in order, as
``noaa_apt_tpu/graph/debug.py`` ports them (``resample_with_filter``,
``resample``, ``decode_with_steps``).  Every resample runs kernel K1
(``ops/resample.polyphase_resample``): l > 1 as the polyphase resample,
or with ``--export-resample-filtered`` as K1 at m = 1
(``ops/resample.expanded_filtered``) cut to the reference's export grid;
l == 1 as the causal FIR decimated by m (``ops/resample.causal_tables``
over ``causal_input``, as ``DecodeTables`` does at l == 1).  The decode
runs K2 (``ops/stage.demod_fir_corr``) for the filter and correlation
steps and K3 (``ops/select.select_peaks``) for the sync positions; the
``demodulation_result`` step alone comes from the plain demod
(``ops/demod.demodulate``), which rounds as K2's demod does.  A step is
fetched from the device only where the context writes it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import FINAL_RATE, PX_PER_ROW, err
from ..core import Lowpass, NoFilter
from ..core.frequency import Freq, Rate
from ..core.profiles import DecodeProfile
from ..device import resolve_device
from ..io.context import Context
from ..ops import demod as dm
from ..ops import resample as rs
from ..ops import sync as sy
from ..ops.select import select_peaks
from ..ops.stage import demod_fir_corr
from .decode import _TOO_SHORT, _chain_design, _check_sync_count, _ingest_filter, _plan_resample_with_filter

_EMPTY = np.zeros(0, np.float32)


def _writes(context: Context | None) -> bool:
    """Whether ``context`` writes the steps it is sent."""
    return context is not None and context.export_steps


def resample_with_filter(context: Context | None, signal: torch.Tensor, input_rate: Rate,
                         output_rate: Rate, filt) -> torch.Tensor:
    """``dsp::resample_with_filter`` (``dsp.rs:62-126``) of the
    ``signal`` (f32 or i16) on its device, with the reference's step
    calls.  With ``context.export_resample_filtered`` and l > 1 the
    result lies on the reference's export grid (``dsp.rs:265-276``): the
    expanded, filtered signal at ``t = first, first + m, ...`` with
    ``first = offset + (m - 1 - offset) mod m``, not at ``offset + k*m``,
    so the flag changes the decoded samples, as in the reference."""
    l, m, coeff = _plan_resample_with_filter(input_rate, output_rate, filt)
    export = context is not None and context.export_resample_filtered
    write = _writes(context) and export  # the resample_filtered step is written
    if context is not None:
        context.step_filter("resample_filter", coeff)
    if l > 1:
        ef = rs.expanded_filtered(signal, l, coeff) if export else None
        if context is not None:
            # Sent always, so the expected-step slot advances (dsp.rs:281-285);
            # without the export flag the context drops it unread.
            context.step_signal("resample_filtered", ef.cpu().numpy() if write else _EMPTY,
                                Rate(input_rate.get_hz() * l))
        if export:
            offset = (len(coeff) - 1) // 2
            first = offset + ((m - 1 - offset) % m)
            result = ef[first - offset :: m]
        else:
            result = rs.polyphase_resample(*k1_inputs(signal, l, m, coeff))
    elif write:
        # The full-rate causal FIR is K1 at m = 1; every m-th output of it is
        # the decimated launch's, bit for bit (each keeps its taps and order).
        filtered = rs.polyphase_resample(*k1_inputs(signal, l, 1, coeff))
        context.step_signal("resample_filtered", filtered.cpu().numpy(), input_rate)
        n = int(signal.shape[0])
        result = filtered[: n // m * m : m]
    else:
        if context is not None:
            context.step_signal("resample_filtered", _EMPTY, input_rate)
        result = rs.polyphase_resample(*k1_inputs(signal, l, m, coeff))
    if _writes(context):  # the fetch only where a step is written
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


def decode_with_steps(context: Context, profile: DecodeProfile, signal, input_rate: Rate,
                      sync: bool = True, device=None) -> tuple[np.ndarray, list[int] | None]:
    """Step-exporting decode on ``device`` (default ``"cuda"``; raises
    without CUDA unless ``"cpu"``) -> ``(flat, sync_pos)``: the flat
    FINAL_RATE signal, one float per pixel, and the sync positions (None
    without sync).  The same stages, status calls, steps and errors as
    ``noaa_apt_tpu/graph/debug.py:decode_with_steps``, which returns the
    signal alone."""
    dev = resolve_device(device)
    final_rate, work_rate = Rate(FINAL_RATE), Rate(profile.work_rate)
    spr = PX_PER_ROW * profile.work_rate // FINAL_RATE
    write = context.export_steps

    context.step_signal("input", signal, input_rate)
    context.status(0.1, f"Resampling to {work_rate.get_hz()}")
    # A copy where the samples are a read-only or unaligned map (io/wav.load_device_ready).
    x = torch.from_numpy(np.require(signal, np.float32, ["C", "A", "W"])).to(dev)
    x = resample_with_filter(context, x, input_rate, work_rate, _ingest_filter(profile, input_rate))
    n = int(x.shape[0])
    if n < 10 * spr:
        raise err.InternalError(_TOO_SHORT)

    taps, template, cosphi2, sinphi = _chain_design(profile)
    inv = dm.inv_sinphi(sinphi)
    context.status(0.4, "Demodulating")
    if write:
        context.step_signal("demodulation_result", dm.demodulate(x, cosphi2, inv).cpu().numpy(), None)

    context.status(0.42, "Filtering")
    context.step_filter("filter_filter", taps)
    filt, corr = demod_fir_corr(x.contiguous(), torch.from_numpy(taps).to(dev),
                                torch.from_numpy(template).to(dev), cosphi2, inv)
    if write:
        context.step_signal("filter_result", filt.cpu().numpy(), None)

    if sync:
        context.status(0.5, "Syncing")
        n_corr = max(0, n - len(template))  # the reference drops the last window
        if write:
            context.step_signal("sync_correlation", corr[:n_corr].cpu().numpy(), None)
        _, md, max_peaks = sy.selector_params(n_corr, work_rate)
        _, lists = select_peaks(corr[None, :], [n_corr], spr, md, max_peaks, to_host=True)
        sync_pos = lists[0]
        bad = _check_sync_count(sync_pos)
        if bad is not None:
            raise bad
        rows = torch.tensor([p for p in sync_pos[:-1] if p + spr < n], dtype=torch.int64, device=dev)
        x = filt[(rows[:, None] + torch.arange(spr, device=dev)[None, :]).reshape(-1)]
    else:
        sync_pos = None
        context.status(0.5, "Skipping Syncing")
        context.step_signal("sync_correlation", _EMPTY, work_rate)
        x = filt[: n // spr * spr]
    if write:
        context.step_signal("sync_result", x.cpu().numpy(), work_rate)

    context.status(0.90, "Resampling to 4160")
    return resample_with_filter(context, x, work_rate, final_rate, NoFilter()).cpu().numpy(), sync_pos
