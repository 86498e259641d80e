"""WAV -> WAV resampling tool (``-r``).

Behavioral contract: reference ``src/resample.rs`` — load, resample
with a lowpass at half the smaller rate, write 16-bit WAV, copy the
modification timestamp — as ``noaa_apt_tpu/graph/resample_tool.py``
ports it, with the same status strings and progress fractions.  The
resample runs on ``device`` (the card by default) through kernel K1
(``graph/debug.resample``) on the f32 samples that ``load_wav`` gives; a
context with ``export_wav`` writes the reference's resample steps, and
with ``export_resample_filtered`` the resample takes the export grid.
"""

from __future__ import annotations

import logging

import torch

from .. import err
from ..core.frequency import Freq, Rate
from ..device import resolve_device
from ..io import wav
from ..io.context import Context
from ..io.misc import read_timestamp, write_timestamp
from . import debug

log = logging.getLogger(__name__)

_EMPTY_OUTPUT = (
    "Got zero samples after resampling, audio file too short or "
    "output sampling frequency too low"
)


def _announce(context: Context, fraction: float, status: str, info: str | None = None):
    """One log line + one progress tick, as the reference pairs
    ``info!`` with ``context.status`` (resample.rs:24-63).  The log
    text differs from the status line only where the reference's does
    (the resample stage logs without the target rate)."""
    if info != "":
        log.info(info if info is not None else status)
    context.status(fraction, status)


def resample(context: Context, settings, input_filename, output_filename, output_rate: int,
             device=None) -> None:
    """Resample ``input_filename`` to ``output_rate`` Hz into
    ``output_filename`` on ``device`` (default ``"cuda"``; raises without
    CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    out_rate = Rate(output_rate)

    _announce(context, 0.0, "Reading WAV file")
    signal, spec = wav.load_wav(input_filename)
    mtime = read_timestamp(input_filename)
    context.step_signal("input", signal, Rate(spec.sample_rate))

    _announce(context, 0.2, f"Resampling to {output_rate}", "Resampling")
    out = debug.resample(
        context,
        torch.from_numpy(signal).to(dev),
        Rate(spec.sample_rate),
        out_rate,
        settings.wav_resample_atten,
        Freq.from_pi_rad(settings.wav_resample_delta_freq),
    ).cpu().numpy()
    if not out.size:
        raise err.InternalError(_EMPTY_OUTPUT)

    _announce(context, 0.8, f"Writing WAV to '{output_filename}'")
    wav.write_wav(output_filename, out, wav.WavSpec(1, output_rate, 16, "int"))
    write_timestamp(mtime, output_filename)
    _announce(context, 1.0, "Finished", "")
