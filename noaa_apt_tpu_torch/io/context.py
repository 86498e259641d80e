"""Progress reporting and intermediate-step export.

Behavioral contract: reference ``src/context.rs``, as
``noaa_apt_tpu/io/context.py`` ports it (a copy).  ``Context`` carries
a UI progress callback and, when ``--wav-steps`` is on, writes every
intermediate signal/filter as numbered WAV files matched by id against
a per-mode ordered metadata table (4 steps for resample, 17 for
decode).  Unknown or out-of-order step ids are ignored, exactly as the
reference does (``context.rs:137-155``).

In the port, the decode steps 0-11 come from
``graph/debug.decode_with_steps`` (``--wav-steps``) and the telemetry
steps 12-16 from ``post/telemetry``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .. import PX_PER_ROW, err
from ..core.frequency import Rate
from . import wav

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class StepMetadata:
    description: str
    id: str
    filename: str
    variant: str  # "signal" | "filter"
    rate: Optional[Rate] = None


def _resample_steps() -> list[StepMetadata]:
    return [
        StepMetadata("Samples read from WAV", "input", "00_input", "signal"),
        StepMetadata("Filter used on resample", "resample_filter", "01_resample_filter", "filter"),
        StepMetadata("Expanded and filtered signal", "resample_filtered", "02_resample_filtered", "signal"),
        StepMetadata("Result of resample", "resample_decimated", "03_resample_result", "signal"),
    ]


def _decode_steps(work_rate: Rate, final_rate: Rate) -> list[StepMetadata]:
    telemetry_rate = Rate(final_rate.get_hz() // PX_PER_ROW)
    return [
        StepMetadata("Samples read from WAV", "input", "00_input", "signal"),
        StepMetadata("Filter used on first resample", "resample_filter", "01_resample_filter", "filter"),
        StepMetadata("Expanded and filtered on first resample", "resample_filtered", "02_resample_filtered", "signal"),
        StepMetadata("Result of first resample", "resample_decimated", "03_resample_decimated", "signal"),
        StepMetadata("Raw demodulated signal", "demodulation_result", "04_demodulated_unfiltered", "signal", work_rate),
        StepMetadata("Filter for demodulated signal", "filter_filter", "05_demodulation_filter", "filter"),
        StepMetadata("Filtered demodulated signal", "filter_result", "06_demodulated", "signal", work_rate),
        StepMetadata("Cross correlation used in syncing", "sync_correlation", "07_sync_correlation", "signal", work_rate),
        StepMetadata("Synced signal", "sync_result", "08_synced", "signal"),
        StepMetadata("Filter used on second resample", "resample_filter", "09_resample_filter", "filter"),
        StepMetadata("Expanded and filtered on second resample", "resample_filtered", "10_resample_filtered", "signal", final_rate),
        StepMetadata("Result of second resample", "resample_decimated", "11_resample_decimated", "signal", final_rate),
        StepMetadata("Telemetry A horizontal averages", "telemetry_a", "12_telemetry_a", "signal", telemetry_rate),
        StepMetadata("Telemetry B horizontal averages", "telemetry_b", "13_telemetry_b", "signal", telemetry_rate),
        StepMetadata("Correlation of telemetry with sample", "telemetry_correlation", "14_telemetry_correlation", "signal", telemetry_rate),
        StepMetadata("Horizontal variance of telemetry bands", "telemetry_variance", "15_telemetry_variance", "signal", telemetry_rate),
        StepMetadata("Telemetry quality estimation", "telemetry_quality", "16_telemetry_quality", "signal", telemetry_rate),
    ]


class Context:
    """Tracks progress + exports ordered intermediate steps."""

    def __init__(
        self,
        steps_metadata: list[StepMetadata],
        ui_callback: Callable[[float, str], None],
        export_wav: bool,
        export_resample_filtered: bool,
        output_dir: Path | str = ".",
    ):
        self.steps_metadata = steps_metadata
        # Public flag name matches the reference (context.rs:108); the
        # reference keeps a second private export_wav that is always
        # equal — one attribute is enough here.
        self.export_steps = export_wav
        self.export_resample_filtered = export_resample_filtered
        self._index = 0
        self._ui_callback = ui_callback
        self.output_dir = Path(output_dir)

    @classmethod
    def resample(
        cls, ui_callback=lambda p, d: None, export_wav=False,
        export_resample_filtered=False, output_dir=".",
    ) -> "Context":
        return cls(_resample_steps(), ui_callback, export_wav, export_resample_filtered, output_dir)

    @classmethod
    def decode(
        cls, ui_callback=lambda p, d: None, work_rate: Rate = Rate(12480),
        final_rate: Rate = Rate(4160), export_wav=False,
        export_resample_filtered=False, output_dir=".",
    ) -> "Context":
        return cls(_decode_steps(work_rate, final_rate), ui_callback, export_wav, export_resample_filtered, output_dir)

    # ------------------------------------------------------------------
    def status(self, progress: float, description: str) -> None:
        self._ui_callback(progress, description)

    def step(self, variant: str, step_id: str, signal, rate: Rate | None = None) -> None:
        """Export one step (context.rs:132-211 semantics: match ids
        against the expected ordered list, ignore unknown ids)."""
        if not self.export_steps:
            return
        log.debug("Got step: %s", step_id)
        if self._index >= len(self.steps_metadata):
            log.debug('Ignoring step "%s", no more steps expected', step_id)
            return
        metadata = self.steps_metadata[self._index]
        if step_id != metadata.id:
            log.debug('Ignoring step "%s", expecting "%s"', step_id, metadata.id)
            return
        self._index += 1

        if not self.export_resample_filtered and step_id == "resample_filtered":
            log.debug('Ignoring step "resample_filtered", disabled by options')
            return
        if variant != metadata.variant:
            raise err.InternalError(
                f"Expected variant {metadata.variant!r}, got {variant!r}"
            )
        signal = np.asarray(signal, dtype=np.float32).reshape(-1)
        if signal.size == 0:
            # Happens when syncing is disabled and the dummy correlation
            # step is sent (context.rs:169-171).
            return

        if variant == "filter":
            spec = wav.WavSpec(1, 1, 32, "float")
        else:
            r = rate or metadata.rate
            if r is None:
                raise err.InternalError(f'Unknown rate for step "{step_id}"')
            spec = wav.WavSpec(1, r.get_hz(), 32, "float")
        path = self.output_dir / f"{metadata.filename}.wav"
        wav.write_wav(path, signal, spec)

    # Convenience wrappers used by pipeline code.
    def step_signal(self, step_id: str, signal, rate: Rate | None = None) -> None:
        self.step("signal", step_id, signal, rate)

    def step_filter(self, step_id: str, coeff) -> None:
        self.step("filter", step_id, coeff)
