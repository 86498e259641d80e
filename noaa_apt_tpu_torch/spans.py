"""Named spans at the port's layer boundaries, on the profiler's clock.

``with span("apt.save") as s: ...`` keeps the interval's host
``perf_counter`` seconds (``s.start``, ``s.end``, ``s.seconds``), which the
CLI's report and :class:`serve.FleetReport` read.  While a ``torch.profiler``
records, the span also enters ``torch.profiler.record_function(name)``, so
the interval shows in the trace on the clock of the card's events.  With no
profiler on, a span costs a flag read and two clock reads.

A profiler records a thread's spans only where it was started on that
thread, unless it was started with ``profile_all_threads`` (``cli
--profile-trace`` asks for it where the installed torch has the option).

Every name starts with ``apt.``; none may be ``pass`` or ``fleet_call``,
which name the benchmark's own call spans.
"""

from __future__ import annotations

import time

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function


def profiling() -> bool:
    """Whether a ``torch.profiler`` is recording (True where this torch
    has no such flag, so a span is then always recorded)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", True)


class span:
    """A context manager: the host seconds of its body, and a
    ``record_function`` range of the same name while a profiler records."""

    __slots__ = ("name", "start", "end", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = 0.0
        self._range = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def __enter__(self) -> "span":
        if profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
