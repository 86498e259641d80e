"""The program's own spans (``apt.*``, ``noaa_apt_tpu_torch/spans.py``) in a
traced window: each is given to the harness's call span (``pass`` or
``fleet_call``) that holds its start, and summed per call.  A window with
no ``apt.*`` span at all (a program without them, such as an older
commit) reads None; in a window that has them, a span that never
happened (a wait that did not occur) reads 0."""

from __future__ import annotations

import bisect

import numpy as np

CALL_LABELS = ("pass", "fleet_call")


def per_call_s(ctx, names) -> list | None:
    """Seconds of the host events named in ``names``, summed within each
    call of the window, in call order; None where the trace holds no
    ``apt.*`` span."""
    if ctx.trace is None or not any(n.startswith("apt.") for n, _, _ in ctx.trace.host):
        return None
    calls = sorted((a, b) for n, a, b in ctx.trace.host if n in CALL_LABELS)
    starts = [a for a, _ in calls]
    sums = [0] * len(calls)
    for n, a, b in ctx.trace.host:
        if n not in names:
            continue
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < calls[i][1]:
            sums[i] += b - a
    return [s / 1e9 for s in sums]


def median_ms(ctx, names, per_pass: bool = False) -> float | None:
    """Median over the window's calls of the spans' milliseconds a call,
    or with ``per_pass`` a pass: each call's sum over the passes it
    attempted (a fleet call attempts every pass of the pool)."""
    sums = per_call_s(ctx, names)
    if not sums:
        return None
    each = len(ctx.passes) / len(sums) if per_pass else 1
    return float(np.median(sums)) * 1e3 / each
