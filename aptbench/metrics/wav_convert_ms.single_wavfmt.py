"""Median over the window's passes of the WAV's chunk walk, channel-0
take and float32 copy (span apt.wav.convert, inside the CLI's load); None
where the program has no such span."""

from aptbench.spans import median_ms

NAME = "apt.wav.convert"


def read(ctx):
    if ctx.trace is None or not any(n == NAME for n, _, _ in ctx.trace.host):
        return None
    return median_ms(ctx, {NAME})
