"""Median over the window's passes of the WAV file's read into memory
(span apt.wav.read, inside the CLI's load); None where the program has
no such span."""

from aptbench.spans import median_ms

NAME = "apt.wav.read"


def read(ctx):
    if ctx.trace is None or not any(n == NAME for n, _, _ in ctx.trace.host):
        return None
    return median_ms(ctx, {NAME})
