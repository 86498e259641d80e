"""Median over the window's passes of the decoder's float32 copy of the
host samples before their upload (span apt.upload.cast, inside the
CLI's decode); None where the program has no such span."""

from aptbench.spans import median_ms

NAME = "apt.upload.cast"


def read(ctx):
    if ctx.trace is None or not any(n == NAME for n, _, _ in ctx.trace.host):
        return None
    return median_ms(ctx, {NAME})
