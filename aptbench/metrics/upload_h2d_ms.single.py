"""Median over the window's passes of the decoder's copy of the samples to the
card, as the host waits on it (span apt.upload.h2d)."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.upload.h2d"})
