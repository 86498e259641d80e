"""Median over the window's passes of the PNG's write to disk (span apt.png.write)."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.png.write"})
