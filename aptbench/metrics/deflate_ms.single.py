"""Median over the window's passes of the PNG's zlib deflate (span apt.png.deflate)."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.png.deflate"})
