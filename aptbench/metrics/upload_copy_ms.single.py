"""Median over the window's passes of the decoder's host copy out of the WAV's
read-only memmap before the upload (span apt.upload.copy)."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.upload.copy"})
