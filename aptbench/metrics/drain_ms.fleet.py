"""Median over the window's fleet calls of the drain: from the last dispatch to the
encoders' and loaders' join (span apt.fleet.drain), per call."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.fleet.drain"})
