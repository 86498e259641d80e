"""Median over the window's fleet calls of the device thread's time blocked on a
full encode queue (span apt.fleet.wait_encoder), per pass the call attempted."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.fleet.wait_encoder"}, per_pass=True)
