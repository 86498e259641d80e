"""Median over the window's fleet calls of the device thread's time blocked with
no loaded pass ready (span apt.fleet.wait_loader), per pass the call attempted."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.fleet.wait_loader"}, per_pass=True)
