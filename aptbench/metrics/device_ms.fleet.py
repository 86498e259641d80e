"""Median of serve's per-pass device-thread time (FleetReport device_s) over the window."""


def read(ctx):
    return ctx.median("device_s", 1e3)
