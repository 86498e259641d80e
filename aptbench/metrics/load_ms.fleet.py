"""Median of serve's per-pass load time (FleetReport load_s) over the window."""


def read(ctx):
    return ctx.median("load_s", 1e3)
