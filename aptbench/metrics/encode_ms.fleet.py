"""Median of serve's per-pass encode time (FleetReport encode_s) over the window."""


def read(ctx):
    return ctx.median("encode_s", 1e3)
