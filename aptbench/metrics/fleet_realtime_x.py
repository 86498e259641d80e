"""Recorded seconds of every pass whose PNG was written, over the wall
time of the window (first call's start to the end of the last call
started before the deadline)."""


def read(ctx):
    done = sum(p["recorded_s"] for p in ctx.passes if p["ok"])
    return done / ctx.window_s if ctx.window_s > 0 and done > 0 else None
