"""Median of the CLI's WAV load (report["load_s"]) over the window's passes."""


def read(ctx):
    return ctx.median("load_s", 1e3)
