"""Median of the CLI's PNG save (report["save_s"]) over the window's passes."""


def read(ctx):
    return ctx.median("save_s", 1e3)
