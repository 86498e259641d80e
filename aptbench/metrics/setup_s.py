"""Seconds from the process's start to the first timed call."""


def read(ctx):
    return ctx.setup_s
