"""100 x (1 - the union of the card's kernel, copy and memset events over
the traced window of back-to-back fleet calls)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
