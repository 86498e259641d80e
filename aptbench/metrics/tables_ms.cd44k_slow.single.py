"""Median over the window's passes of the per-call table builds: the
decoder's design and upload of its tables (span apt.tables) and K1's
fetch of the bank, variant table build and upload (span apt.k1.table),
inside the CLI's decode; None where the program has neither span."""

from aptbench.spans import median_ms

NAMES = {"apt.tables", "apt.k1.table"}


def read(ctx):
    if ctx.trace is None or not any(n in NAMES for n, _, _ in ctx.trace.host):
        return None
    return median_ms(ctx, NAMES)
