"""90th percentile (nearest rank) of the wall time of one cli.main call
over all passes of the window; a failed pass counts as over any limit."""

from aptbench.stats import percentile

FAILED_MS = 1e12


def read(ctx):
    ms = [p["wall_s"] * 1e3 if p["ok"] else FAILED_MS for p in ctx.passes]
    return percentile(ms, 90) if ms else None
