"""Median over the window's passes of the host's time blocked on the card: K3's
peak list (span apt.wait.peaks) and the u8 rows' fetch (apt.wait.rows)."""

from aptbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, {"apt.wait.peaks", "apt.wait.rows"})
