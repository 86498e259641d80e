"""K3's (summary and walk) share of its roofline over the traced window."""


def read(ctx):
    return ctx.roofline(["select_peaks"])
