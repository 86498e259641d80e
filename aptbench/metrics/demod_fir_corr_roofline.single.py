"""K2's share of its roofline over the traced window."""


def read(ctx):
    return ctx.roofline(["demod_fir_corr"])
