"""K1's share of its roofline over the traced window."""


def read(ctx):
    return ctx.roofline(["polyphase_resample"])
