"""K1's float32 instantiations' share of their roofline over the traced
window (count in roofline/polyphase_resample_f32.py)."""


def read(ctx):
    return ctx.roofline(["polyphase_resample_f32"])
