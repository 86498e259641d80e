"""K1-K3 together: the sum of their bounds over the sum of their measured
device times in the traced window."""


def read(ctx):
    return ctx.roofline(["polyphase_resample", "demod_fir_corr", "select_peaks"])
