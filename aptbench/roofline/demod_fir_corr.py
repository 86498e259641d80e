"""K2, demod -> FIR -> sync correlation, per work sample: the demod's 8
operations (three products, the sum, the cosine term, the difference, the
root, the scale), two per FIR tap, one per template sample; the f32 input
read once, the filtered signal and the correlation written once."""

NAMES = ("demod_fir_corr_kernel",)
DEMOD_OPS = 8


def count(g: dict) -> tuple[float, float]:
    n = g["n_work"]
    flops = n * (DEMOD_OPS + 2.0 * g["fir_taps"] + g["sync_len"])
    return flops, 12.0 * n
