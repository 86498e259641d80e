"""K1, the polyphase resample: the work the algorithm needs, whatever
implements it: two operations per non-zero tap of each output, each input
sample read once, each f32 output written once."""

NAMES = ("polyphase_kernel", "block_kernel", "class_kernel")


def count(g: dict) -> tuple[float, float]:
    flops = 2.0 * g["taps_per_output"] * g["n_work"]
    n_bytes = g["in_bytes"] * g["n_in"] + 4.0 * g["n_work"]
    return flops, n_bytes
