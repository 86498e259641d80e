"""K1 on float32 samples (the float WAVs' channel 0): the operations of
``polyphase_resample.py``, two per non-zero tap of each output; each
4-byte input sample read once, each f32 output written once.  The
harness's geometry gives ``in_bytes`` 2 for every cell, so the input's
width is fixed here.  ``NAMES`` match only the kernels' float
instantiations (``block_kernel<float, ...>``; an int16 one is
``<short, ...>``)."""

NAMES = ("polyphase_kernel<float", "block_kernel<float", "class_kernel<float")


def count(g: dict) -> tuple[float, float]:
    flops = 2.0 * g["taps_per_output"] * g["n_work"]
    return flops, 4.0 * g["n_in"] + 4.0 * g["n_work"]
