"""Median of the decoder's upload stage (report["stage_ms"]["upload"],
CUDA events) over the window's passes."""

import numpy as np


def read(ctx):
    vals = [p["stage_ms"]["upload"] for p in ctx.passes if p["ok"] and "upload" in p["stage_ms"]]
    return float(np.median(vals)) if vals else None
