"""Median over the window's passes of the sum of the decoder's stages
other than the upload (report["stage_ms"], CUDA events)."""

import numpy as np


def read(ctx):
    vals = [sum(v for k, v in p["stage_ms"].items() if k != "upload")
            for p in ctx.passes if p["ok"] and p["stage_ms"]]
    return float(np.median(vals)) if vals else None
