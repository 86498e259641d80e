"""Median over the window's passes of the WAV's bytes as the CLI read them
(report["wav_bytes"]) per sample of channel 0: 8.0 and a header's few
bytes for stereo 32-bit float, 2.0 for mono 16-bit; None where the CLI
reports no such counter."""

import numpy as np


def read(ctx):
    vals = [p["wav_bytes"] / p["n_samples"] for p in ctx.passes if p["ok"] and p.get("wav_bytes")]
    return float(np.median(vals)) if vals else None
