"""Fused AM demod -> post-demod FIR -> sync correlation: kernel K2 and its twin.

Behavioral contract: the composition ``demodulate -> causal_filter ->
sync_correlate`` of ``noaa_apt_tpu`` (``dsp.rs:350-410``,
``decode.rs:225-234``), which ``noaa_apt_tpu/ops/pallas_stage.py``
fuses on the TPU:

    dem[t]  = demod_body(y[t-1], y[t]),  dem[0] = 0
    filt[t] = sum_{j<k} taps[j] * dem[t-j]     (dem[<0] = 0)
    corr[u] = sum_{j<g} tmpl[j] * filt[u+j]    (filt[>=n] = 0)

``filt`` and ``corr`` are both length ``n``; callers use
``corr[:n - g]`` (the reference drops the last window).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .demod import demodulate
from .sync import signed_sum


def _check(y, taps, tmpl):
    if y.dim() != 1 or y.dtype != torch.float32:
        raise ValueError(f"y must be a 1-D float32 tensor, got {y.dtype}{tuple(y.shape)}")
    if taps.dim() != 1 or taps.dtype != torch.float32 or taps.numel() == 0:
        raise ValueError("taps must be a non-empty 1-D float32 tensor")
    if tmpl.dim() != 1 or tmpl.dtype != torch.int8 or tmpl.numel() == 0:
        raise ValueError("tmpl must be a non-empty 1-D int8 tensor of +-1")
    if taps.device != y.device or tmpl.device != y.device:
        raise ValueError(f"all tensors must be on {y.device}")


def demod_fir_corr_plain(y, taps, tmpl, cosphi2, inv_sinphi):
    """The plain twin of kernel K2, one op per step in the kernel's
    order: the demod body, then ``taps[0]*dem + taps[1]*dem[-1] + ...``
    in ascending tap order, then the +-1 sum in ascending ``j``."""
    n = y.shape[0]
    dev = y.device
    dem = demodulate(y, cosphi2, inv_sinphi)
    k = taps.shape[0]
    dp = torch.cat([torch.zeros(k - 1, dtype=torch.float32, device=dev), dem])
    filt = taps[0] * dp[k - 1 : k - 1 + n]
    for j in range(1, k):
        filt = filt + taps[j] * dp[k - 1 - j : k - 1 - j + n]
    corr = signed_sum(filt, tmpl.tolist(), n)
    return filt, corr


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library("stage").demod_fir_corr
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def demod_fir_corr(y: torch.Tensor, taps: torch.Tensor, tmpl: torch.Tensor,
                   cosphi2, inv_sinphi) -> tuple[torch.Tensor, torch.Tensor]:
    """``y f32[n] -> (filt f32[n], corr f32[n])``.  ``inv_sinphi`` is the
    host-rounded reciprocal (``ops/demod.py:inv_sinphi``).

    A CUDA tensor launches kernel K2 (``csrc/stage.cu``); a CPU tensor
    runs the plain twin."""
    _check(y, taps, tmpl)
    if y.device.type == "cpu":
        return demod_fir_corr_plain(y, taps, tmpl, cosphi2, inv_sinphi)
    y, taps, tmpl = y.contiguous(), taps.contiguous(), tmpl.contiguous()
    n = y.shape[0]
    filt = torch.empty(n, dtype=torch.float32, device=y.device)
    corr = torch.empty(n, dtype=torch.float32, device=y.device)
    if n == 0:
        return filt, corr
    fn = _kernel()
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), n, taps.data_ptr(), taps.shape[0], tmpl.data_ptr(), tmpl.shape[0],
                float(np.float32(cosphi2)), float(np.float32(inv_sinphi)), filt.data_ptr(),
                corr.data_ptr(), torch.cuda.current_stream().cuda_stream)
    demod_fir_corr.launches += 1
    _build.check(rc, "demod_fir_corr")
    return filt, corr


demod_fir_corr.launches = 0
