"""Greedy sync-peak selection: kernel K3 and its twin.

Behavioral contract: reference ``src/decode.rs:236-254``, as selected
peak-for-peak identically by ``noaa_apt_tpu/ops/sync.py:find_sync_peaks``
and ``noaa_apt_tpu/ops/pallas_select.py:select_peaks(_batch)``:

- the seed is ``(p, v) = (0, max(corr[0], 0))`` with one peak at 0;
- replacement: while the first-occurrence argmax ``q`` of
  ``corr(p, p+md]`` beats ``v`` strictly, move the last peak to ``q``;
- otherwise force-append ``i0 = max(p+md+1, spr*(k+1))`` exactly
  ``i0//spr - k`` times, continuing from ``(i0, corr[i0])``; stop once
  ``i0 >= n_valid``.

Positions at or past ``n_valid`` never take part.  Returns int32
``peaks[B, max_peaks]`` (zero past ``k``) and ``k[B]``; a selection that
would pass ``max_peaks`` raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build


def _check(corr, n_valid: np.ndarray, spr: int, md: int, max_peaks: int):
    if corr.dim() != 2 or corr.dtype != torch.float32:
        raise ValueError(f"corr must be a 2-D float32 tensor [B, L], got {corr.dtype}{tuple(corr.shape)}")
    if n_valid.shape != (corr.shape[0],):
        raise ValueError(f"n_valid must hold one length per row ({corr.shape[0]})")
    if (n_valid < 0).any() or (n_valid > corr.shape[1]).any():
        raise ValueError(f"n_valid must lie in [0, {corr.shape[1]}]")
    if spr <= 0 or md <= 0 or max_peaks < 1:
        raise ValueError(f"bad selector parameters spr={spr} md={md} max_peaks={max_peaks}")


def _overflow(b: int, max_peaks: int) -> RuntimeError:
    return RuntimeError(f"sync selection of row {b} exceeds max_peaks={max_peaks}")


def select_peaks_plain(corr: torch.Tensor, n_valid, spr: int, md: int, max_peaks: int):
    """The plain twin of kernel K3: the jump loop of
    ``noaa_apt_tpu/ops/sync.py:98-124`` over torch tensors, one row at a
    time (``torch.argmax`` returns the first occurrence)."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    B = corr.shape[0]
    peaks = torch.zeros((B, max_peaks), dtype=torch.int32)
    ks = torch.zeros(B, dtype=torch.int32)
    for b in range(B):
        row = corr[b]
        n = int(n_valid[b])
        out = [0]
        p, v = 0, (max(float(row[0]), 0.0) if n > 0 else 0.0)
        while True:
            while True:
                lo, hi = p + 1, min(p + md + 1, n)
                if lo >= hi:
                    break
                w = row[lo:hi]
                q = int(torch.argmax(w))
                m = float(w[q])
                if not m > v:
                    break
                p, v = lo + q, m
                out[-1] = p
            k = len(out)
            i0 = max(p + md + 1, spr * (k + 1))
            if i0 >= n:
                break
            appended = i0 // spr - k
            if k + appended > max_peaks:
                raise _overflow(b, max_peaks)
            out.extend([i0] * appended)
            p, v = i0, float(row[i0])
        peaks[b, : len(out)] = torch.tensor(out, dtype=torch.int32)
        ks[b] = len(out)
    return peaks.to(corr.device), ks.to(corr.device)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library("select").select_peaks
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def select_peaks(corr: torch.Tensor, n_valid, spr: int, md: int, max_peaks: int):
    """``corr f32[B, L]`` + host lengths ``n_valid[B]`` ->
    ``(peaks i32[B, max_peaks], k i32[B])`` on ``corr``'s device.

    A CUDA tensor launches kernel K3 (``csrc/select.cu``, one CTA per
    row); a CPU tensor runs the plain twin."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    _check(corr, n_valid, spr, md, max_peaks)
    if corr.device.type == "cpu":
        return select_peaks_plain(corr, n_valid, spr, md, max_peaks)
    if corr.stride(1) != 1:
        corr = corr.contiguous()
    dev = corr.device
    B = corr.shape[0]
    nv = torch.from_numpy(n_valid.astype(np.int32)).to(dev)
    peaks = torch.zeros((B, max_peaks), dtype=torch.int32, device=dev)
    ks = torch.empty(B, dtype=torch.int32, device=dev)
    ovf = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return peaks, ks
    fn = _kernel()
    with torch.cuda.device(dev):
        rc = fn(corr.data_ptr(), corr.stride(0), B, nv.data_ptr(), spr, md, max_peaks,
                peaks.data_ptr(), ks.data_ptr(), ovf.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    select_peaks.launches += 1
    _build.check(rc, "select_peaks")
    bad = np.flatnonzero(ovf.cpu().numpy())
    if bad.size:
        raise _overflow(int(bad[0]), max_peaks)
    return peaks, ks


select_peaks.launches = 0
