"""The plain reference decoder: WAV samples -> sync positions -> u8 rows.

Upstream noaa-apt's decode (``src/decode.rs``, ``src/dsp.rs``,
``src/misc.rs``) written out in plain PyTorch, op by op, in the
precision asked for: float64 for the reference, a lower one (bfloat16)
for the control that has to fail the comparison.  The steps:

1. the L/M polyphase resample to the work rate (DC-removal lowpass),
   ``y[k] = sum_i bank[p_k, i] * x[x0_k + i]``, ``x`` read as 0 past its
   end; for ``l == 1`` the causal FIR decimated by ``m``;
2. AM demod, ``sqrt(y[t-1]^2 + y[t]^2 - y[t-1] y[t] 2cos(phi)) / sin(phi)``
   with ``dem[0] = 0`` (``phi`` doubled, as upstream);
3. the post-demod lowpass, causal: ``filt[t] = sum_j taps[j] dem[t-j]``;
4. the +-1 sync A correlation ``corr[u] = sum_j tmpl[j] filt[u+j]`` over
   ``u < n - g``;
5. the greedy peak walk (on the host, in float64 or the control's dtype
   widened exactly);
6. rows at every peak but the last that fits a whole row, decimated to
   4160 Hz, with upstream's ``img[0, 0] = 0``;
7. the 98 % levels from the 1000-bucket scan, and the u8 map (round half
   up, NaN to 0).

It imports nothing of the program under test and takes nothing it made:
only the samples and the configuration.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dsp


@dataclass
class Decoded:
    """A reference decode: the u8 rows and what a judge needs to look for
    a row elsewhere in the signal."""

    u8: torch.Tensor  # [rows, 2080] uint8
    filt: torch.Tensor  # the filtered work signal, in the decode's dtype
    peaks: list  # greedy sync positions
    work_len: int
    spr: int
    m_final: int
    low: float
    high: float


def resample(x: torch.Tensor, t: dsp.Tables, dtype, chunk: int = 1 << 22) -> torch.Tensor:
    """Step 1: ``x`` (raw sample values) at the work rate, in ``dtype``."""
    dev = x.device
    n = x.shape[0]
    out_len = t.work_len(n)
    xp = torch.cat([x.to(dtype), torch.zeros(1, dtype=dtype, device=dev)])
    if t.l == 1:
        # y[n] = sum_{j < min(K, n m)} coeff[j] x[n m - j]
        coeff = torch.from_numpy(t.coeff).to(dev, dtype)
        y = torch.zeros(out_len, dtype=dtype, device=dev)
        base = torch.arange(out_len, device=dev) * t.m
        for j in range(coeff.shape[0]):
            idx = base - j
            ok = idx >= 1
            y = y + torch.where(ok, coeff[j] * xp[idx.clamp(min=0)], torch.zeros_like(y))
        return y
    p_c, s_c, bank = t.bank()
    bank = torch.from_numpy(bank).to(dev, dtype)
    pc = torch.from_numpy(p_c).to(dev)
    sc = torch.from_numpy(s_c).to(dev)
    y = torch.empty(out_len, dtype=dtype, device=dev)
    for a in range(0, out_len, chunk):
        k = torch.arange(a, min(out_len, a + chunk), device=dev)
        c = k % t.l
        p = pc[c]
        x0 = sc[c] + (k // t.l) * t.m
        acc = torch.zeros(k.shape[0], dtype=dtype, device=dev)
        for i in range(bank.shape[1]):
            acc = acc + bank[p, i] * xp[torch.clamp(x0 + i, max=n)]
        y[a : a + k.shape[0]] = acc
    return y


def demod_filter_correlate(y: torch.Tensor, t: dsp.Tables):
    """Steps 2-4 -> ``(filt, corr)``, both of ``y``'s length (``corr``
    past ``n - g`` is not used)."""
    dtype, dev = y.dtype, y.device
    n = y.shape[0]
    cosphi2 = torch.tensor(float(t.cosphi2), dtype=dtype, device=dev)
    sinphi = torch.tensor(float(t.sinphi), dtype=dtype, device=dev)
    prev, curr = y[:-1], y[1:]
    body = prev * prev + curr * curr - prev * curr * cosphi2
    body = torch.clamp(body, min=0)
    dem = torch.cat([torch.zeros(min(1, n), dtype=dtype, device=dev), torch.sqrt(body) / sinphi])
    taps = torch.from_numpy(t.taps).to(dev, dtype)
    filt = torch.zeros(n, dtype=dtype, device=dev)
    for j in range(taps.shape[0]):
        if j >= n:
            break
        filt[j:] = filt[j:] + taps[j] * dem[: n - j]
    g = t.template.shape[0]
    fp = torch.cat([filt, torch.zeros(g, dtype=dtype, device=dev)])
    corr = torch.zeros(n, dtype=dtype, device=dev)
    for j, s in enumerate(t.template.tolist()):
        corr = corr + fp[j : j + n] if s > 0 else corr - fp[j : j + n]
    return filt, corr


def greedy_peaks(corr: np.ndarray, n_valid: int, spr: int, md: int, max_peaks: int) -> list:
    """Step 5, upstream's greedy walk (``decode.rs``) in its jump form:
    from the seed ``(0, max(corr[0], 0))``, move the last peak to the
    first maximum of ``corr(p, p + md]`` while that beats it strictly;
    else force-append ``i0 = max(p + md + 1, spr (k + 1))`` as many times
    as rows were skipped, and go on from ``i0``; stop once ``i0`` reaches
    ``n_valid``."""
    out = [0]
    p, v = 0, (max(float(corr[0]), 0.0) if n_valid > 0 else 0.0)
    while True:
        while True:
            lo, hi = p + 1, min(p + md + 1, n_valid)
            if lo >= hi:
                break
            w = corr[lo:hi]
            q = int(np.argmax(w))
            if not w[q] > v:
                break
            p, v = lo + q, float(w[q])
            out[-1] = p
        k = len(out)
        i0 = max(p + md + 1, spr * (k + 1))
        if i0 >= n_valid:
            return out
        appended = i0 // spr - k
        if k + appended > max_peaks:
            raise RuntimeError(f"sync selection exceeds {max_peaks} peaks")
        out.extend([i0] * appended)
        p, v = i0, float(corr[i0])


def rows_at(filt: torch.Tensor, pos: torch.Tensor, spr: int, m_final: int) -> torch.Tensor:
    """Rows of 2080 pixels starting at work samples ``pos``."""
    cols = torch.arange(0, spr, m_final, device=filt.device)
    idx = pos.to(torch.int64)[:, None] + cols[None, :]
    return filt[idx.clamp(max=filt.shape[0] - 1)]


def percent_levels(img: torch.Tensor, pct: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 7's levels: the first of 1000 buckets of ``[min, max]`` whose
    cumulative share passes ``(1 - pct)/2``, and the first that passes
    ``1 - (1 - pct)/2`` (one further where both are the same bucket)."""
    mn, mx = img.min(), img.max()
    rng = mx - mn
    bidx = torch.nan_to_num(torch.trunc((img - mn) / rng * 1000.0), nan=0.0).clamp(0, 999)
    counts = torch.bincount(bidx.to(torch.int64).reshape(-1), minlength=1000)
    frac = torch.cumsum(counts, 0).to(torch.float64) / img.numel()
    remainder = float(np.float32((np.float32(1.0) - np.float32(pct)) / np.float32(2.0)))
    hi_t = float(np.float32(np.float32(1.0) - np.float32(remainder)))

    def first(mask):
        nz = torch.nonzero(mask)
        return int(nz[0]) if nz.numel() else 1000

    low_b = first(frac > remainder)
    low_b = 0 if low_b >= 1000 else low_b
    high_b = first(frac > hi_t)
    high_b = 999 if high_b >= 1000 else (min(high_b + 1, 999) if high_b == low_b else high_b)
    return low_b / 1000.0 * rng + mn, high_b / 1000.0 * rng + mn


def map_u8(img: torch.Tensor, low, high) -> torch.Tensor:
    """Step 7's map: ``(v - low)/(high - low) * 255``, NaN to 0, clamped,
    rounded half up."""
    v = (img - low) / (high - low) * 255.0
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v).clamp(0.0, 255.0)
    return torch.floor(v + 0.5).to(torch.uint8)


def decode(samples, input_rate: int, profile: dict, pct: float, dtype=torch.float64,
           device="cpu") -> Decoded:
    """Samples of one recording (any integer or float array) -> the
    reference's rows, computed in ``dtype`` on ``device``."""
    t = dsp.design(profile, input_rate)
    x = torch.as_tensor(np.asarray(samples)).to(device)
    y = resample(x, t, dtype)
    work_len = y.shape[0]
    filt, corr = demod_filter_correlate(y, t)
    g = t.template.shape[0]
    n_valid = max(0, work_len - g)
    spr, md, max_peaks = dsp.selector_params(work_len, t.work_rate)
    peaks = greedy_peaks(corr[:n_valid].to(torch.float64).cpu().numpy(), n_valid, spr, md, max_peaks)
    m_final = t.work_rate // dsp.FINAL_RATE
    pos = torch.tensor([p for p in peaks[:-1] if p + spr < work_len], dtype=torch.int64, device=filt.device)
    img = rows_at(filt, pos, spr, m_final)
    if img.shape[0]:
        img[0, 0] = 0.0
        low, high = percent_levels(img, pct)
        u8 = map_u8(img, low, high)
    else:
        low = high = torch.zeros((), dtype=dtype)
        u8 = torch.zeros((0, dsp.PX_PER_ROW), dtype=torch.uint8, device=filt.device)
    return Decoded(u8, filt, peaks, work_len, spr, m_final, float(low), float(high))
