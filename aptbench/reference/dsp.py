"""Frozen design of everything the decode multiplies by: the ingest
resampler's filter and its polyphase tables, the post-demod lowpass, the
sync template, the demod constants and the greedy selector's parameters.

These follow upstream noaa-apt (``src/filters.rs``, ``src/frequency.rs``,
``src/dsp.rs``, ``src/decode.rs``), which designs every table in f32
arithmetic: the designs here keep that arithmetic, since it is part of
what a configuration states (a window one tap longer is another filter).
The filtering itself runs in :mod:`aptbench.reference.decode`, in the
precision it is asked for.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

FINAL_RATE = 4160  # pixels per second (2 lines of 2080)
PX_PER_ROW = 2080
CARRIER_FREQ = 2400

_PI32 = np.float32(math.pi)
_F = np.float32

# 1/(k! * 2^k)^2, the series of bessel_i0 (misc.rs).
_BESSEL = np.array([1.0 / (math.factorial(k) * 2.0**k) ** 2 for k in range(9)], dtype=np.float32)


def bessel_i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0: the 8-term
    Horner form of upstream ``misc.rs``, in f32."""
    x = np.asarray(x, np.float32)
    x2 = x * x
    result = np.zeros_like(x)
    for k in range(8, 0, -1):
        result = (result + _BESSEL[k]) * x2
    return result + _F(1.0)


def kaiser(atten: float, delta_w_rad: np.float32) -> np.ndarray:
    """Kaiser window of odd length for ``atten`` dB and a transition band
    of ``delta_w_rad`` radians per sample (``filters.rs``)."""
    atten = _F(atten)
    if atten > 50.0:
        beta = _F(0.1102) * (atten - _F(8.7))
    elif atten < 21.0:
        beta = _F(0.0)
    else:
        beta = _F(0.5842) * _F((atten - _F(21.0)) ** _F(0.4)) + _F(0.07886) * (atten - _F(21.0))
    length = int(math.ceil(float(_F(atten - _F(8.0)) / (_F(2.285) * _F(delta_w_rad))))) + 1
    if length % 2 == 0:
        length += 1
    half = (length - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float32)
    arg = beta * np.sqrt(np.maximum(_F(1.0) - (n / (_F(length) / _F(2.0))) ** 2, _F(0.0)))
    return (bessel_i0(arg) / bessel_i0(np.float32(beta))).astype(np.float32)


def _sinc_taps(n: np.ndarray, cut: np.float32) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sin(n * _PI32 * cut) / (n * _PI32)


def lowpass(cut_pi: np.float32, atten: float, delta_pi: np.float32) -> np.ndarray:
    """Kaiser-windowed sinc lowpass; frequencies in fractions of pi."""
    window = kaiser(atten, _F(delta_pi * _PI32))
    half = (window.size - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float32)
    taps = _sinc_taps(n, cut_pi)
    taps[half] = cut_pi
    return (taps.astype(np.float32) * window).astype(np.float32)


def lowpass_dc_removal(cut_pi: np.float32, atten: float, delta_pi: np.float32) -> np.ndarray:
    """The lowpass minus a DC lobe of half the transition band."""
    window = kaiser(atten, _F(delta_pi * _PI32))
    half = (window.size - 1) // 2
    n = np.arange(-half, half + 1, dtype=np.float32)
    dc = _F(_F(delta_pi / _F(2.0)))
    taps = _sinc_taps(n, cut_pi) - _sinc_taps(n, dc)
    taps[half] = _F(cut_pi - dc)
    return (taps.astype(np.float32) * window).astype(np.float32)


def hz_to_pi(f: float, rate: int) -> np.float32:
    return _F(_F(2.0) * _F(f) / _F(rate))


@dataclass(frozen=True)
class Tables:
    """Everything one (profile, input rate) decode multiplies by."""

    input_rate: int
    work_rate: int
    l: int
    m: int
    coeff: np.ndarray  # f32 ingest filter at the interpolated rate (l > 1) or input rate
    taps: np.ndarray  # f32 post-demod lowpass
    template: np.ndarray  # int8 +-1 sync A frame at the work rate
    cosphi2: np.float32
    sinphi: np.float32

    @property
    def offset(self) -> int:
        return (self.coeff.shape[0] - 1) // 2

    def work_len(self, n_in: int) -> int:
        """Work-rate samples of an ``n_in``-sample recording."""
        if self.l == 1:
            return n_in // self.m
        interp = n_in * self.l
        return -(-(interp - self.offset) // self.m) if interp > self.offset else 0

    def bank(self):
        """``(p_c, s_c, bank)``: the phase and first input sample of each
        output class ``c = k mod l``, and ``bank[p, i] = coeff[p + i*l]``
        over the usable taps ``j <= 2*offset`` (zero past them)."""
        l, m = self.l, self.m
        jmax = 2 * self.offset
        t_taps = jmax // l + 1
        c = np.arange(l, dtype=np.int64)
        p_c = (-(c * m)) % l
        s_c = (c * m + p_c) // l
        flat = np.zeros(l * t_taps, dtype=np.float32)
        flat[: jmax + 1] = self.coeff[: jmax + 1]
        return p_c, s_c, np.ascontiguousarray(flat.reshape(t_taps, l).T)

    def taps_per_output(self) -> float:
        """Mean number of non-zero ingest taps an output sums (the work
        the resample needs, whatever sums it)."""
        if self.l == 1:
            return float(self.coeff.shape[0])
        _, _, bank = self.bank()
        return float(np.count_nonzero(bank)) / self.l


def sync_frame(work_rate: int) -> np.ndarray:
    """Sync A as +-1 at the work rate (``decode.rs``): a 4-pixel low, seven
    4-pixel cycles of low/high, eight pixels low."""
    pw = work_rate // FINAL_RATE
    spw = 2 * pw
    cycle = np.concatenate([-np.ones(spw, np.int8), np.ones(spw, np.int8)])
    return np.concatenate([-np.ones(spw, np.int8), np.tile(cycle, 7), -np.ones(8 * pw, np.int8)])


def design(profile: dict, input_rate: int) -> Tables:
    """The tables of ``profile`` (a configuration's ``profile`` group) at
    ``input_rate`` Hz."""
    work = int(profile["work_rate"])
    if work % FINAL_RATE:
        raise ValueError(f"work rate {work} is not a multiple of {FINAL_RATE}")
    g = math.gcd(input_rate, work)
    l, m = work // g, input_rate // g
    cut = hz_to_pi(profile["resample_cutout"], input_rate)
    delta = hz_to_pi(profile["resample_delta_freq"], input_rate)
    if l > 1:  # the filter runs at the interpolated rate
        ratio = _F(_F(input_rate * l) / _F(input_rate))
        cut, delta = _F(cut / ratio), _F(delta / ratio)
    coeff = lowpass_dc_removal(cut, profile["resample_atten"], delta)
    cutout = _F(_F(FINAL_RATE) / _F(work))
    taps = lowpass(cutout, profile["demodulation_atten"], _F(cutout / _F(5.0)))
    carrier_rad = _F(hz_to_pi(CARRIER_FREQ, work) * _PI32)
    phi = _F(_F(2.0) * carrier_rad)
    cosphi2 = _F(np.cos(phi) * _F(2.0))
    sinphi = _F(np.sin(phi))
    return Tables(input_rate, work, l, m, coeff, taps, sync_frame(work), cosphi2, sinphi)


def selector_params(work_len: int, work_rate: int) -> tuple[int, int, int]:
    """``(spr, min distance, max peaks)`` of the greedy selector."""
    spr = PX_PER_ROW * work_rate // FINAL_RATE
    return spr, spr * 8 // 10, max(16, work_len // spr + 16)
