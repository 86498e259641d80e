"""The port's ops (``noaa_apt_tpu_torch.ops``) against the JAX package.

Same inputs, made from seeded numpy, go through the JAX function and its
counterpart in the port, on the CPU.  Pallas kernels run as the JAX
package's own tests run them (``interpret=True``); the port runs the
plain PyTorch twins of its CUDA kernels, which is what its wrappers do
for CPU tensors.  ``tests/test_torch_cuda.py`` holds each kernel
bit-equal to its twin on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.graph.decode import Decoder as JDecoder
from noaa_apt_tpu.ops import demod as jdm
from noaa_apt_tpu.ops import resample as jrs
from noaa_apt_tpu.ops import sync as jsy
from noaa_apt_tpu.ops.pallas_select import select_peaks as j_select_peaks
from noaa_apt_tpu.ops.pallas_select import select_peaks_batch as j_select_peaks_batch
from noaa_apt_tpu.ops.pallas_stage import make_demod_fir_corr
from noaa_apt_tpu.synth import synth_recording

from noaa_apt_tpu_torch.core.frequency import Freq, Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph.decode import DecodeTables
from noaa_apt_tpu_torch.ops import demod as dm
from noaa_apt_tpu_torch.ops import resample as rs
from noaa_apt_tpu_torch.ops.select import (SUMMARY_BLOCK, block_summary_plain, select_peaks,
                                           select_peaks_plain, walk_summaries_plain)
from noaa_apt_tpu_torch.ops.stage import demod_fir_corr

torch.set_num_threads(1)

RATES = (11025, 22050, 44100, 48000)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return a.view(np.uint32)


def _assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        np.testing.assert_array_equal(a, b)


def _jax_tables(profile_name: str, rate_hz: int):
    """The JAX package's own tables for (profile, input rate)."""
    jdec = JDecoder(JPROFILES[profile_name])
    filt = jdec._ingest_filter(JRate(rate_hz))
    import math

    g = math.gcd(rate_hz, jdec.work_rate.get_hz())
    l, m = jdec.work_rate.get_hz() // g, rate_hz // g
    coeff = filt.resample(JRate(rate_hz), JRate(rate_hz * l)).design()
    plan = jrs.resample_plan(1000, l, m, coeff)
    p_c, s_c, bank, _, offset = jrs._phase_tables(plan)
    carrier, taps, template = jdec._chain_params()
    cosphi2, sinphi = jdm.demod_constants(carrier)
    return dict(input_rate=rate_hz, work_rate=jdec.work_rate.get_hz(), l=l, m=m, offset=offset,
                p_c=p_c, s_c=s_c, bank=bank, taps=taps, template=template,
                cosphi2=cosphi2, sinphi=sinphi), coeff


# -- 1. tables ---------------------------------------------------------------
@pytest.mark.parametrize("rate_hz", RATES)
@pytest.mark.parametrize("profile_name", ["standard", "fast", "slow"])
def test_tables_bit_equal_jax(profile_name, rate_hz):
    """Filter designs, phase tables, FIR taps, sync template and demod
    constants designed by the port equal the JAX package's bit for bit."""
    want, coeff_j = _jax_tables(profile_name, rate_hz)
    got = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    for key, value in want.items():
        _assert_bits_equal(getattr(got, key), value)
    # The filter designs themselves (the bank is built from the coeff).
    from noaa_apt_tpu_torch.core import LowpassDcRemoval

    p = PROFILES[profile_name]
    filt = LowpassDcRemoval(
        cutout=Freq.hz(p.resample_cutout, Rate(rate_hz)), atten=p.resample_atten,
        delta_w=Freq.hz(p.resample_delta_freq, Rate(rate_hz)),
    ).resample(Rate(rate_hz), Rate(rate_hz * got.l))
    _assert_bits_equal(filt.design(), coeff_j)


def test_decode_tables_round_trip():
    """``DecodeTables.from_numpy`` takes the JAX package's arrays and
    round-trips its own."""
    want, _ = _jax_tables("standard", 48000)
    from_jax = DecodeTables.from_numpy(**want)
    designed = DecodeTables.design(PROFILES["standard"], Rate(48000))
    again = DecodeTables.from_numpy(**designed.as_numpy())
    for key, value in designed.as_numpy().items():
        _assert_bits_equal(getattr(from_jax, key), value)
        _assert_bits_equal(getattr(again, key), value)
    with pytest.raises(ValueError, match="bank"):
        DecodeTables.from_numpy(**{**want, "bank": want["bank"][:-1]})
    with pytest.raises(ValueError, match="p_c must lie"):
        DecodeTables.from_numpy(**{**want, "p_c": want["p_c"] + want["l"]})


# -- 2. demod ----------------------------------------------------------------
def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place (ordered-integer distance)."""
    def ordered(x):
        i = _bits(x).astype(np.int64)
        return np.where(i & 0x80000000, 0x80000000 - i, i)

    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("source", ["random", "synth"])
def test_demod_within_8_ulp_of_jax(source):
    """The plain op-by-op demod sits within 8 ulp of the JAX package's
    ``demodulate`` on the CPU (XLA contracts across its barriers, so the
    two are not bit-equal; PERF.md records the measured spread)."""
    work = Rate(12480)
    carrier = Freq.hz(2400.0, work)
    if source == "random":
        x = np.random.default_rng(11).normal(0.0, 1000.0, 200_000).astype(np.float32)
    else:
        x, _ = synth_recording(n_rows=8, sample_rate=12480, noise_db=20.0, seed=3)
    from noaa_apt_tpu.core.frequency import Freq as JFreq

    want = np.asarray(jdm.demodulate(jnp.asarray(x), JFreq.hz(2400.0, JRate(12480))))
    cosphi2, sinphi = dm.demod_constants(carrier)
    got = dm.demodulate(torch.from_numpy(x), cosphi2, dm.inv_sinphi(sinphi)).numpy()
    ulp = _ulp_distance(got, want)
    print(f"demod {source}: {int((ulp > 0).sum())}/{ulp.size} differ, max {int(ulp.max())} ulp")
    assert got[0] == 0.0
    assert ulp.max() <= 8


def _fma32(a, b, c) -> np.ndarray:
    """Correctly rounded f32 fused multiply-add, emulated in f64: the
    product is exact, the sum is rounded to odd (TwoSum error term),
    then rounded to f32 (Boldo & Melquiond: exact since 53 >= 2*24+2)."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    s = a * b
    t = s + c
    bb = t - s
    e = (s - (t - bb)) + (c - bb)
    even = (t.view(np.int64) & 1) == 0
    t = np.where((e != 0) & even, np.nextafter(t, np.where(e > 0, np.inf, -np.inf)), t)
    return t.astype(np.float32)


def _demod_contracted(x: np.ndarray, cosphi2, inv) -> np.ndarray:
    """``demod_body`` with the two contractions XLA's CPU backend makes
    across its optimization barriers: ``fma(-(p*c), cosphi2, fma(p, p,
    c*c))`` and, in each Newton step, ``y * fma(-(hx*y), y, 1.5)``."""
    p, c = x[:-1], x[1:]
    body = _fma32(-(p * c), np.full_like(p, cosphi2), _fma32(p, p, c * c))
    body = np.where(body > 0, body, np.float32(0))
    i = body.view(np.int32)
    y = (np.int32(0x5F3759DF) - (i >> 1)).view(np.float32)
    hx = np.float32(0.5) * body
    for _ in range(3):
        y = y * _fma32(-(hx * y), y, np.full_like(y, np.float32(1.5)))
    return np.concatenate([[np.float32(0)], (body * y) * np.float32(inv)])


@pytest.mark.parametrize("source", ["random", "synth"])
def test_jax_cpu_demod_contraction_pinned(source):
    """Where the JAX CPU reference's few-ulp spread comes from: its
    demod equals, bit for bit, ``demod_body`` with two FMAs (see
    :func:`_demod_contracted`).  The port keeps one rounding per op, so
    that each kernel stays bit-equal to its plain twin on any device."""
    from noaa_apt_tpu.core.frequency import Freq as JFreq

    carrier = JFreq.hz(2400.0, JRate(12480))
    if source == "random":
        x = np.random.default_rng(11).normal(0.0, 1000.0, 200_000).astype(np.float32)
    else:
        x, _ = synth_recording(n_rows=8, sample_rate=12480, noise_db=20.0, seed=3)
    cosphi2, sinphi = jdm.demod_constants(carrier)
    want = np.asarray(jdm.demodulate(jnp.asarray(x), carrier))
    _assert_bits_equal(_demod_contracted(x, cosphi2, dm.inv_sinphi(sinphi)), want)


def test_det_sqrt_matches_formula():
    """det_sqrt is within 2 ulp of the correctly rounded sqrt and maps
    +0 to exactly 0."""
    x = np.concatenate([[0.0], np.random.default_rng(2).uniform(1e-6, 1e8, 10_000)]).astype(np.float32)
    got = dm.det_sqrt(torch.from_numpy(x)).numpy()
    assert got[0] == 0.0
    assert _ulp_distance(got, np.sqrt(x)).max() <= 2


# -- 3. resample -------------------------------------------------------------
RESAMPLE_CASES = [
    (11025, "standard", "gather"),
    (44100, "standard", "gather"),
    (22050, "standard", "gather"),
    (48000, "fast", "matmul"),
    (11025, "slow", "matmul"),
    (48000, "standard", "matmul_packed"),
    (48000, "slow", "matmul_packed"),
]


def _resample_input(rate_hz: int, seed: int = 0) -> np.ndarray:
    x, _ = synth_recording(n_rows=2, sample_rate=rate_hz, noise_db=15.0, seed=seed)
    return np.round(x / np.abs(x).max() * 30000).astype(np.float32)


@pytest.mark.parametrize("rate_hz,profile_name,mode", RESAMPLE_CASES)
def test_resample_matches_jax(rate_hz, profile_name, mode):
    """The plain polyphase resample agrees with the JAX ``fast_resample``
    in every mode the JAX package picks on the CPU."""
    want_t, coeff = _jax_tables(profile_name, rate_hz)
    x = _resample_input(rate_hz)
    jplan = jrs.resample_plan(x.shape[0], want_t["l"], want_t["m"], coeff)
    assert jplan.mode == mode
    want = np.asarray(jrs.fast_resample(jnp.asarray(x), jplan))
    plan = rs.resample_plan(x.shape[0], want_t["l"], want_t["m"], coeff)
    assert plan.out_len == jplan.out_len
    got = rs.fast_resample(torch.from_numpy(x), plan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # int16 input (the main path's raw PCM) gives the same floats.
    got16 = rs.fast_resample(torch.from_numpy(x.astype(np.int16)), plan).numpy()
    _assert_bits_equal(got16, got)


@pytest.mark.parametrize("rate_hz,profile_name", [(11025, "standard"), (48000, "slow")])
def test_resample_chunked_bit_equal(rate_hz, profile_name):
    """Outputs evaluated in chunks (any k0 split) equal one full-length
    evaluation bit for bit."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    x = torch.from_numpy(_resample_input(rate_hz, seed=1).astype(np.int16))
    n_out = t.work_len(x.shape[0])
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    full = rs.polyphase_resample(x, *args, n_out)
    cuts = [0, 777, 777 + t.l * 5 + 3, n_out]
    parts = [rs.polyphase_resample(x, *args, b - a, k0=a) for a, b in zip(cuts, cuts[1:])]
    _assert_bits_equal(torch.cat(parts).numpy(), full.numpy())
    small = rs.polyphase_resample_plain(x, *args, n_out, chunk=1000)
    _assert_bits_equal(small.numpy(), full.numpy())


# K1's block-major variant: l <= 32, int16 input; l <= 8 folded
# (l = 1 at 24960 and 12480 Hz standard and 41600 Hz slow, the l == 1
# path's tables; l = 2, 3, 5 at 24960 fast, 41600 standard, 24960 slow).
BLOCK_CASES = [(48000, "standard"), (48000, "fast"), (48000, "slow"), (96000, "standard"),
               (192000, "slow"), (8000, "slow"), (24000, "standard"), (24960, "standard"),
               (12480, "standard"), (41600, "slow"), (24960, "fast"), (41600, "standard"),
               (24960, "slow")]


def _emulate_block_kernel(x, w, live, g, l, m, k0, out_len, s_f=None, taps=None):
    """``block_kernel`` of ``csrc/resample.cu`` in its own order: a row
    per block ``i``, r-major, only the live groups, ``acc = acc + w*x``
    one op per step from +0, x read as 0 at or past n.  With ``s_f``
    (float32 x), a CTA of 256 blocks whose staged span
    ``x[i0*m, (i0+255)*m + R)`` holds an inf or a NaN sums each output's
    own ``taps`` taps instead, ``W[s_f[c] + t, c]`` in ascending t.
    Returns (y, count of such CTAs, count of the others)."""
    n, r_len = x.shape[0], w.shape[0]
    i_first, i_end = k0 // l, (k0 + out_len - 1) // l + 1
    xp = torch.cat([x.to(torch.float32), torch.zeros(1)])
    base = torch.arange(i_first, i_end, dtype=torch.int64) * m
    wt = torch.from_numpy(w)
    acc = torch.zeros((i_end - i_first, 4 * g), dtype=torch.float32)
    for r in range(r_len):
        xv = xp[torch.clamp(base + r, max=n)][:, None]
        for q in range(g):
            if live[r] >> q & 1:
                cols = slice(4 * q, 4 * q + 4)
                acc[:, cols] = acc[:, cols] + wt[r, cols] * xv
    cta = torch.arange(i_end - i_first) // rs.K1_CTA_BLOCKS
    n_cta = int(cta[-1]) + 1
    span = (rs.K1_CTA_BLOCKS - 1) * m + r_len
    bad = [s_f is not None
           and not torch.isfinite(x[(i_first + a * rs.K1_CTA_BLOCKS) * m:][:span]).all() for a in range(n_cta)]
    for a in (a for a in range(n_cta) if bad[a]):
        rows = torch.nonzero(cta == a)[:, 0]
        for c in range(l):
            s = int(s_f[c])
            exact = torch.zeros(rows.shape[0], dtype=torch.float32)
            for t in range(taps):
                exact = exact + wt[s + t, c] * xp[torch.clamp(base[rows] + s + t, max=n)]
            acc[rows, c] = exact
    flat = acc[:, :l].reshape(-1)
    return flat[k0 - i_first * l : k0 - i_first * l + out_len], sum(bad), n_cta - sum(bad)


def _full_range_pcm(rate_hz: int, seed: int) -> torch.Tensor:
    """A seeded int16 recording with both extremes of the range in it."""
    x = np.random.default_rng(seed).integers(-32768, 32768, rate_hz // 4, dtype=np.int16)
    x[[3, 10, -2]] = [-32768, 32767, -32768]
    return torch.from_numpy(x)


@pytest.mark.parametrize("rate_hz,profile_name", BLOCK_CASES)
@pytest.mark.parametrize("cut", ["whole", "k0_short", "tail"])
def test_block_order_bit_equal_plain(rate_hz, profile_name, cut):
    """The block-major variant's summation order, over its own tap table
    and live mask (folded as the wrapper launches it), is ``torch.equal``
    to the plain twin: whole work length; ``k0 = 7`` cut one block short
    of the end; and the reference's full output count, whose last windows
    pass n."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    x = _full_range_pcm(rate_hz, seed=rate_hz + t.l)
    n = x.shape[0]
    p_f, s_f, m_f = rs.k1_block_fold(t.p_c, t.s_c, t.m)
    l_f = p_f.shape[0]
    assert l_f == rs.k1_fold_blocks(t.l, t.m) * t.l and l_f <= 16 if t.l <= 8 else l_f == t.l
    w, live, g = rs.k1_block_table(t.bank, p_f, s_f)
    assert w.shape == (int(s_f.max()) + t.bank.shape[1], 4 * g) and g == (4 if l_f <= 16 else 8)
    k0, out_len = 0, t.work_len(n)
    if cut == "k0_short":
        k0, out_len = 7, out_len - t.l - 7
    elif cut == "tail":
        out_len = rs.out_len_for(n, t.l, t.m, t.offset)
        k = out_len - 1
        assert int(t.s_c[k % t.l]) + k // t.l * t.m + t.bank.shape[1] > n  # the last window passes n
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    want = rs.polyphase_resample_plain(x, *args, out_len, k0)
    got, _, _ = _emulate_block_kernel(x, w, live, g, l_f, m_f, k0, out_len)
    assert torch.equal(got, want)


# Values a float32 WAV may hold that 0 * x does not cancel (inf, NaN), or
# that stress the rounding (-0.0, subnormals, near the largest finite).
SPECIALS = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-45, -3e-42, 3e38, -3e38], np.float32)


def _float_pcm_with_specials(n: int, m: int, r_len: int, seed: int) -> torch.Tensor:
    """Float32 ``x``: ``n`` full-range integers with ``SPECIALS`` in the
    second CTA of 256 blocks of ``m`` (at its first sample, which the
    first CTA's span also holds, and inside it); the third CTA holds only
    the finite specials (-0.0, subnormals), every 997th sample."""
    x = np.random.default_rng(seed).integers(-32768, 32768, n).astype(np.float32)
    cta = rs.K1_CTA_BLOCKS * m
    x[[cta, cta + 1, cta + 2 * m + 3, cta + (r_len - m) // 2 + 5, 2 * cta - m - 7, cta + 4 * m,
       cta + 17, 2 * cta - 2 * m]] = SPECIALS
    tail = x[5 * cta // 2 :: 997]
    tail[:] = np.resize(SPECIALS[3:6], tail.shape[0])
    return torch.from_numpy(x)


def _assert_float_bits_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    """Bit for bit (``torch.equal`` fails on NaN): the int32 views."""
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rate_hz,profile_name", BLOCK_CASES)
@pytest.mark.parametrize("cut", ["whole", "k0_short", "tail"])
def test_block_order_bit_equal_plain_float32(rate_hz, profile_name, cut):
    """The block-major variant with float32 input holding inf, NaN, -0.0,
    subnormals and +-3e38: the CTAs whose span holds an inf or a NaN sum
    each output's own taps, the others run the r loop, and the whole is
    bit for bit the plain twin, at the same cuts as the int16 test."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    p_f, s_f, m_f = rs.k1_block_fold(t.p_c, t.s_c, t.m, x_bytes=4)
    l_f = p_f.shape[0]
    w, live, g = rs.k1_block_table(t.bank, p_f, s_f)
    r_len = w.shape[0]
    n = int(2.6 * rs.K1_CTA_BLOCKS * m_f) + r_len
    x = _float_pcm_with_specials(n, m_f, r_len, seed=rate_hz + t.l)
    k0, out_len = 0, t.work_len(n)
    if cut == "k0_short":
        k0, out_len = 7, out_len - t.l - 7
    elif cut == "tail":
        out_len = rs.out_len_for(n, t.l, t.m, t.offset)
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    want = rs.polyphase_resample_plain(x, *args, out_len, k0)
    got, n_exact, n_loop = _emulate_block_kernel(x, w, live, g, l_f, m_f, k0, out_len, s_f, t.bank.shape[1])
    assert n_exact >= 1 and n_loop >= 1 and bool(torch.isnan(want).any())
    _assert_float_bits_equal(got, want)
    # The r loop in every CTA would not be the twin: 0 * inf is NaN.
    loop_only, _, _ = _emulate_block_kernel(x, w, live, g, l_f, m_f, k0, out_len)
    assert not torch.equal(loop_only.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rate_hz,profile_name", [c for c in BLOCK_CASES if c[0] in (24960, 12480, 41600)])
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_block_fold_keeps_every_output(rate_hz, profile_name, x_bytes):
    """The plain twin over the folded tables (b <= 16 // l blocks as
    one, for int16 and float32 samples) gives the unfolded tables'
    outputs, bit for bit, from any k0."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    p_f, s_f, m_f = rs.k1_block_fold(t.p_c, t.s_c, t.m, x_bytes)
    b = p_f.shape[0] // t.l
    assert m_f == b * t.m and b == rs.k1_fold_blocks(t.l, t.m, x_bytes) and 1 <= b <= 16 // t.l
    np.testing.assert_array_equal(s_f[t.l : 2 * t.l], t.s_c + t.m)
    x = _full_range_pcm(rate_hz, seed=3)
    bank = torch.from_numpy(t.bank)
    for k0, n_out in ((0, t.work_len(x.shape[0])), (5, 777)):
        want = rs.polyphase_resample_plain(x, bank, torch.from_numpy(t.p_c), torch.from_numpy(t.s_c),
                                           t.m, n_out, k0)
        banked = bank[torch.from_numpy(p_f)]  # one bank row per folded class
        got = rs.polyphase_resample_plain(x, banked, torch.arange(p_f.shape[0], dtype=torch.int32),
                                          torch.from_numpy(s_f.astype(np.int32)), m_f, n_out, k0)
        assert torch.equal(got, want)


# K1's class-major variant: l > 32, int16 input.
CLASS_CASES = [(11025, "standard"), (11025, "fast"), (11025, "slow"), (22050, "standard"),
               (44100, "standard"), (44100, "slow"), (8000, "standard"), (8000, "fast"),
               (11011, "slow")]


def _emulate_class_kernel(x, wc, s_c, seg, l, m, k0, out_len):
    """``class_kernel`` of ``csrc/resample.cu`` in its own tiling and
    order: per tile of 128 classes, each block ``i``'s segment
    ``x[i*m + s_c[c0] + q]`` (q < seg, 0 at or past n) is staged, and
    class ``c`` sums ``wc[t, c] * seg[off + t]`` over ascending t from +0
    (``off = s_c[c] - s_c[c0]``), one op per step; outputs are kept for
    k in [k0, k0 + out_len) only.  Blocks run in whole CTAs of 32."""
    n, taps = x.shape[0], wc.shape[0]
    i_first, i_end = k0 // l, (k0 + out_len - 1) // l + 1
    i = torch.arange(i_first, i_first + -(-(i_end - i_first) // 32) * 32, dtype=torch.int64)
    xp = torch.cat([x.to(torch.float32), torch.zeros(1)])
    wct = torch.from_numpy(wc)
    y = torch.full((out_len,), float("nan"))
    for c0 in range(0, l, rs.K1_CLASS_TILE):
        cs = torch.arange(c0, min(c0 + rs.K1_CLASS_TILE, l))
        staged = xp[torch.clamp(i[:, None] * m + int(s_c[c0]) + torch.arange(seg), max=n)]
        off = torch.from_numpy(s_c[c0 : c0 + cs.shape[0]].astype(np.int64) - int(s_c[c0]))
        assert int(off.max()) + taps <= seg
        acc = torch.zeros((i.shape[0], cs.shape[0]), dtype=torch.float32)
        for t in range(taps):
            acc = acc + wct[t, cs] * staged[:, off + t]
        k = i[:, None] * l + cs
        keep = (k >= k0) & (k < k0 + out_len)
        y[k[keep] - k0] = acc[keep]
    return y


@pytest.mark.parametrize("rate_hz,profile_name", CLASS_CASES)
@pytest.mark.parametrize("cut", ["whole", "k0_short", "tail"])
def test_class_order_bit_equal_plain(rate_hz, profile_name, cut):
    """The class-major variant's tiling and summation order, over its own
    tap table and segment length, is ``torch.equal`` to the plain twin:
    whole work length; ``k0 = 7`` cut one block short of the end; and the
    reference's full output count, whose last windows pass n."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    assert t.l > 32
    x = _full_range_pcm(rate_hz, seed=rate_hz + t.l)
    n = x.shape[0]
    wc, seg = rs.k1_class_table(t.bank, t.p_c, t.s_c)
    k0, out_len = 0, t.work_len(n)
    if cut == "k0_short":
        k0, out_len = 7, out_len - t.l - 7
    elif cut == "tail":
        out_len = rs.out_len_for(n, t.l, t.m, t.offset)
        k = out_len - 1
        assert int(t.s_c[k % t.l]) + k // t.l * t.m + t.bank.shape[1] > n  # the last window passes n
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    want = rs.polyphase_resample_plain(x, *args, out_len, k0)
    got = _emulate_class_kernel(x, wc, t.s_c, seg, t.l, t.m, k0, out_len)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate_hz,profile_name", CLASS_CASES)
@pytest.mark.parametrize("cut", ["whole", "k0_short", "tail"])
def test_class_order_bit_equal_plain_float32(rate_hz, profile_name, cut):
    """The class-major variant with float32 input holding inf, NaN, -0.0,
    subnormals and +-3e38: it multiplies exactly the twin's products
    (trailing zero taps included) in the twin's order, so it is bit for
    bit the plain twin with no path of its own for them."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    x = _full_range_pcm(rate_hz, seed=rate_hz + t.l).to(torch.float32)
    n = x.shape[0]
    x[[100, 101, (2 * t.m + 1) % (n - 9), n // 3, n // 3 + 7, n // 2, n // 2 + 1, n - 9]] = torch.from_numpy(SPECIALS)
    wc, seg = rs.k1_class_table(t.bank, t.p_c, t.s_c)
    k0, out_len = 0, t.work_len(n)
    if cut == "k0_short":
        k0, out_len = 7, out_len - t.l - 7
    elif cut == "tail":
        out_len = rs.out_len_for(n, t.l, t.m, t.offset)
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    want = rs.polyphase_resample_plain(x, *args, out_len, k0)
    assert bool(torch.isnan(want).any())
    _assert_float_bits_equal(_emulate_class_kernel(x, wc, t.s_c, seg, t.l, t.m, k0, out_len), want)


@pytest.mark.parametrize("rate_hz,profile_name", [(11025, "slow"), (44100, "standard"), (8000, "fast")])
def test_class_table_layout(rate_hz, profile_name):
    """wc holds class c's taps in column c; seg is the widest tile's
    s_c span plus T, so every class's window fits its tile's segment."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    wc, seg = rs.k1_class_table(t.bank, t.p_c, t.s_c)
    taps = t.bank.shape[1]
    assert wc.shape == (taps, t.l) and wc.flags.c_contiguous
    for c in range(t.l):
        _assert_bits_equal(wc[:, c], t.bank[t.p_c[c]])
    spans = []
    for c0 in range(0, t.l, 128):
        tile = t.s_c[c0 : c0 + 128].astype(np.int64)
        assert (tile - tile[0]).max() + taps <= seg
        spans.append(int(tile.max() - tile.min()))
    assert seg == max(spans) + taps
    stride = min(s for s in rs.K1_CLASS_STRIDES if s >= seg)
    assert rs.k1_class_smem(seg) == 4 * 32 * stride


def test_class_strides_mirror_cuda_source():
    """The wrapper's stride list is the kernel's (``K1_CLASS_STRIDES`` in
    ``csrc/resample.cu``), the last stride fills an H100's opt-in shared
    memory, and a segment past it needs more than that."""
    src = (Path(rs.__file__).resolve().parent.parent / "csrc" / "resample.cu").read_text()
    macro = src[src.index("#define K1_CLASS_STRIDES(X)"):].split("\n\n")[0]
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", macro)) == rs.K1_CLASS_STRIDES
    last = rs.K1_CLASS_STRIDES[-1]
    assert rs.k1_class_smem(last) <= OPTIN < rs.k1_class_smem(last + 1)
    assert rs.k1_class_smem(118) == 4 * 32 * 128


def test_block_table_layout():
    """W holds each class's taps at its window and 0 elsewhere; the live
    mask marks exactly the groups with a nonzero tap."""
    t = DecodeTables.design(PROFILES["fast"], Rate(48000))
    w, live, g = rs.k1_block_table(t.bank, t.p_c, t.s_c)
    taps = t.bank.shape[1]
    for c in range(t.l):
        s = int(t.s_c[c])
        _assert_bits_equal(w[s : s + taps, c], t.bank[t.p_c[c]])
        assert not w[:s, c].any() and not w[s + taps :, c].any()
    assert not w[:, t.l :].any()
    for q in range(g):
        np.testing.assert_array_equal((live >> q) & 1, w[:, 4 * q : 4 * q + 4].any(axis=1))
    with pytest.raises(ValueError, match="l <= 32"):
        d = DecodeTables.design(PROFILES["standard"], Rate(8000))
        rs.k1_block_table(d.bank, d.p_c, d.s_c)


OPTIN = 232_448  # an H100's opt-in shared memory per block


# (profile, rate) where K1 runs "phase" for float32 input on an H100 (every
# other shape of test_k1_variant_by_shape runs "block" or "class" for both
# dtypes): 192 kHz standard, whose float32 span passes the opt-in; the
# block-major CTAs that leave at most two an SM with T <= 2m; l > 32 with
# m > 4l and the bank in shared memory.  250 kHz standard and fast run
# "phase" for int16 too: no class-major CTA fits (seg 2929 and 2037).
F32_PHASE = {("standard", 192000), ("standard", 96000), ("fast", 48000), ("fast", 96000), ("fast", 192000),
             ("standard", 88200), ("fast", 88200), ("slow", 88200), ("slow", 250000)}
BOTH_PHASE = {("standard", 250000), ("fast", 250000)}


def _k1_smem(t, x_bytes: int) -> int:
    """The shared memory of the variant K1 tries first for ``t``'s shape."""
    if t.l > rs.K1_BLOCK_MAX_L:
        return rs.k1_class_smem(rs.k1_class_table(t.bank, t.p_c, t.s_c)[1])
    p_f, s_f, m_f = rs.k1_block_fold(t.p_c, t.s_c, t.m, x_bytes)
    w, _, g = rs.k1_block_table(t.bank, p_f, s_f)
    return rs.k1_block_smem(p_f.shape[0], m_f, w.shape[0], g, x_bytes)


@pytest.mark.parametrize("rate_hz", [8000, 11025, 22050, 24000, 32000, 44100, 48000, 62500, 88200, 96000,
                                     192000, 250000, 12480, 24960, 41600])
@pytest.mark.parametrize("profile_name", ["standard", "fast", "slow"])
def test_k1_variant_by_shape(profile_name, rate_hz):
    """Int16 input runs "block" for every l <= 32 shape (folded for its
    sample size) and "class" for every l > 32 shape (the gather regime at
    11025, 22050 and 44100 Hz; l = 39 or 52 at 8000 Hz; 62500 and 88200
    Hz), each within the opt-in shared memory, but at 250 kHz standard and
    fast, where no class-major CTA fits.  Float32 input runs the same,
    but "phase" at the shapes of ``F32_PHASE``; "phase" for a budget below
    the variant's CTA."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    taps, shape = t.bank.shape[1], (profile_name, rate_hz)
    fast = "block" if t.l <= rs.K1_BLOCK_MAX_L else "class"
    for x_bytes, want in ((2, fast), (4, "phase" if shape in F32_PHASE else fast)):
        smem = _k1_smem(t, x_bytes)
        if shape in BOTH_PHASE or (x_bytes, shape) == (4, ("standard", 192000)):
            assert smem > OPTIN
            want = "phase"
        else:
            assert smem <= OPTIN
            assert rs._k1_variant(t.l, t.m, taps, x_bytes, smem, smem - 1) == "phase"
        assert rs._k1_variant(t.l, t.m, taps, x_bytes, smem, OPTIN) == want, x_bytes
    assert _k1_smem(DecodeTables.design(PROFILES["standard"], Rate(192000)), 4) == 237_136


@pytest.mark.parametrize("l,m,taps,want16,want32", [
    (147, 640, 45, "class", "phase"),  # the tool's 48000 -> 11025 Hz
    (640, 147, 45, "class", "class"),  # 11025 -> 48000 Hz
    (208, 735, 68, "class", "class"),  # 44100 Hz standard, m <= 4l
    (624, 3125, 96, "class", "class"),  # 62500 Hz standard: the bank in global memory
    (11111, 48000, 45, "class", "class"),  # -r 11111 on 48 kHz: the bank in global memory
    (33, 132, 40, "class", "class"), (33, 133, 40, "class", "phase"),
    (13, 400, 50, "block", "block")])
def test_k1_variant_phase_where_m_over_4l(l, m, taps, want16, want32):
    """``l > 32`` with ``m > 4 l`` runs "phase" for float32 input where
    its bank fits in shared memory (where "class" was slower at the
    resample tool's 48000 -> 11025 Hz); int16 input, m <= 4 l and a bank
    in global memory run "class"; the rule leaves "block" (l <= 32)
    alone."""
    assert rs._k1_variant(l, m, taps, 2, 4096, OPTIN) == want16
    assert rs._k1_variant(l, m, taps, 4, 4096, OPTIN) == want32
    assert rs.k1_phase_smem(624, 96) == 244_608 > OPTIN


@pytest.mark.parametrize("x_bytes", [2, 4])
def test_k1_fold_spreads_banks(x_bytes):
    """The fold at l == 1 picks b = 15 blocks at m == 2 (24960 Hz
    standard, 41600 Hz slow, the ``-r 12480`` tool): a stride of 30
    samples leaves a warp's reads conflict-free with int16 and 2-way with
    float32, where b = 16 puts them on 2 banks (int16) or 1 (float32).
    No fold of a decoder rate conflicts more than 2 ways."""
    assert rs.k1_fold_blocks(1, 2, x_bytes) == 15
    assert rs.k1_bank_ways(30, x_bytes) == x_bytes // 2
    assert rs.k1_bank_ways(32, x_bytes) == 8 * x_bytes
    for rate_hz, profile_name in [(24960, "standard"), (12480, "standard"), (41600, "slow"),
                                  (24960, "fast"), (41600, "standard"), (12480, "slow")]:
        t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
        b = rs.k1_fold_blocks(t.l, t.m, x_bytes)
        assert 1 <= b <= 16 // t.l and rs.k1_bank_ways(b * t.m, x_bytes) <= 2


def test_k1_block_smem_at_48k():
    """Shared memory per CTA at 48 kHz (standard, fast, slow) and at
    192 kHz slow: the span and W, with the y tile over the span."""
    got = {}
    for profile_name, rate_hz in [("standard", 48000), ("fast", 48000), ("slow", 48000), ("slow", 192000)]:
        t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
        w, _, g = rs.k1_block_table(t.bank, t.p_c, t.s_c)
        got[profile_name, rate_hz] = rs.k1_block_smem(t.l, t.m, w.shape[0], g)
        got[profile_name, rate_hz, "f32"] = rs.k1_block_smem(t.l, t.m, w.shape[0], g, x_bytes=4)
    assert got == {("standard", 48000): 33_625, ("fast", 48000): 51_106,
                   ("slow", 48000): 31_603, ("slow", 192000): 126_072,
                   ("standard", 48000, "f32"): 59_369, ("fast", 48000, "f32"): 89_554,
                   ("slow", 48000, "f32"): 47_379, ("slow", 192000, "f32"): 189_208}


def _table_cache_follows_bank(variant: str, rate_hz: int, first_tap) -> None:
    t = DecodeTables.design(PROFILES["standard"], Rate(rate_hz))
    bank, p_c, s_c = (torch.from_numpy(a.copy()) for a in (t.bank, t.p_c, t.s_c))
    extra = (t.m, 2) if variant == "block" else ()  # the fold's stride and sample bytes
    first = rs._table(variant, bank, p_c, s_c, *extra)
    assert rs._table(variant, bank, p_c, s_c, *extra) is first
    bank[0, 0] += 1.0
    second = rs._table(variant, bank, p_c, s_c, *extra)
    assert second is not first and float(first_tap(second, t)) == float(bank[int(t.p_c[0]), 0])
    assert rs._table(variant, bank, p_c, s_c.clone(), *extra) is not second
    key = (variant, id(bank), *extra)
    del bank, first, second
    assert key not in rs._tables


def test_block_table_cache_follows_bank():
    """The wrapper's table is built once per bank tensor and rebuilt when
    the bank, p_c or s_c is written or replaced."""
    _table_cache_follows_bank("block", 48000, lambda tab, t: tab.w[int(t.s_c[0]), 0])


def test_class_table_cache_follows_bank():
    """The same for the class-major table (11025 Hz, l = 832)."""
    _table_cache_follows_bank("class", 11025, lambda tab, t: tab.wc[0, 0])


def test_cpu_resample_runs_plain():
    t = DecodeTables.design(PROFILES["standard"], Rate(48000))
    x = _full_range_pcm(48000, seed=1)
    args = (torch.from_numpy(t.bank), torch.from_numpy(t.p_c), torch.from_numpy(t.s_c), t.m)
    before = rs.polyphase_resample.launches
    rs.polyphase_resample(x, *args, 100)
    assert rs.polyphase_resample.last_variant == "plain" and rs.polyphase_resample.launches == before


# -- 4. demod -> FIR -> corr -------------------------------------------------
@pytest.mark.parametrize("profile_name", ["standard", "fast", "slow"])
def test_demod_fir_corr_matches_jax(profile_name):
    """The plain fused stage agrees with the Pallas kernel (interpret
    mode) and with the JAX op chain demodulate -> causal_filter ->
    sync_correlate."""
    jdec = JDecoder(JPROFILES[profile_name])
    carrier, taps, template = jdec._chain_params()
    cosphi2, sinphi = jdm.demod_constants(carrier)
    n = 8192
    y, _ = synth_recording(n_rows=2, sample_rate=jdec.work_rate.get_hz(), noise_db=12.0, seed=5)
    y = y[:n].astype(np.float32) * np.float32(3000.0)
    g = len(template)

    jfilt, jcorr = make_demod_fir_corr(taps, template, cosphi2, sinphi, n, interpret=True, block=4096)(
        jnp.asarray(y))
    jfilt, jcorr = np.asarray(jfilt), np.asarray(jcorr)
    ofilt = np.asarray(jrs.causal_filter(jdm.demodulate(jnp.asarray(y), carrier), taps))
    ocorr = np.asarray(jsy.sync_correlate(jnp.asarray(ofilt), template))

    filt, corr = demod_fir_corr(torch.from_numpy(y), torch.from_numpy(taps),
                                torch.from_numpy(template), cosphi2, dm.inv_sinphi(sinphi))
    filt, corr = filt.numpy(), corr.numpy()
    assert filt.shape == corr.shape == (n,)
    for want_f, want_c in ((jfilt, jcorr[: n - g]), (ofilt, ocorr)):
        np.testing.assert_allclose(filt, want_f, rtol=1e-5, atol=1e-5 * np.abs(want_f).max())
        np.testing.assert_allclose(corr[: n - g], want_c, rtol=1e-5, atol=1e-5 * np.abs(want_c).max())


def test_sync_correlate_drops_last_window():
    from noaa_apt_tpu_torch.ops.sync import sync_correlate

    x = np.random.default_rng(4).normal(size=500).astype(np.float32)
    tmpl = jsy.generate_sync_frame(JRate(12480))
    want = np.asarray(jsy.sync_correlate(jnp.asarray(x), tmpl))
    got = sync_correlate(torch.from_numpy(x), tmpl).numpy()
    assert got.shape == want.shape == (500 - len(tmpl),)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert sync_correlate(torch.from_numpy(x), tmpl, n_valid=300).shape == (300 - len(tmpl),)


# -- 5. selector -------------------------------------------------------------
def _selector_oracles(corr: np.ndarray, n_valid: int, spr: int, md: int, max_peaks: int, block: int):
    wr = JRate(2 * spr)
    host = jsy.find_sync_peaks(corr[:n_valid], wr)
    assert host == jsy.find_sync_peaks_reference(corr[:n_valid], wr)
    pk, k = j_select_peaks(jnp.asarray(corr), n_valid, spr, md, max_peaks, interpret=True, block=block)
    assert np.asarray(pk[: int(k)]).tolist() == host
    dpk, dk = jsy._find_sync_peaks_device(jnp.asarray(corr), n_valid, spr, md, max_peaks)
    assert np.asarray(dpk[: int(dk)]).tolist() == host
    return host


@pytest.mark.parametrize("seed", range(3))
def test_selector_chunk_boundary_cases(seed):
    """The chunk-boundary and dropout cases of tests/test_ops.py:318-345:
    the plain selector equals the Pallas kernel, the host scan, the
    literal reference and the XLA while_loop, peak for peak."""
    spr, block = 2080, 4096
    md = spr * 8 // 10
    rng = np.random.default_rng(seed)
    n = int(rng.integers(block * 6, block * 9))
    corr = rng.standard_normal(n).astype(np.float32)
    if seed == 2:
        corr[block : block * 4] = -100.0
    max_peaks = max(16, n // spr + 16)
    n_valid = n - 777
    want = _selector_oracles(corr, n_valid, spr, md, max_peaks, block)
    peaks, k = select_peaks(torch.from_numpy(corr)[None, :], [n_valid], spr, md, max_peaks)
    assert peaks.dtype == torch.int32 and peaks.shape == (1, max_peaks)
    assert peaks[0, : int(k[0])].tolist() == want
    assert not peaks[0, int(k[0]):].any()


@pytest.mark.parametrize("seed", range(2))
def test_selector_batched(seed):
    """Batch of 3 rows with different n_valid (a dropout row, an i=0
    replacement row): one batched call equals the batched Pallas kernel
    row by row and each row's oracles."""
    spr, block, B = 2080, 4096, 3
    md = spr * 8 // 10
    rng = np.random.default_rng(100 + seed)
    n = block * 5
    corr = rng.standard_normal((B, n)).astype(np.float32)
    corr[1, block : block * 3] = -100.0
    corr[2, 0] = 50.0
    n_valids = np.array([n - 777, n - spr, spr + 99], np.int32)
    max_peaks = max(16, n // spr + 16)
    jp, jk = j_select_peaks_batch(jnp.asarray(corr), jnp.asarray(n_valids), spr, md, max_peaks,
                                  interpret=True, block=block)
    peaks, k = select_peaks(torch.from_numpy(corr), n_valids, spr, md, max_peaks)
    for b in range(B):
        want = jsy.find_sync_peaks(corr[b, : n_valids[b]], JRate(2 * spr))
        assert np.asarray(jp[b, : int(jk[b])]).tolist() == want
        assert peaks[b, : int(k[b])].tolist() == want, f"row {b}"


def test_selector_overflow_and_validation():
    corr = torch.zeros((1, 50_000))
    with pytest.raises(RuntimeError, match="max_peaks"):
        select_peaks(corr, [50_000], 2080, 1664, 3)
    with pytest.raises(ValueError, match="n_valid"):
        select_peaks(corr, [50_001], 2080, 1664, 64)
    with pytest.raises(ValueError, match="2-D"):
        select_peaks(corr[0], [10], 2080, 1664, 64)


# -- 6. K3's decomposition: block summaries and the walk over them ------------
def _brute_summary(corr: np.ndarray, n_valid) -> tuple[np.ndarray, np.ndarray]:
    B, L = corr.shape
    nb = -(-L // SUMMARY_BLOCK)
    smax = np.full((B, nb), -np.inf, np.float32)
    sidx = np.full((B, nb), -1, np.int64)
    for b in range(B):
        for j in range(nb):
            seg = corr[b, j * SUMMARY_BLOCK : min((j + 1) * SUMMARY_BLOCK, n_valid[b])]
            if seg.size:
                smax[b, j] = seg.max()
                sidx[b, j] = j * SUMMARY_BLOCK + int(np.argmax(seg))
    return smax, sidx


def _decomposition_agrees(corr: np.ndarray, n_valid, spr: int, md: int, max_peaks: int):
    """Summary step against a brute-force scan; the walk over summaries,
    the plain twin and the wrapper against each other; returns the
    per-row peak lists."""
    t = torch.from_numpy(corr)
    smax, sidx = block_summary_plain(t, n_valid)
    want_max, want_idx = _brute_summary(corr, n_valid)
    np.testing.assert_array_equal(smax.numpy(), want_max)
    np.testing.assert_array_equal(sidx.numpy(), want_idx)
    plain = select_peaks_plain(t, n_valid, spr, md, max_peaks)
    walk = walk_summaries_plain(t, smax, sidx, n_valid, spr, md, max_peaks)
    wrapped = select_peaks(t, n_valid, spr, md, max_peaks)
    for got in (walk, wrapped):
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    _, lists = select_peaks(t, n_valid, spr, md, max_peaks, to_host=True)
    assert lists == [plain[0][b, : int(plain[1][b])].tolist() for b in range(corr.shape[0])]
    return lists


# (spr, length, n_valid, values): md = spr * 8 // 10 is 1664 (a multiple of
# the 32-position block) for spr 2080, 1672 for spr 2090 and 80 for spr 100.
DECOMPOSITION_CASES = {
    "ties": (2080, 30_000, 30_000 - 5, "ties"),
    "ties_ragged_md": (2090, 29_000, 29_000 - 17, "ties"),
    "ragged_md": (2090, 29_000, 27_000 + 3, "normal"),
    "n_valid_in_last_window": (2080, 30_000, 13 * 2080 + 1664 // 2 + 3, "ties"),
    "window_inside_two_blocks": (100, 6_000, 6_000 - 9, "ties"),
    "rounded_ties": (2080, 30_000, 30_000 - 31, "rounded"),
}


def _values(rng, kind: str, shape) -> np.ndarray:
    if kind == "ties":  # small integers: equal maxima straddle blocks and window edges
        return rng.integers(0, 4, shape).astype(np.float32)
    if kind == "rounded":
        return np.round(rng.standard_normal(shape) * 2.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", sorted(DECOMPOSITION_CASES))
def test_selector_decomposition_matches_oracles(case):
    """K3's decomposition (block summaries, then a walk that reads whole
    blocks from them) equals the plain twin, the Pallas kernel
    (interpret mode) and the host scan, peak for peak."""
    spr, L, n_valid, kind = DECOMPOSITION_CASES[case]
    md = spr * 8 // 10
    corr = _values(np.random.default_rng(len(case)), kind, (1, L))
    max_peaks = max(16, L // spr + 16)
    (got,) = _decomposition_agrees(corr, [n_valid], spr, md, max_peaks)
    assert got == jsy.find_sync_peaks(corr[0, :n_valid], JRate(2 * spr))
    pk, k = j_select_peaks(jnp.asarray(corr[0]), n_valid, spr, md, max_peaks, interpret=True)
    assert np.asarray(pk[: int(k)]).tolist() == got


@pytest.mark.parametrize("seed", range(2))
def test_selector_decomposition_batched(seed):
    """Four tie-heavy rows with different n_valid: a dropout row (forced
    appends) and a seed-replacement row among them, in one call."""
    spr, B, L = 2090, 4, 25_000
    md = spr * 8 // 10
    corr = _values(np.random.default_rng(200 + seed), "ties", (B, L))
    corr[1, 2 * spr : 7 * spr] = -1.0
    corr[2, 0] = 9.0
    corr[3] = _values(np.random.default_rng(300 + seed), "rounded", L)
    n_valids = np.array([L - 5, L - 777, L // 2 + 3, 3 * spr + 7], np.int32)
    max_peaks = max(16, L // spr + 16)
    got = _decomposition_agrees(corr, n_valids, spr, md, max_peaks)
    jp, jk = j_select_peaks_batch(jnp.asarray(corr), jnp.asarray(n_valids), spr, md, max_peaks,
                                  interpret=True)
    for b in range(B):
        assert got[b] == jsy.find_sync_peaks(corr[b, : n_valids[b]], JRate(2 * spr)), f"row {b}"
        assert np.asarray(jp[b, : int(jk[b])]).tolist() == got[b], f"row {b}"
