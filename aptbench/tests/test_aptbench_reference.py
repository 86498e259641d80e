"""The plain reference agrees with the port's ``device="cpu"`` path: the
same tables, the same sync positions and rows within one u8 level, on
short seeded passes at each resample regime (l > 32, l <= 32, l == 1)."""

import numpy as np
import pytest
import torch

from aptbench.gen import synth
from aptbench.reference import decode as ref_decode
from aptbench.reference import dsp
from aptbench.reference.judge import judge

STANDARD = {"work_rate": 12480, "resample_atten": 30.0, "resample_delta_freq": 1000.0,
            "resample_cutout": 4800.0, "demodulation_atten": 25.0}
RATES = [11025, 48000, 24960]


@pytest.mark.parametrize("rate", RATES + [44100])
def test_tables_equal_the_ports(rate):
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import STANDARD as PORT_STANDARD
    from noaa_apt_tpu_torch.graph.decode import DecodeTables

    t, p = dsp.design(STANDARD, rate), DecodeTables.design(PORT_STANDARD, Rate(rate))
    assert (t.l, t.m) == (p.l, p.m)
    assert np.array_equal(t.taps, p.taps) and np.array_equal(t.template, p.template)
    assert (t.cosphi2, t.sinphi) == (p.cosphi2, p.sinphi)
    if t.l > 1:
        p_c, s_c, bank = t.bank()
        assert np.array_equal(bank, p.bank) and np.array_equal(p_c, p.p_c) and np.array_equal(s_c, p.s_c)
        assert t.offset == p.offset
    assert t.work_len(1_234_567) == p.work_len(1_234_567)


@pytest.mark.parametrize("rate", RATES)
def test_reference_agrees_with_the_port_on_cpu(rate):
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import STANDARD as PORT_STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder

    x = synth.make_pass(2**33 + rate, 20.0, rate, 10.0, 30.0, "cpu").numpy()
    gray, sync = Decoder(PORT_STANDARD, device="cpu").decode_render_input(x, len(x), Rate(rate), "percent", 0.98)
    ref = ref_decode.decode(x, rate, STANDARD, 0.98)
    assert sync == ref.peaks
    got = judge(gray, ref)
    assert got["px_gap"] <= 1 and got["rows_off"] == 0 and got["rows"] == gray.shape[0] > 30


def test_control_in_bfloat16_is_far_off():
    x = synth.make_pass(17, 20.0, 11025, 10.0, 30.0, "cpu").numpy()
    ref = ref_decode.decode(x, 11025, STANDARD, 0.98)
    low = ref_decode.decode(x, 11025, STANDARD, 0.98, dtype=torch.bfloat16)
    got = judge(low.u8.numpy(), ref)
    assert got["px_gap"] > 50 and got["rows_off"] > 0.5 * got["rows"]


def test_judge_finds_shifted_and_resynced_rows():
    x = synth.make_pass(23, 20.0, 11025, 10.0, 30.0, "cpu").numpy()
    ref = ref_decode.decode(x, 11025, STANDARD, 0.98)
    img = ref.u8.numpy()
    dropped = np.delete(img, 7, axis=0)  # a row less: one shift, one row short
    assert judge(dropped, ref) == {"px_gap": 0, "rows_off": 2, "rows": img.shape[0]}
    pos = torch.tensor([ref.peaks[5] + 3])  # a row cut three samples late
    moved = img.copy()
    moved[5] = ref_decode.map_u8(ref_decode.rows_at(ref.filt, pos, ref.spr, ref.m_final),
                                 ref.low, ref.high)[0].numpy()
    got = judge(moved, ref)
    assert got["px_gap"] == 0 and got["rows_off"] == 1
    altered = img.copy()
    altered[9, 300] ^= 0x40
    got = judge(altered, ref)  # no start nearby makes a row of that pixel
    assert got["px_gap"] >= 32 and got["rows_off"] == 1


@pytest.mark.parametrize("seed", range(6))
def test_greedy_walk_equals_the_ports_plain_twin(seed):
    from noaa_apt_tpu_torch.ops.select import select_peaks_plain

    rng = np.random.default_rng(seed)
    n, spr = 5000, 100
    corr = rng.standard_normal(n).astype(np.float32)
    corr[rng.integers(0, n, 40)] += 4.0  # some clear peaks among the noise
    peaks, k = select_peaks_plain(torch.from_numpy(corr)[None, :], [n - 50], spr, 80, 80)
    want = peaks[0, : int(k[0])].tolist()
    assert ref_decode.greedy_peaks(corr.astype(np.float64), n - 50, spr, 80, 80) == want
