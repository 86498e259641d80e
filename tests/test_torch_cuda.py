"""The port's CUDA kernels against their plain twins, on the card.

Imports neither JAX nor the JAX package, so it runs on the GPU machine
as it is (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device every test skips.
"""

import numpy as np
import pytest
import torch

from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph.decode import DecodeTables, Decoder, PackedWorkPayload
from noaa_apt_tpu_torch.ops import demod as dm
from noaa_apt_tpu_torch.ops import resample as rs
from noaa_apt_tpu_torch.ops import select as sel
from noaa_apt_tpu_torch.ops.select import (block_summary, block_summary_plain, select_peaks,
                                           select_peaks_plain)
from noaa_apt_tpu_torch.ops.stage import demod_fir_corr, demod_fir_corr_plain
from noaa_apt_tpu_torch.synth import synth_recording

torch.set_num_threads(1)


def _pcm_rows(rate_hz: int, n_rows: int) -> np.ndarray:
    x, _ = synth_recording(n_rows=n_rows, sample_rate=rate_hz, noise_db=15.0, seed=0)
    return np.round(x / np.abs(x).max() * 30000).astype(np.int16)


def _pcm(rate_hz: int) -> np.ndarray:
    return _pcm_rows(rate_hz, 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


# (profile, rate, variant, input dtype): the same variant for both dtypes,
# except where float32 runs "phase" (ops/resample.py:_k1_variant): 192 kHz
# standard, whose 4-byte span passes the opt-in; 48 kHz fast, where a
# block-major CTA leaves two an SM; 88200 Hz standard (l > 32, m > 4 l).
# 250 kHz standard runs "phase" for both, no class-major CTA fitting, with
# its 241 KB bank in global memory; 62500 Hz standard runs "class", as
# "phase" would read its 245 KB bank from there.
K1_CASES = [("standard", 11025, "class", "int16"), ("standard", 48000, "block", "int16"),
            ("fast", 48000, "block", "int16"), ("slow", 48000, "block", "int16"),
            ("slow", 192000, "block", "int16"), ("slow", 8000, "block", "int16"),
            ("fast", 8000, "class", "int16"), ("fast", 11025, "class", "int16"),
            ("slow", 11025, "class", "int16"), ("standard", 22050, "class", "int16"),
            ("slow", 44100, "class", "int16"), ("slow", 11011, "class", "int16"),
            ("slow", 11011, "class", "float32"), ("standard", 11025, "class", "float32"),
            ("standard", 48000, "block", "float32"), ("fast", 48000, "phase", "float32"),
            ("slow", 48000, "block", "float32"), ("slow", 192000, "block", "float32"),
            ("standard", 192000, "phase", "float32"), ("slow", 44100, "class", "float32"),
            ("fast", 16000, "block", "float32"), ("standard", 88200, "class", "int16"),
            ("standard", 88200, "phase", "float32"), ("standard", 62500, "class", "float32"),
            ("standard", 250000, "phase", "int16"), ("standard", 250000, "phase", "float32")]


def _k1_inputs(profile_name: str, rate_hz: int, device, dtype: str = "int16"):
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    x = torch.from_numpy(_pcm(rate_hz)).to(device).to(getattr(torch, dtype))
    args = [torch.from_numpy(a).to(device) for a in (t.bank, t.p_c, t.s_c)]
    return t, x, args


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,variant,dtype", K1_CASES)
def test_cuda_resample_kernel_bit_equal(cuda_device, profile_name, rate_hz, variant, dtype):
    """Every K1 variant against the plain twin, int16 and float32.
    slow/192000 Hz has T = 857 (126 KB of shared memory per block-major
    CTA with int16, 189 KB with float32); slow/11011 Hz has l = 1600 and
    a 320 KB bank: the class variant reads its table from global memory;
    standard/250000 Hz runs "phase" with its bank in global memory."""
    t, x, args = _k1_inputs(profile_name, rate_hz, cuda_device, dtype)
    n_out = t.work_len(x.shape[0])
    got = rs.polyphase_resample(x, *args, t.m, n_out)
    assert rs.polyphase_resample.last_variant == variant
    assert torch.equal(got, rs.polyphase_resample_plain(x, *args, t.m, n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,variant", [("standard", 48000, "block"), ("fast", 16000, "block"),
                                                          ("standard", 11025, "class"),
                                                          ("slow", 44100, "class")])
def test_cuda_resample_float_non_finite_bit_equal(cuda_device, profile_name, rate_hz, variant):
    """Float32 input holding NaN, +-inf, -0.0, subnormals and +-3e38, at a
    block-major CTA's first sample and inside spans: bit for bit the twin
    (int32 views; ``torch.equal`` fails on NaN), and the NaN outputs stay
    where the twin has them."""
    t, x, args = _k1_inputs(profile_name, rate_hz, cuda_device, "float32")
    n = x.shape[0]
    specials = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 1e-45, -3e-42, 3e38, -3e38])
    cta = rs.K1_CTA_BLOCKS * t.m
    at = torch.tensor([cta, cta + 1, 3 * t.m + 2, n // 2, n // 2 + 1, n // 3, 7, n - 3]) % n
    x[at] = specials.to(cuda_device)
    n_out = t.work_len(n)
    got = rs.polyphase_resample(x, *args, t.m, n_out)
    assert rs.polyphase_resample.last_variant == variant
    want = rs.polyphase_resample_plain(x, *args, t.m, n_out)
    assert bool(torch.isnan(want).any())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,variant,dtype", K1_CASES[:4] + K1_CASES[13:15])
def test_cuda_resample_kernel_ragged_tail(cuda_device, profile_name, rate_hz, variant, dtype):
    """The reference's full output count, whose last windows pass n (x
    reads as 0 there), and a length off the 256-block (and 32-block) CTA."""
    t, x, args = _k1_inputs(profile_name, rate_hz, cuda_device, dtype)
    for n_out in (rs.out_len_for(x.shape[0], t.l, t.m, t.offset), 256 * t.l + 5):
        got = rs.polyphase_resample(x, *args, t.m, n_out)
        assert rs.polyphase_resample.last_variant == variant
        assert torch.equal(got, rs.polyphase_resample_plain(x, *args, t.m, n_out)), n_out


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,variant,dtype", K1_CASES[:4] + K1_CASES[13:15])
def test_cuda_resample_kernel_chunked_k0(cuda_device, profile_name, rate_hz, variant, dtype):
    """Chunks at k0 off a block and off a 256-block CTA equal one launch."""
    t, x, args = _k1_inputs(profile_name, rate_hz, cuda_device, dtype)
    n_out = t.work_len(x.shape[0])
    full = rs.polyphase_resample(x, *args, t.m, n_out)
    cuts = [0, 7, n_out // 3 + 3, n_out - t.l, n_out]
    parts = []
    for a, b in zip(cuts, cuts[1:]):
        parts.append(rs.polyphase_resample(x, *args, t.m, b - a, k0=a))
        assert rs.polyphase_resample.last_variant == variant
    assert torch.equal(torch.cat(parts), full)


# The l == 1 rates: (profile, rate, m).
L1_CASES = [("standard", 24960, 2), ("standard", 12480, 1), ("slow", 41600, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,m", L1_CASES)
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_cuda_resample_l1_bit_equal(cuda_device, profile_name, rate_hz, m, dtype):
    """K1 as the causal FIR decimated by m (l = 1, which the block
    variant's launch folds to 16 outputs a block), over ``causal_input``:
    int16 and float32 on "block", the work length and a length off the
    CTA."""
    t, x, args = _k1_inputs(profile_name, rate_hz, cuda_device, dtype)
    assert (t.l, t.m) == (1, m)
    xc = rs.causal_input(x, t.bank.shape[1])
    for n_out in (t.work_len(x.shape[0]), 256 * 2 + 5):
        got = rs.polyphase_resample(xc, *args, t.m, n_out)
        assert rs.polyphase_resample.last_variant == "block"
        assert torch.equal(got, rs.polyphase_resample_plain(xc, *args, t.m, n_out)), n_out
        assert got[0].item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,m", L1_CASES)
def test_cuda_decode_l1_matches_cpu_decode(cuda_device, profile_name, rate_hz, m):
    """A decode at an l == 1 rate on the card equals the CPU decode, with
    one K1 launch ("block" for int16 input)."""
    signal = _pcm_rows(rate_hz, 14)
    rs.polyphase_resample.launches = 0
    gpu = Decoder(PROFILES[profile_name]).decode_render_input(signal, len(signal), Rate(rate_hz))
    assert rs.polyphase_resample.launches == 1 and rs.polyphase_resample.last_variant == "block"
    cpu = Decoder(PROFILES[profile_name], device="cpu").decode_render_input(signal, len(signal), Rate(rate_hz))
    assert gpu[1] == cpu[1]
    np.testing.assert_array_equal(gpu[0], cpu[0])


@pytest.mark.cuda
def test_cuda_telemetry_render_matches_cpu(cuda_device):
    """The telemetry render on the card against the CPU: the same sync
    list, levels within 1e-4 relative (the band means reduce in another
    order on the card), channel names equal, u8 within +-1 on 0.1%."""
    from noaa_apt_tpu_torch.post.telemetry import telemetry_from_stats

    signal = _pcm_rows(11025, 230)
    gdec, cdec = Decoder(PROFILES["standard"]), Decoder(PROFILES["standard"], device="cpu")
    gpu = gdec.decode_render_input(signal, len(signal), Rate(11025), "telemetry")
    cpu = cdec.decode_render_input(signal, len(signal), Rate(11025), "telemetry")
    assert gpu[1] == cpu[1] and "telemetry" in gdec.last_stage_ms
    d = np.abs(gpu[0].astype(np.int16) - cpu[0].astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3
    tels = [telemetry_from_stats(*dec.telemetry_stats(dec.decode(signal, Rate(11025))))
            for dec in (gdec, cdec)]
    for wedge in (8, 9):
        g, c = (t.get_wedge_value(wedge, None) for t in tels)
        assert abs(g - c) <= 1e-4 * abs(c)
    names = [(t.get_channel_name("a"), t.get_channel_name("b")) for t in tels]
    assert names[0] == names[1]


@pytest.mark.cuda
def test_cuda_resample_float_input_takes_block(cuda_device):
    """Float32 input of int16 values runs "block" at 48 kHz, as int16 does,
    and gives the int16 launch's outputs bit for bit (int16 -> f32 is
    exact, and both sum the same products in the same order)."""
    t, x, args = _k1_inputs("standard", 48000, cuda_device)
    want = rs.polyphase_resample(x, *args, t.m, 5000)
    assert rs.polyphase_resample.last_variant == "block"
    got = rs.polyphase_resample(x.to(torch.float32), *args, t.m, 5000)
    assert rs.polyphase_resample.last_variant == "block"
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name", ["standard", "fast", "slow"])
def test_cuda_stage_kernel_bit_equal(cuda_device, profile_name):
    t = DecodeTables.design(PROFILES[profile_name], Rate(48000))
    y = torch.from_numpy(np.random.default_rng(1).normal(0, 3000, 50_000).astype(np.float32)).to(cuda_device)
    taps, tmpl = torch.from_numpy(t.taps).to(cuda_device), torch.from_numpy(t.template).to(cuda_device)
    inv = dm.inv_sinphi(t.sinphi)
    got = demod_fir_corr(y, taps, tmpl, t.cosphi2, inv)
    want = demod_fir_corr_plain(y, taps, tmpl, t.cosphi2, inv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2304 * 3 + 7, 2304 - 1, 1000, 150, 2])
def test_cuda_stage_kernel_ragged_lengths(cuda_device, n):
    """Lengths off K2's tile (256 threads x 9 outputs), under one tile,
    and under the template (g = 114) and the taps (k = 37)."""
    t = DecodeTables.design(PROFILES["standard"], Rate(48000))
    y = torch.from_numpy(np.random.default_rng(n).normal(0, 3000, n).astype(np.float32)).to(cuda_device)
    taps, tmpl = torch.from_numpy(t.taps).to(cuda_device), torch.from_numpy(t.template).to(cuda_device)
    inv = dm.inv_sinphi(t.sinphi)
    got = demod_fir_corr(y, taps, tmpl, t.cosphi2, inv)
    want = demod_fir_corr_plain(y, taps, tmpl, t.cosphi2, inv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_stage_kernel_slow_profile_at_11025(cuda_device):
    """The slow profile's halo (k + g = 251) on K1's real output."""
    t = DecodeTables.design(PROFILES["slow"], Rate(11025))
    x = torch.from_numpy(_pcm(11025)).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (t.bank, t.p_c, t.s_c)]
    y = rs.polyphase_resample(x, *args, t.m, t.work_len(x.shape[0]))
    taps, tmpl = torch.from_numpy(t.taps).to(cuda_device), torch.from_numpy(t.template).to(cuda_device)
    inv = dm.inv_sinphi(t.sinphi)
    got = demod_fir_corr(y, taps, tmpl, t.cosphi2, inv)
    want = demod_fir_corr_plain(y, taps, tmpl, t.cosphi2, inv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _tie_rows(rng, B: int, L: int, spr: int) -> np.ndarray:
    """Small integers: equal maxima straddle block and window edges."""
    corr = rng.integers(0, 4, (B, L)).astype(np.float32)
    if B > 1:
        corr[1, 3 * spr : 9 * spr] = -1.0  # dropout: forced appends
        corr[2, 0] = 9.0                   # the seed replaces nothing
    return corr


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4])
def test_cuda_select_kernel_tie_heavy(cuda_device, B):
    spr, md = 6240, 4992
    rng = np.random.default_rng(B)
    L = 40 * spr + 13
    corr = torch.from_numpy(_tie_rows(rng, B, L, spr)).to(cuda_device)
    n_valid = [L - 5, L - spr - 1, 17 * spr + 3, L][:B]
    got = select_peaks(corr, n_valid, spr, md, 64)
    want = select_peaks_plain(corr, n_valid, spr, md, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    peaks, lists = select_peaks(corr, n_valid, spr, md, 64, to_host=True)
    assert lists == [want[0][b, : int(want[1][b])].tolist() for b in range(B)]
    smax, sidx = block_summary(corr, n_valid)
    wmax, widx = block_summary_plain(corr, n_valid)
    assert torch.equal(smax, wmax) and torch.equal(sidx, widx)


@pytest.mark.cuda
@pytest.mark.parametrize("spr", [2080, 6240, 14079])
def test_cuda_select_walk_matches_plain_walk(cuda_device, spr):
    """The walk kernel's whole result (k, overflow flag, step count and
    peaks) against the plain walk over the same summaries; spr 14079
    gives md 11263, the widest window the walk takes."""
    md = spr * 8 // 10
    L = 30 * spr + 13
    corr = torch.from_numpy(_tie_rows(np.random.default_rng(spr), 4, L, spr)).to(cuda_device)
    n_valid = [L - 5, L - spr - 1, 17 * spr + 3, L]
    nv = np.asarray(n_valid, np.int32)
    summ, _ = sel._summary_launch(corr, nv)
    res = torch.empty((4, sel.RESULT_HEAD + 64), dtype=torch.int32, device=cuda_device)
    sel._walk_launch(corr, nv, summ, spr, md, 64, res)
    smax, sidx = block_summary_plain(corr.cpu(), n_valid)
    peaks, k, steps = sel.walk_summaries_plain(corr, smax, sidx, n_valid, spr, md, 64)
    want = torch.cat([k[:, None], torch.zeros_like(k)[:, None], steps[:, None], peaks], 1)
    assert torch.equal(res.cpu(), want)
    with pytest.raises(ValueError, match="md <"):
        select_peaks(corr, n_valid, spr, sel._kernel("select_walk_md_limit")(), 64)


@pytest.mark.cuda
def test_cuda_select_kernel_unaligned_rows(cuda_device):
    """Rows whose start is off a 16-byte boundary (odd row stride)."""
    spr, md = 2080, 1664
    corr = torch.from_numpy(_tie_rows(np.random.default_rng(3), 3, 60_001, spr)).to(cuda_device)
    for off in range(4):
        view = corr[:, off:]
        n_valid = [view.shape[1], view.shape[1] - 31, 2 * spr + off]
        got = select_peaks(view, n_valid, spr, md, 64)
        want = select_peaks_plain(view, n_valid, spr, md, 64)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), off


@pytest.mark.cuda
def test_cuda_select_kernel_bit_equal(cuda_device):
    spr = 2080
    md = spr * 8 // 10
    rng = np.random.default_rng(7)
    corr = torch.from_numpy(rng.standard_normal((4, 60_000)).astype(np.float32)).to(cuda_device)
    corr[1, 5000:30000] = -100.0
    n_valid = [60_000, 59_000, 30_000, 2 * spr + 5]
    got = select_peaks(corr, n_valid, spr, md, 64)
    want = select_peaks_plain(corr, n_valid, spr, md, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_cuda_decode_matches_cpu_decode(cuda_device):
    """A short decode on the card equals the CPU decode: same sync list,
    same u8 image (every op rounds once on both devices)."""
    signal, _ = synth_recording(n_rows=14, sample_rate=48000, noise_db=14.0, seed=2)
    gpu = Decoder(PROFILES["standard"]).decode_render_input(signal, len(signal), Rate(48000))
    cpu = Decoder(PROFILES["standard"], device="cpu").decode_render_input(signal, len(signal), Rate(48000))
    assert gpu[1] == cpu[1]
    np.testing.assert_array_equal(gpu[0], cpu[0])


@pytest.mark.cuda
def test_cuda_select_overflow_raises(cuda_device):
    corr = torch.zeros((1, 50_000), device=cuda_device)
    with pytest.raises(RuntimeError, match="max_peaks"):
        select_peaks(corr, [50_000], 2080, 1664, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("rin,rout", [(48000, 11025), (11025, 48000), (24960, 12480)])
def test_cuda_resample_tool_matches_cpu(cuda_device, tmp_path, rin, rout):
    """The WAV -> WAV tool on the card (K1 on its float32 samples:
    "phase" at 48000 -> 11025, whose m > 4 l; "class" at 11025 -> 48000;
    "block" at l == 1) writes the same WAV as on the CPU: the kernel is
    bit-equal to its twin."""
    from noaa_apt_tpu_torch.graph import resample_tool
    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.io.context import Context

    signal, _ = synth_recording(n_rows=8, sample_rate=rin, seed=1)
    wav.write_wav(tmp_path / "in.wav", signal, wav.WavSpec(1, rin, 16, "int"))
    rs.polyphase_resample.launches = 0
    for dev, name in ((cuda_device, "gpu.wav"), ("cpu", "cpu.wav")):
        resample_tool.resample(Context.resample(), cfg.Settings(), tmp_path / "in.wav",
                               tmp_path / name, rout, device=dev)
        if dev == cuda_device:
            assert rs.polyphase_resample.last_variant == {48000: "phase", 11025: "class", 24960: "block"}[rin]
    assert rs.polyphase_resample.launches == 1
    assert (tmp_path / "gpu.wav").read_bytes() == (tmp_path / "cpu.wav").read_bytes()


@pytest.mark.cuda
def test_cuda_cli_map_and_auto_rotate_match_cpu(cuda_device, tmp_path, monkeypatch):
    """``-m yes -R auto`` with a TLE file and a start time: the card's PNG
    is the CPU's within +-1 on 0.1% of pixels (the overlay is host work on
    the same grey rows)."""
    from noaa_apt_tpu_torch import cli
    from noaa_apt_tpu_torch.geo import states
    from noaa_apt_tpu_torch.io import png, wav

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    monkeypatch.setattr(states, "_download_failed", [True])
    monkeypatch.setattr(cli, "prefetch_states_async", lambda: states.get_states_shp())
    signal, _ = synth_recording(n_rows=60, sample_rate=11025, noise_db=20.0, seed=3)
    wav.write_wav(tmp_path / "pass.wav", signal, wav.WavSpec(1, 11025, 16, "int"))
    (tmp_path / "tle.txt").write_text(
        "NOAA 19\n"
        "1 33591U 09005A   20028.54874297  .00000001  00000-0  25623-4 0  9996\n"
        "2 33591  99.1936  30.2411 0014855 109.6767 250.6008 14.12393428565240\n")
    flags = ["-m", "yes", "-R", "auto", "-T", str(tmp_path / "tle.txt"), "-t",
             "2020-01-26T09:23:20+00:00", "-q"]
    for dev in ("cuda", "cpu"):
        assert cli.main([str(tmp_path / "pass.wav"), "-o", str(tmp_path / f"{dev}.png"),
                         "--device", dev, *flags]) == 0
    got, want = png.read_png(tmp_path / "cuda.png"), png.read_png(tmp_path / "cpu.png")
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).mean() <= 1e-3


def _k4_case(name: str) -> np.ndarray:
    """Work signals of the codec's regimes (``tests/test_pack.py``'s cases,
    rebuilt here without the JAX package): a carrier, escapes, a ragged
    tail, full-scale noise."""
    t = np.arange(40_000)
    carrier = np.sin(2 * np.pi * 2400 / 12480 * t)
    if name == "am_carrier":
        return ((8000 + 7000 * np.sin(2 * np.pi * 0.001 * t)) * carrier).astype(np.int16)
    if name == "mixed_quiet_spikes":
        x = (300 * carrier).astype(np.int16)
        x[7000:7000 + 2000] = np.random.default_rng(7).integers(-32768, 32768, 2000)
        return x
    if name == "ragged_tail":
        return np.arange(128 * 2 + 17, dtype=np.int16)
    return np.random.default_rng(0).integers(-32768, 32768, 4096).astype(np.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["am_carrier", "mixed_quiet_spikes", "ragged_tail", "noise_full_scale"])
def test_cuda_unpack_kernel_bit_equal(cuda_device, name):
    """K4 against its twin, escape padding included; the decode is the
    encoder's input."""
    from noaa_apt_tpu_torch.ops import pack as pk

    x = _k4_case(name)
    p = pk.pack_work_i16(x, 12480)
    n_esc_pad = max(4, len(p.esc_idx) + 3)
    buf = torch.from_numpy(pk.seal_packed(p, n_esc_pad).view(np.int32))
    pk.unpack_sealed.launches = 0
    got = pk.unpack_sealed(buf.to(cuda_device), p.nb, p.w_lo, n_esc_pad, p.coeff)
    torch.cuda.synchronize()
    assert pk.unpack_sealed.launches == 1
    assert torch.equal(got.cpu(), pk.unpack_sealed_plain(buf, p.nb, p.w_lo, n_esc_pad, p.coeff))
    np.testing.assert_array_equal(got.cpu().numpy()[: len(x)], x)


@pytest.mark.cuda
@pytest.mark.parametrize("w_lo", [4, 7, 13, 16])
def test_cuda_unpack_kernel_corrupt_buffer(cuda_device, w_lo):
    """Random words (int32 wraparound in the recurrence) and unique escape
    indices, negative and out of range: K4 equals its twin."""
    from noaa_apt_tpu_torch.ops import pack as pk

    rng = np.random.default_rng(w_lo)
    nb, n_esc_pad = 77, 8
    words = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    words[nb : nb + n_esc_pad] = np.array([-1, 5, -77, nb, -78, 2**31 - 1, 40, -30], np.int32).view(np.uint32)
    buf = torch.from_numpy(words.view(np.int32))
    got = pk.unpack_sealed(buf.to(cuda_device), nb, w_lo, n_esc_pad, 11620)
    assert torch.equal(got.cpu(), pk.unpack_sealed_plain(buf, nb, w_lo, n_esc_pad, 11620))


@pytest.mark.cuda
@pytest.mark.parametrize("w_lo", [4, 9, 16])
def test_cuda_unpack_kernel_duplicate_indices(cuda_device, w_lo):
    """Escape indices that name blocks more than once (repeats, -k beside
    nb - k, one block named by many rows, some of them in other CTAs'
    ranges): the last row naming a block wins, on the card as in the
    twin."""
    from noaa_apt_tpu_torch.ops import pack as pk

    rng = np.random.default_rng(100 + w_lo)
    nb, n_esc_pad = 1500, 700
    words = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    idx = rng.integers(-nb, nb, n_esc_pad).astype(np.int32)
    idx[:40] = 3
    idx[40:80:2], idx[41:80:2] = -5, nb - 5
    idx[-20:] = [nb, -nb - 1, 2**31 - 1, 600, 600, -900, 600, 511, 512, -989] * 2
    words[nb : nb + n_esc_pad] = idx.view(np.uint32)
    buf = torch.from_numpy(words.view(np.int32))
    got = pk.unpack_sealed(buf.to(cuda_device), nb, w_lo, n_esc_pad, 11620)
    assert torch.equal(got.cpu(), pk.unpack_sealed_plain(buf, nb, w_lo, n_esc_pad, 11620))
    assert torch.equal(got, pk.unpack_sealed_plain(buf.to(cuda_device), nb, w_lo, n_esc_pad, 11620))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["host", "host16", "host16c", "host8"])
def test_cuda_host_ingest_render_matches_cpu(cuda_device, mode):
    """Each host mode on the card: K1 does not launch, host16c launches K4
    once, and the render equals the CPU's (the same payload; every kernel
    is bit-equal to its twin)."""
    from noaa_apt_tpu_torch import ops

    x = _pcm_rows(48000, 24)
    gpu = Decoder(PROFILES["standard"], ingest=mode)
    cpu = Decoder(PROFILES["standard"], device="cpu", ingest=mode)
    ops.reset_launch_counts()
    got = gpu.decode_render(gpu.prepare_work(x, Rate(48000), to_device=(mode == "host16c")))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert launches["polyphase_resample"] == 0 and launches["select_peaks"] == 1
    assert launches["unpack_sealed"] == (1 if mode == "host16c" else 0)
    want = cpu.decode_render(cpu.prepare_work(x, Rate(48000), to_device=(mode == "host16c")))
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
def test_cuda_batched_renders_launch_k3_once(cuda_device):
    """``decode_render_batch`` and ``decode_render_input_batch`` on the
    card: one K3 launch per batch, each member equal to its unbatched
    render."""
    from noaa_apt_tpu_torch import ops

    dec = Decoder(PROFILES["standard"], ingest="host16c")
    sigs = [_pcm_rows(48000, 20), _pcm_rows(48000, 20)[:-1000]]  # one bucket, one (w_lo, n_esc_pad)
    payloads = [dec.prepare_work(s, Rate(48000), to_device=True) for s in sigs]
    ops.reset_launch_counts()
    got = dec.decode_render_batch(payloads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["select_peaks"] == 1 and ops.launch_counts()["unpack_sealed"] == 2
    for p, (gray, sync_pos) in zip(payloads, got):
        want_gray, want_sync = dec.decode_render(p)
        assert sync_pos == want_sync
        np.testing.assert_array_equal(gray, want_gray)
    ops.reset_launch_counts()
    got = dec.decode_render_input_batch(sigs, [len(s) for s in sigs], Rate(48000))
    assert ops.launch_counts()["select_peaks"] == 1 and ops.launch_counts()["polyphase_resample"] == 2
    for s, (gray, sync_pos) in zip(sigs, got):
        want_gray, want_sync = dec.decode_render_input(s, len(s), Rate(48000))
        assert sync_pos == want_sync
        np.testing.assert_array_equal(gray, want_gray)


@pytest.mark.cuda
@pytest.mark.parametrize("ingest", ["device", "host16c"])
def test_cuda_fleet_matches_single_file_renders(cuda_device, tmp_path, monkeypatch, ingest):
    """``decode_fleet`` on the card over 48 kHz and 11025 Hz passes and a
    header-only WAV: exactly that one fails; each RGBA PNG is byte-equal to
    the single-file CLI's of the same WAV and ingest; device ingest
    launches K1, K2 and K3 once a pass, host16c K2 and K4 once a pass and
    K3 once a dispatched group."""
    from noaa_apt_tpu_torch import cli, ops
    from noaa_apt_tpu_torch.io import wav
    from noaa_apt_tpu_torch.serve import decode_fleet

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    paths = []
    for rate in (48000, 11025):
        for copy in range(2):
            paths.append(tmp_path / f"p{rate}_{copy}.wav")
            wav.write_wav(paths[-1], _pcm_rows(rate, 24).astype(np.float32), wav.WavSpec(1, rate, 16, "int"))
    trunc = tmp_path / "trunc.wav"
    trunc.write_bytes(paths[0].read_bytes()[:44])
    batches = []
    real = Decoder.decode_render_batch
    monkeypatch.setattr(Decoder, "decode_render_batch", lambda self, *a, **kw: batches.append(1) or real(self, *a, **kw))
    ops.reset_launch_counts()
    rep = decode_fleet([*paths, trunc], tmp_path / "fleet", ingest=ingest, gray_png="never", fleet_batch=4)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert [r.input_path for r in rep.failed] == [trunc] and len(rep.ok) == 4
    n = len(paths)
    if ingest == "device":
        assert launches == {"polyphase_resample": n, "demod_fir_corr": n, "select_peaks": n, "unpack_sealed": 0}
        assert not batches
    else:
        # K4 runs for the payloads that compress (the same C++ packer as on the CPU).
        cpu = Decoder(PROFILES["standard"], device="cpu", ingest="host16c")
        packed = sum(isinstance(cpu.prepare_work(*wav.load_device_ready(p), to_device=True), PackedWorkPayload)
                     for p in paths)
        assert packed >= 2
        assert launches == {"polyphase_resample": 0, "demod_fir_corr": n, "select_peaks": len(batches),
                            "unpack_sealed": packed}
        assert 2 <= len(batches) <= n
    assert rep.link["uploaded_MB"] > 0 and rep.link["up_wall_s"] > 0
    for p, r in zip(paths, rep.ok):
        single = tmp_path / f"single_{p.stem}.png"
        assert cli.main([str(p), "-o", str(single), "-q", "--ingest", ingest]) == 0
        assert single.read_bytes() == r.output_path.read_bytes()


# K1 at m = 1 (the export grid, ops/resample.expanded_filtered): (profile,
# rate, variant). The block variant's CTA then spans 256 + R samples for
# 256*13 outputs, the class variant's segment T + 1 samples.
K1_M1_CASES = [("standard", 48000, "block"), ("standard", 11025, "class"), ("fast", 11025, "class")]


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz,variant", K1_M1_CASES)
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_cuda_resample_m1_bit_equal(cuda_device, profile_name, rate_hz, variant, dtype):
    """K1 at m = 1 over the decode's polyphase tables (the export grid's
    ``ef``): ``torch.equal`` to the twin, in one launch and in chunks."""
    from noaa_apt_tpu_torch.graph.decode import _ingest_filter, _plan_resample_with_filter

    p = PROFILES[profile_name]
    l, _, coeff = _plan_resample_with_filter(Rate(rate_hz), Rate(p.work_rate), _ingest_filter(p, Rate(rate_hz)))
    x = torch.from_numpy(_pcm(rate_hz)[:3001]).to(cuda_device).to(getattr(torch, dtype))
    got = rs.expanded_filtered(x, l, coeff)
    assert rs.polyphase_resample.last_variant == variant and got.shape[0] == 3001 * l - (len(coeff) - 1) // 2
    p_c, s_c, bank, _, _ = rs.phase_tables(rs.resample_plan(3001, l, 1, coeff))
    args = [torch.from_numpy(a).to(cuda_device) for a in (bank, p_c.astype(np.int32), s_c.astype(np.int32))]
    n_out = got.shape[0]
    assert torch.equal(got, rs.polyphase_resample_plain(x, *args, 1, n_out))
    cuts = [0, 5, n_out // 2 + 3, n_out]
    parts = [rs.polyphase_resample(x, *args, 1, b - a, k0=a) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(parts), got)


@pytest.mark.cuda
@pytest.mark.parametrize("rate_hz,profile_name", [(11025, "standard"), (48000, "standard"), (24960, "standard")])
def test_cuda_stream_matches_offline_decode(cuda_device, rate_hz, profile_name):
    """The stream on the card: rows and sync positions equal to the card's
    offline decode and to the CPU stream's, bit for bit; K1 and K2 once a
    chunk, K3 never."""
    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.stream import StreamingDecoder

    signal = _pcm_rows(rate_hz, 24).astype(np.float32)
    offline = Decoder(PROFILES[profile_name]).decode(signal, Rate(rate_hz))
    rows = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launch_counts()
        sd = StreamingDecoder(PROFILES[profile_name], Rate(rate_hz), device=dev)
        out = [sd.push(signal[i : i + 9973]) for i in range(0, len(signal), 9973)]
        out.append(sd.finish())
        torch.cuda.synchronize()
        rows[dev] = np.concatenate(out)
        assert sd.sync_positions == offline.sync_positions
        if dev == "cuda":
            assert ops.launch_counts() == {"polyphase_resample": sd.chunks, "demod_fir_corr": sd.chunks,
                                           "select_peaks": 0, "unpack_sealed": 0}
    np.testing.assert_array_equal(rows["cuda"], offline.image_np())
    np.testing.assert_array_equal(rows["cuda"], rows["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("rate_hz", [48000, 24960])
def test_cuda_decode_with_steps_matches_offline(cuda_device, tmp_path, rate_hz):
    """The step-exporting decode on the card: the offline decode's signal
    bit for bit, K1 twice (work rate, then 4160 Hz), K2 and K3 once."""
    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.graph.debug import decode_with_steps
    from noaa_apt_tpu_torch.io.context import Context

    signal = _pcm_rows(rate_hz, 14)
    offline = Decoder(PROFILES["standard"]).decode(signal, Rate(rate_hz))
    ops.reset_launch_counts()
    flat, positions = decode_with_steps(Context.decode(export_wav=True, output_dir=tmp_path),
                                        PROFILES["standard"], signal, Rate(rate_hz))
    assert ops.launch_counts() == {"polyphase_resample": 2, "demod_fir_corr": 1, "select_peaks": 1,
                                   "unpack_sealed": 0}
    assert positions == offline.sync_positions
    np.testing.assert_array_equal(flat, offline.signal())
    assert len(list(tmp_path.glob("*.wav"))) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("rate_hz", [11025, 48000, 24960])
def test_cuda_sharded_decode_matches_single(cuda_device, rate_hz):
    """Four shards on the one card (``["cuda:0"] * 4``): sync list and
    rows byte-equal to the card's one-device decode, the fused u8 render
    too; K1 and K2 once a shard, K3 once a decode."""
    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.parallel import Mesh, ShardedDecoder

    pcm = _pcm_rows(rate_hz, 24)
    single = Decoder(PROFILES["standard"]).decode(pcm, Rate(rate_hz))
    sdec = ShardedDecoder(PROFILES["standard"], Mesh(["cuda:0"] * 4, ("seq",)))
    ops.reset_launch_counts()
    sharded = sdec.decode(pcm, Rate(rate_hz))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"polyphase_resample": 4, "demod_fir_corr": 4, "select_peaks": 1,
                                   "unpack_sealed": 0}
    assert sharded.sync_positions == single.sync_positions
    assert torch.equal(sharded.image, single.image)
    u8_1, sync_1 = Decoder(PROFILES["standard"]).decode_render_input(pcm, len(pcm), Rate(rate_hz))
    u8_s, sync_s = sdec.decode_render_input(pcm, len(pcm), Rate(rate_hz))
    assert sync_s == sync_1 and np.array_equal(u8_s, u8_1)
    assert set(sdec.last_stage_ms) >= {"upload", "halo", "resample", "demod_fir_corr", "gather", "select"}


@pytest.mark.cuda
def test_cuda_gui_decode_launches_each_kernel_once(cuda_device, tmp_path, monkeypatch):
    """The GUI's Decode on the card (headless: in-memory widgets, inline
    ``idle_add``): K1, K2 and K3 once each, the cached rows on the card;
    Process then launches nothing, and its image equals the same GUI's on
    the CPU."""
    from noaa_apt_tpu_torch import ops
    from noaa_apt_tpu_torch.gui import state as gstate
    from noaa_apt_tpu_torch.gui import work
    from noaa_apt_tpu_torch.io import config as cfg
    from noaa_apt_tpu_torch.io import wav

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    wav.write_wav(tmp_path / "rec.wav", _pcm_rows(48000, 24).astype(np.float32),
                  wav.WavSpec(1, 48000, 16, "int"))
    images = {}
    for device in (cuda_device, torch.device("cpu")):
        widgets = gstate.Widgets()
        state = gstate.GuiState(settings=cfg.build_settings(cfg.load_de_settings()), device=device)
        gstate.set_widgets(widgets)
        gstate.set_state(state)
        widgets.dec_input_chooser.set(str(tmp_path / "rec.wav"))
        widgets.p_rotate_combo.set("no")
        ops.reset_launch_counts()
        work.decode().join(timeout=300)
        torch.cuda.synchronize()
        assert widgets.progress.description == "Decoded", widgets.info.text
        launches = ops.launch_counts()
        work.process().join(timeout=300)
        torch.cuda.synchronize()
        assert widgets.progress.description == "Processed", widgets.info.text
        assert ops.launch_counts() == launches
        if device.type == "cuda":
            assert launches == {"polyphase_resample": 1, "demod_fir_corr": 1, "select_peaks": 1,
                                "unpack_sealed": 0}
            assert state.decoded_signal.image.device.type == "cuda"
        images[device.type] = state.processed_image
    np.testing.assert_array_equal(images["cuda"], images["cpu"])


def _write_stereo_f32(path, ch0: np.ndarray, ch1: np.ndarray, rate: int) -> None:
    """SDR#'s layout: 32-bit float, a ``fact`` chunk, the data 58 bytes in."""
    import struct

    data = np.stack([ch0, ch1], axis=1).astype("<f4")
    fmt = struct.pack("<HHIIHHH", 3, 2, rate, rate * 8, 8, 32, 0)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"fact" + struct.pack("<II", 4, len(ch0))
            + b"data" + struct.pack("<I", data.nbytes) + data.tobytes())
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


@pytest.mark.cuda
def test_cuda_upload_ring_equals_the_host_copy_and_pins_once(cuda_device, tmp_path, monkeypatch):
    """A 10-minute 48 kHz stereo float WAV and a mono int16 one, mapped as
    the CLI loads them, staged through the pinned ring: K1's input is the
    host copy's upload, ``torch.from_numpy(np.array(view))``, bit for bit;
    the second upload of each makes no ring and its slots stay pinned."""
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph import upload
    from noaa_apt_tpu_torch.io import wav

    rng = np.random.default_rng(23)
    pcm = rng.integers(-20000, 20000, 48000 * 600, dtype=np.int16)
    scaled = pcm.astype(np.float32) * np.float32(2.0**-15)
    _write_stereo_f32(tmp_path / "f32.wav", scaled, -scaled, 48000)
    wav.write_wav(tmp_path / "i16.wav", pcm.astype(np.float32), wav.WavSpec(1, 48000, 16, "int"))
    dec = Decoder(STANDARD, device=cuda_device)
    made = []
    init = upload.UploadRing.__init__

    def counted(self, *a, **kw):
        made.append(self)
        init(self, *a, **kw)

    monkeypatch.setattr(upload.UploadRing, "__init__", counted)
    for name in ("f32.wav", "i16.wav"):
        for call in range(2):
            view = wav.load_device_ready(tmp_path / name)[0]
            want = torch.from_numpy(np.array(view)).to(cuda_device)
            made.clear()
            got = dec._upload(view, len(view))
            torch.cuda.synchronize()
            assert got.dtype == want.dtype and got.is_contiguous()
            if got.dtype == torch.float32:
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            else:
                assert torch.equal(got, want)
            assert dec.last_upload["chunks"] > 0
            if call:
                assert made == []
    ring = upload.upload_ring(cuda_device)
    assert all(s.is_pinned() for s in ring.slots)


@pytest.mark.cuda
def test_cuda_cli_44100_slow_matches_cpu_and_builds_its_tables_in_the_decode(cuda_device, tmp_path, monkeypatch):
    """``-p slow -c 98_percent`` on a 44100 Hz pass (K1 "class", l 208,
    m 441): the card's PNG is the CPU's byte for byte, the report names
    "class", and the call records ``apt.tables`` twice (K1's and K2's
    tables) and, on the card, ``apt.k1.table`` once, inside ``apt.decode``."""
    from torch.profiler import ProfilerActivity, profile

    from noaa_apt_tpu_torch import cli
    from noaa_apt_tpu_torch.io import wav

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "cfg"))
    signal, _ = synth_recording(n_rows=40, sample_rate=44100, noise_db=20.0, seed=44)
    wav.write_wav(tmp_path / "pass.wav", signal, wav.WavSpec(1, 44100, 16, "int"))
    flags = ["-q", "-p", "slow", "-c", "98_percent"]
    reports = {}
    for dev in ("cuda", "cpu"):
        reports[dev] = {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            assert cli.main([str(tmp_path / "pass.wav"), "-o", str(tmp_path / f"{dev}.png"), "--device", dev,
                             *flags], report=reports[dev]) == 0
        events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("apt.")]
        (_, da, db), = [e for e in events if e[0] == "apt.decode"]
        tables = [e for e in events if e[0] in ("apt.tables", "apt.k1.table")]
        assert sorted(name for name, _, _ in tables) == ["apt.k1.table"] * (dev == "cuda") + ["apt.tables"] * 2
        assert all(da <= a <= b <= db for _, a, b in tables)
    assert reports["cuda"]["k1_variant"] == "class" and reports["cpu"]["k1_variant"] == "plain"
    assert reports["cuda"]["sync_positions"] == reports["cpu"]["sync_positions"]
    assert (tmp_path / "cuda.png").read_bytes() == (tmp_path / "cpu.png").read_bytes()
