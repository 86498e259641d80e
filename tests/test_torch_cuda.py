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
from noaa_apt_tpu_torch.graph.decode import DecodeTables, Decoder
from noaa_apt_tpu_torch.ops import demod as dm
from noaa_apt_tpu_torch.ops import resample as rs
from noaa_apt_tpu_torch.ops.select import select_peaks, select_peaks_plain
from noaa_apt_tpu_torch.ops.stage import demod_fir_corr, demod_fir_corr_plain
from noaa_apt_tpu_torch.synth import synth_recording

torch.set_num_threads(1)


def _pcm(rate_hz: int) -> np.ndarray:
    x, _ = synth_recording(n_rows=2, sample_rate=rate_hz, noise_db=15.0, seed=0)
    return np.round(x / np.abs(x).max() * 30000).astype(np.int16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("profile_name,rate_hz", [("standard", 11025), ("standard", 48000), ("slow", 11011)])
def test_cuda_resample_kernel_bit_equal(cuda_device, profile_name, rate_hz):
    """slow/11011 Hz has l = 1600 and a 312 KB bank, past a block's
    shared memory: K1 then reads the bank from global memory."""
    t = DecodeTables.design(PROFILES[profile_name], Rate(rate_hz))
    x = torch.from_numpy(_pcm(rate_hz)).to(cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (t.bank, t.p_c, t.s_c)]
    n_out = t.work_len(x.shape[0])
    got = rs.polyphase_resample(x, *args, t.m, n_out)
    assert torch.equal(got, rs.polyphase_resample_plain(x, *args, t.m, n_out))


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
