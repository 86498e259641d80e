"""The traffic generator: the same seed gives the same passes, every seed
the same set of lengths."""

import numpy as np
import pytest
import torch

from aptbench import spec
from aptbench.gen import pool, synth


def test_pass_is_deterministic_per_seed():
    a = synth.make_pass(2**31 + 11, 6.0, 11025, 10.0, 30.0, "cpu")
    b = synth.make_pass(2**31 + 11, 6.0, 11025, 10.0, 30.0, "cpu")
    c = synth.make_pass(2**31 + 12, 6.0, 11025, 10.0, 30.0, "cpu")
    assert a.dtype == torch.int16 and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_pass_length_and_range():
    x = synth.make_pass(5, 6.0, 48000, 10.0, 30.0, "cpu")
    assert x.shape[0] == 12 * 2080 * 48000 // 4160
    assert int(x.abs().max()) < 32767  # no clipping at the SNR floor


def test_snr_profile_noisier_at_the_edges():
    x = synth.make_pass(7, 30.0, 11025, 5.0, 40.0, "cpu").double()
    n = x.shape[0]
    edge, mid = x[: n // 20], x[n // 2 - n // 40 : n // 2 + n // 40]
    # the carrier is the same; the noise adds power where the SNR is low
    assert edge.pow(2).mean() > 1.1 * mid.pow(2).mean()


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3])
def test_pool_lengths_fixed_order_seeded(tmp_path, seed):
    traffic = dict(spec.Spec.traffic("single"), pool=3, minutes=[0.1, 0.2])
    config = spec.load_json(spec.HERE / "configs" / "wx11k_std.json")
    got = pool.make_pool(tmp_path / "a", seed, config, traffic, "cpu")
    again = pool.make_pool(tmp_path / "b", seed, config, traffic, "cpu")
    assert sorted(round(p.seconds * 2) for p in got) == [12, 18, 24]
    for p, q in zip(got, again):
        assert p.path.name == q.path.name
        assert np.array_equal(pool.read_wav(p.path), pool.read_wav(q.path))


def test_pool_files_are_named_as_the_recorder_names_them(tmp_path):
    traffic = dict(spec.Spec.traffic("fleet"), pool=2, minutes=[0.1, 0.1])
    config = spec.Spec(spec.HERE.parent).config("sdr48k_std")
    names = [p.path.name for p in pool.make_pool(tmp_path, 1, config, traffic, "cpu")]
    assert names == ["gqrx_20200126_010000_137100000.wav", "gqrx_20200126_024100_137100000.wav"]
