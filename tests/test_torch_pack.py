"""The port's host16c codec (``noaa_apt_tpu_torch/ops/pack.py``, its host
C++ encoder and kernel K4's plain twin) against the JAX package's.

Over ``tests/test_pack.py``'s cases: the numpy encoder, the sealed
layout and the host decoder equal the JAX package's bit for bit;
``unpack_sealed`` on a CPU tensor (the twin) equals
``jax.jit(unpack_sealed_device)``, escape padding included, and so does
a corrupt buffer whose escape indices are negative or out of range (the
JAX graph reads them as int32 and wraps ``[-nb, 0)``), and so does one
whose indices name a block more than once (the last row wins); the
port's C++ encoder equals its numpy encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noaa_apt_tpu.ops import pack as jpk
from test_pack import CASES

from noaa_apt_tpu_torch.core.profiles import STANDARD
from noaa_apt_tpu_torch.graph.decode import Decoder
from noaa_apt_tpu_torch.native import pack_work_i16_native
from noaa_apt_tpu_torch.ops import launch_counts, reset_launch_counts
from noaa_apt_tpu_torch.ops import pack as pk

torch.set_num_threads(1)


def _jax_unpack(sealed: np.ndarray, nb: int, w_lo: int, n_esc_pad: int, coeff: int) -> np.ndarray:
    fn = jax.jit(lambda b: jpk.unpack_sealed_device(b, nb, w_lo, n_esc_pad, coeff))
    return np.asarray(fn(jnp.asarray(sealed)))


def _port_unpack(sealed: np.ndarray, nb: int, w_lo: int, n_esc_pad: int, coeff: int) -> np.ndarray:
    buf = torch.from_numpy(np.ascontiguousarray(sealed).view(np.int32))
    return pk.unpack_sealed(buf, nb, w_lo, n_esc_pad, coeff).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_codec_matches_jax(name):
    x = CASES[name]
    p, jp = pk.pack_work_i16(x, 12480), jpk.pack_work_i16(x, 12480)
    assert (p.w_lo, p.coeff, p.n_samples) == (jp.w_lo, jp.coeff, jp.n_samples)
    for a, b in ((p.base, jp.base), (p.anchors, jp.anchors), (p.esc_idx, jp.esc_idx),
                 (p.esc_rows, jp.esc_rows)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    n_esc_pad = max(4, len(p.esc_idx) + 3)
    sealed = pk.seal_packed(p, n_esc_pad)
    np.testing.assert_array_equal(sealed, jpk.seal_packed(jp, n_esc_pad))
    assert sealed.shape[0] == pk.sealed_len(p.nb, p.w_lo, n_esc_pad) == jpk.sealed_len(p.nb, p.w_lo, n_esc_pad)
    np.testing.assert_array_equal(pk.unpack_work_np(p), x)
    assert pk.unit_geometry(p.w_lo) == jpk.unit_geometry(p.w_lo)


@pytest.mark.parametrize("name", sorted(CASES))
def test_unpack_plain_matches_jax_device_graph(name):
    """The twin equals the JAX graph on every case, with three padding
    escape slots beyond the real ones; it counts no launch."""
    x = CASES[name]
    p = pk.pack_work_i16(x, 12480)
    n_esc_pad = max(4, len(p.esc_idx) + 3)
    sealed = pk.seal_packed(p, n_esc_pad)
    reset_launch_counts()
    got = _port_unpack(sealed, p.nb, p.w_lo, n_esc_pad, p.coeff)
    assert launch_counts()["unpack_sealed"] == 0
    assert got.dtype == np.int16 and got.shape == (p.nb * pk.BLOCK,)
    np.testing.assert_array_equal(got, _jax_unpack(sealed, p.nb, p.w_lo, n_esc_pad, p.coeff))
    np.testing.assert_array_equal(got[: len(x)], x)


@pytest.mark.parametrize("w_lo", [4, 13, 16])
def test_corrupt_buffer_matches_jax(w_lo):
    """Random words (the int32 recurrence wraps), and escape indices that
    are negative (counted from the end), out of range both ways (dropped)
    and in range; unique, so the result does not depend on scatter order."""
    rng = np.random.default_rng(w_lo)
    nb, n_esc_pad = 9, 6
    buf = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    buf[nb : nb + n_esc_pad] = np.array([-1, 3, -9, nb, -10, 2**31 - 1], np.int32).view(np.uint32)
    got = _port_unpack(buf, nb, w_lo, n_esc_pad, 11620)
    np.testing.assert_array_equal(got, _jax_unpack(buf, nb, w_lo, n_esc_pad, 11620))
    rows = buf[nb + n_esc_pad : nb + n_esc_pad * 65].view(np.int16).reshape(n_esc_pad, 128)
    np.testing.assert_array_equal(got.reshape(nb, 128)[[nb - 1, 3, 0]], rows[[0, 1, 2]])


DUPLICATE_INDICES = {
    # repeated positive indices, a negative -k beside nb - k, out of
    # range both ways, and padding slots (nb) at the end
    "repeats_and_aliases": [1, 2, 1, -3, 5, 3, -9, 9, 30, -40, 2**31 - 1, 2, 9, 9],
    # one block named by every row: the last row wins
    "all_one_block": [4, -5, 4, 4, -5, 4, 4, -5, 9, 9, 9, 9, 9, 9],
}


@pytest.mark.parametrize("case", sorted(DUPLICATE_INDICES))
@pytest.mark.parametrize("w_lo", [4, 9, 16])
def test_duplicate_escape_indices_match_jax(case, w_lo):
    """Escape indices that name one block more than once (directly, or a
    negative ``-k`` beside ``nb - k``): the twin keeps the last such row,
    as JAX's scatter on the CPU does, and equals the JAX graph."""
    rng = np.random.default_rng(w_lo + len(case))
    nb = 9
    idx = np.array(DUPLICATE_INDICES[case], np.int64).astype(np.int32)
    n_esc_pad = idx.shape[0]
    buf = rng.integers(0, 2**32, pk.sealed_len(nb, w_lo, n_esc_pad), dtype=np.uint32)
    buf[nb : nb + n_esc_pad] = idx.view(np.uint32)
    got = _port_unpack(buf, nb, w_lo, n_esc_pad, 11620)
    np.testing.assert_array_equal(got, _jax_unpack(buf, nb, w_lo, n_esc_pad, 11620))
    rows = buf[nb + n_esc_pad : nb + n_esc_pad * 65].view(np.int16).reshape(n_esc_pad, 128)
    norm = np.where(idx < 0, idx.astype(np.int64) + nb, idx)
    for b in range(nb):
        named = np.nonzero(norm == b)[0]
        if named.size:
            np.testing.assert_array_equal(got.reshape(nb, 128)[b], rows[named[-1]])


def test_unpack_checks_its_arguments():
    buf = torch.zeros(pk.sealed_len(2, 8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="w_lo"):
        pk.unpack_sealed(buf, 2, 17, 4, 11620)
    with pytest.raises(ValueError, match="int32"):
        pk.unpack_sealed(buf.to(torch.int64), 2, 8, 4, 11620)
    with pytest.raises(ValueError, match="layout needs"):
        pk.unpack_sealed(buf[:-1], 2, 8, 4, 11620)


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_encoder_matches_numpy(name):
    """The port's C++ encoder equals its numpy encoder, or declines a
    signal where more than a quarter of the blocks would escape."""
    x = CASES[name]
    p = pk.pack_work_i16(x, 12480)
    pn = pack_work_i16_native(x, 12480)
    if pn == "incompressible":
        assert len(p.esc_idx) > p.nb // 4 + 1
        return
    assert (pn.w_lo, pn.coeff, pn.n_samples) == (p.w_lo, p.coeff, p.n_samples)
    for a, b in ((pn.base, p.base), (pn.anchors, p.anchors), (pn.esc_idx, p.esc_idx),
                 (pn.esc_rows, p.esc_rows)):
        np.testing.assert_array_equal(a, b)


def test_incompressible_signal_declines():
    """Full-scale white noise: the C++ encoder returns "incompressible"
    and ``_pack_payload`` ships the plain i16 payload (None), as the JAX
    decoder does; so does a bucket that is not a whole number of blocks."""
    noise = np.random.default_rng(0).integers(-32768, 32768, pk.BLOCK * 512).astype(np.int16)
    assert pack_work_i16_native(noise, 12480) == "incompressible"
    dec = Decoder(STANDARD, device="cpu", ingest="host16c")
    assert dec._pack_payload(noise, len(noise), 1.0) is None
    assert dec._pack_payload(np.zeros(pk.BLOCK + 1, np.int16), 10, 1.0) is None
    from noaa_apt_tpu.core.profiles import STANDARD as JSTANDARD
    from noaa_apt_tpu.graph.decode import Decoder as JDecoder

    assert JDecoder(JSTANDARD, ingest="host16c")._pack_payload(noise, len(noise), 1.0) is None


def test_predictor_coeff_matches_jax():
    for rate in (12480, 16640, 20800, 11025):
        assert pk.predictor_coeff(rate) == jpk.predictor_coeff(rate)
