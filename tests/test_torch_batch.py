"""The port's batched and deferred renders (``decode_render_batch``,
``decode_render_input_batch``, the ``PendingRender*`` classes) on the CPU.

Each live member of a batch equals the port's unbatched render byte for
byte (K1/K4 and K2 run per member, K3 once over the batch's rows, which
it selects row by row); the batches agree with the JAX package's batched
renders (sync lists equal, u8 within +-1 on at most 0.1%); too-short and
too-noisy members become error entries at their input index; every
mixed-batch guard raises with the JAX package's message.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synth_i16
from noaa_apt_tpu.core.frequency import Rate as JRate
from noaa_apt_tpu.core.profiles import PROFILES as JPROFILES
from noaa_apt_tpu.err import InternalError as JInternalError
from noaa_apt_tpu.graph import decode as jdecode

from noaa_apt_tpu_torch import err
from noaa_apt_tpu_torch.core.frequency import Rate
from noaa_apt_tpu_torch.core.profiles import PROFILES
from noaa_apt_tpu_torch.graph import decode as pdecode
from noaa_apt_tpu_torch.graph.decode import (Decoder, PackedWorkPayload, PendingRenderBatch,
                                             PendingRenderTelemetryBatch, pad_bucket)

torch.set_num_threads(1)

RATE = 11025
_SIGNALS: dict = {}


def _signal(rows: int, seed: int = 5, noise_db: float = 30.0) -> np.ndarray:
    key = (rows, seed, noise_db)
    if key not in _SIGNALS:
        _SIGNALS[key] = synth_i16(rows, RATE, noise_db=noise_db, seed=seed)[0]
    return _SIGNALS[key]


def _same_bucket_members(sig: np.ndarray, n: int = 3) -> list:
    """``n`` recordings of different lengths whose work signals share one
    ``pad_bucket`` (and, packed, one block count)."""
    work = Decoder(PROFILES["standard"], device="cpu").tables(Rate(RATE)).work_len
    out = [sig]
    for trim in range(997, 100_000, 997):
        s = sig[: len(sig) - trim]
        if pad_bucket(work(len(s))) != pad_bucket(work(len(sig))):
            break
        out.append(s)
        if len(out) == n:
            return out
    raise AssertionError("no trims within one bucket")


def _u8_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max(initial=0) <= 1 and (d > 0).sum() <= 1e-3 * d.size


def _count_select_calls(monkeypatch) -> list:
    """Record the row count of every K3 call the decoder makes."""
    calls = []
    real = pdecode.select_peaks

    def spy(corr, *a, **kw):
        calls.append(corr.shape[0])
        return real(corr, *a, **kw)

    monkeypatch.setattr(pdecode, "select_peaks", spy)
    return calls


@pytest.mark.parametrize("mode", ["host", "host16", "host16c", "host8"])
def test_render_batch_equals_unbatched(monkeypatch, mode):
    """B = 4 payloads: three lengths in one bucket and a too-short one
    (an error entry at index 2).  K3 runs once, over the three live rows."""
    dec = Decoder(PROFILES["standard"], device="cpu", ingest=mode)
    sigs = _same_bucket_members(_signal(40))
    short = _signal(40)[: len(_signal(40)) // 8]
    payloads = [dec.prepare_work(s, Rate(RATE), to_device=True) for s in sigs[:2]]
    payloads += [dec.prepare_work(short, Rate(RATE), to_device=True),
                 dec.prepare_work(sigs[2], Rate(RATE), to_device=True)]
    if mode == "host16c":
        live = [payloads[b] for b in (0, 1, 3)]
        assert all(isinstance(p, PackedWorkPayload) for p in live)
        assert len({(p.nb, p.w_lo, p.n_esc_pad) for p in live}) == 1
    calls = _count_select_calls(monkeypatch)
    got = dec.decode_render_batch(payloads)
    assert calls == [3]
    assert isinstance(got[2], err.InternalError) and "too short" in str(got[2])
    for b in (0, 1, 3):
        gray, sync_pos = dec.decode_render(payloads[b])
        assert got[b][1] == sync_pos
        np.testing.assert_array_equal(got[b][0], gray)
    assert "select" in dec.last_stage_ms


@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_render_input_batch_equals_unbatched(monkeypatch, dtype):
    """Raw recordings of three lengths and a tiny one; then the same
    members pre-uploaded as tensors padded to ``pad_bucket(max(n))``."""
    dec = Decoder(PROFILES["standard"], device="cpu")
    sigs = [_signal(24, seed=1).astype(dtype), _signal(16, seed=2).astype(dtype),
            _signal(12, seed=3)[: RATE * 2].astype(dtype), _signal(20, seed=4).astype(dtype)]
    trues = [len(s) for s in sigs]
    calls = _count_select_calls(monkeypatch)
    got = dec.decode_render_input_batch(sigs, trues, Rate(RATE))
    assert calls == [3]
    assert isinstance(got[2], err.InternalError) and "too short" in str(got[2])
    want = {b: dec.decode_render_input(sigs[b], trues[b], Rate(RATE)) for b in (0, 1, 3)}
    for b, (gray, sync_pos) in want.items():
        assert got[b][1] == sync_pos
        np.testing.assert_array_equal(got[b][0], gray)
    n_pad = pad_bucket(max(trues))
    devs = []
    for s in sigs:
        buf = np.zeros(n_pad, dtype)
        buf[: len(s)] = s
        devs.append(torch.from_numpy(buf))
    again = dec.decode_render_input_batch(devs, trues, Rate(RATE))
    assert isinstance(again[2], err.InternalError)
    for b, (gray, sync_pos) in want.items():
        assert again[b][1] == sync_pos
        np.testing.assert_array_equal(again[b][0], gray)


def test_mixed_int16_and_float_input_batch_goes_float():
    """Host arrays that are not all int16 all go as float32, as in the JAX
    package; the result is the same (int16 -> f32 is exact)."""
    dec = Decoder(PROFILES["standard"], device="cpu")
    a, b = _signal(16, seed=1), _signal(16, seed=2).astype(np.float32)
    got = dec.decode_render_input_batch([a, b], [len(a), len(b)], Rate(RATE))
    for s, (gray, sync_pos) in zip((a, b), got):
        want_gray, want_sync = dec.decode_render_input(s, len(s), Rate(RATE))
        assert sync_pos == want_sync
        np.testing.assert_array_equal(gray, want_gray)


def test_batches_match_jax_batches():
    """The port's two batched renders against the JAX package's (host16
    payloads; raw int16 recordings)."""
    sigs = _same_bucket_members(_signal(40))
    dec = Decoder(PROFILES["standard"], device="cpu", ingest="host16")
    jdec = jdecode.Decoder(JPROFILES["standard"], ingest="host16")
    got = dec.decode_render_batch([dec.prepare_work(s, Rate(RATE)) for s in sigs])
    want = jdec.decode_render_batch([jdec.prepare_work(s, JRate(RATE)) for s in sigs])
    for (g, s), (jg, js) in zip(got, want):
        assert s == js
        _u8_close(g, jg)
    raw = [_signal(20, seed=1), _signal(16, seed=2)]
    trues = [len(s) for s in raw]
    got = dec.decode_render_input_batch(raw, trues, Rate(RATE))
    want = jdec.decode_render_input_batch(raw, trues, JRate(RATE))
    for (g, s), (jg, js) in zip(got, want):
        assert s == js
        _u8_close(g, jg)


def test_telemetry_batch_isolates_short_member():
    """Telemetry levels per member; a member with >= 10 rows but fewer
    than a telemetry frame needs is an error entry, as in the JAX batch."""
    dec = Decoder(PROFILES["standard"], device="cpu")
    sigs = [_signal(230, seed=0), _signal(104, seed=1)]
    trues = [len(s) for s in sigs]
    pending = dec.decode_render_input_batch(sigs, trues, Rate(RATE), "telemetry", fetch=False)
    assert isinstance(pending, PendingRenderTelemetryBatch)
    got = pending.get()
    want_gray, want_sync = dec.decode_render_input(sigs[0], trues[0], Rate(RATE), "telemetry")
    assert got[0][1] == want_sync
    np.testing.assert_array_equal(got[0][0], want_gray)
    assert isinstance(got[1], err.AptError) and "too short" in str(got[1])
    jgot = jdecode.Decoder(JPROFILES["standard"]).decode_render_input_batch(
        sigs, trues, JRate(RATE), contrast_kind="telemetry")
    assert jgot[0][1] == want_sync and str(jgot[1]) == str(got[1])


def test_too_noisy_member_is_an_error_entry(monkeypatch):
    """A member whose selection finds fewer than 5 sync frames is an error
    entry with the guard's message; its batchmates decode, and the
    unbatched render raises the same error from ``get()``."""
    dec = Decoder(PROFILES["standard"], device="cpu")
    real = pdecode.select_peaks

    def fewer(corr, *a, **kw):
        peaks, lists = real(corr, *a, **kw)
        lists[-1] = lists[-1][:3]
        return peaks, lists

    monkeypatch.setattr(pdecode, "select_peaks", fewer)
    sigs = [_signal(16, seed=1), _signal(16, seed=2)]
    got = dec.decode_render_input_batch(sigs, [len(s) for s in sigs], Rate(RATE))
    assert isinstance(got[1], err.InternalError) and "less than 5 sync frames" in str(got[1])
    assert len(got[0][1]) > 5
    pending = dec.decode_render_input(sigs[1], len(sigs[1]), Rate(RATE), fetch=False)
    with pytest.raises(err.InternalError, match="less than 5 sync frames"):
        pending.get()


def test_deferred_batches_and_empty_batches():
    dec = Decoder(PROFILES["standard"], device="cpu", ingest="host16")
    payloads = [dec.prepare_work(s, Rate(RATE)) for s in _same_bucket_members(_signal(40), 2)]
    got = dec.decode_render_batch(payloads, "minmax")
    pending = dec.decode_render_batch(payloads, "minmax", fetch=False)
    assert isinstance(pending, PendingRenderBatch)
    for (g, s), (g2, s2) in zip(got, pending.get()):
        assert s == s2
        np.testing.assert_array_equal(g, g2)
    assert dec.decode_render_batch([]) == []
    assert dec.decode_render_input_batch([], [], Rate(RATE)) == []
    assert dec.decode_render_batch([], fetch=False).get() == []
    assert dec.decode_render_input_batch([], [], Rate(RATE), "telemetry", fetch=False).get() == []
    short = dec.prepare_work(_signal(40)[:20000], Rate(RATE))
    both = dec.decode_render_batch([short, short])
    assert len(both) == 2 and all(isinstance(e, err.InternalError) for e in both)
    assert all(isinstance(e, err.InternalError)
               for e in dec.decode_render_batch([short], fetch=False).get())


def test_splice_errors_keeps_input_order():
    e1, e3 = err.InternalError("a"), err.InternalError("b")
    assert pdecode._splice_errors(["x", "y"], {1: e1, 3: e3}) == ["x", e1, "y", e3]
    assert pdecode._splice_errors(["x"], None) == ["x"]
    assert pdecode._splice_errors(["x", "y"], {1: e1}) == jdecode._splice_errors(["x", "y"], {1: e1})


def _guard_cases():
    """(name, port call, JAX call) of every mixed-batch refusal."""
    sig = _signal(40)
    work = {}
    for mode in ("host16", "host8", "host16c", "host"):
        d = Decoder(PROFILES["standard"], device="cpu", ingest=mode)
        jd = jdecode.Decoder(JPROFILES["standard"], ingest=mode)
        work[mode] = (d, d.prepare_work(sig, Rate(RATE), to_device=(mode == "host16c")),
                      jd, jd.prepare_work(sig, JRate(RATE), to_device=(mode == "host16c")))
    d, p16, jd, j16 = work["host16"]
    _, p8, _, j8 = work["host8"]
    _, pc, _, jc = work["host16c"]
    _, pf, _, jf = work["host"]
    big, jbig = d.prepare_work(_signal(64, seed=1), Rate(RATE)), jd.prepare_work(_signal(64, seed=1), JRate(RATE))
    return {
        "packed_and_plain": ([pc, p16], [jc, j16]),
        "buckets": ([p16, big], [j16, jbig]),
        "quantization": ([p16, pf], [j16, jf]),
        "dtypes": ([p16, p8], [j16, j8]),
        "packed_geometry": ([pc, dataclasses.replace(pc, w_lo=pc.w_lo + 1)],
                            [jc, dataclasses.replace(jc, w_lo=jc.w_lo + 1)]),
    }, d, jd


@pytest.mark.parametrize("case", ["packed_and_plain", "buckets", "quantization", "dtypes", "packed_geometry"])
def test_mixed_batch_guards_match_jax(case):
    cases, dec, jdec = _guard_cases()
    mine, theirs = cases[case]
    with pytest.raises(JInternalError) as jexc:
        jdec.decode_render_batch(theirs)
    with pytest.raises(err.InternalError) as exc:
        dec.decode_render_batch(mine)
    assert str(exc.value) == str(jexc.value)


def test_preuploaded_input_batch_guards_match_jax():
    dec, jdec = Decoder(PROFILES["standard"], device="cpu"), jdecode.Decoder(JPROFILES["standard"])
    s = _signal(16, seed=1)
    n_pad = pad_bucket(len(s))
    for mine, theirs in (
        ([torch.zeros(n_pad // 2, dtype=torch.float32)], [jnp.zeros(n_pad // 2, jnp.float32)]),
        ([torch.zeros(n_pad, dtype=torch.float32), torch.zeros(n_pad, dtype=torch.int16)],
         [jax.device_put(np.zeros(n_pad, np.float32)), jax.device_put(np.zeros(n_pad, np.int16))]),
    ):
        trues = [len(s)] * len(mine)
        with pytest.raises(JInternalError) as jexc:
            jdec.decode_render_input_batch(theirs, trues, JRate(RATE))
        with pytest.raises(err.InternalError) as exc:
            dec.decode_render_input_batch(mine, trues, Rate(RATE))
        assert str(exc.value) == str(jexc.value)
