"""Streaming (live) APT decode: feed PCM chunks, get image rows out.

Behavioral contract: ``noaa_apt_tpu/stream.py`` (no reference
counterpart: ``decode.rs:43-162`` needs the whole recording in RAM).  A
ground station decoding during the pass pushes samples as they arrive:

    sd = StreamingDecoder(STANDARD, Rate(11025))
    for block in audio_source:        # any chunk sizes
        for row in sd.push(block):    # [2080] f32 rows as they finalize
            ...
    rows = sd.finish()                # the tail
    sd.sync_positions                 # the offline decode's list

Pushing a recording through in any chunk sizes gives the sync positions
of ``Decoder(profile).decode(signal, rate)`` and its rows bit for bit.
Each chunk of ``w`` work samples (about ``chunk_rows`` rows) runs on the
decoder's device over a haloed window of the input: kernel K1
(``ops/resample.polyphase_resample``) resamples it to the work rate and
kernel K2 (``ops/stage.demod_fir_corr``) demodulates, filters and
correlates, exactly as the offline graph does, since both kernels sum
each output's terms in one fixed order whatever its position
(:func:`chunk_alignment`).  The halos cover the resampler's window, the
demod's one-sample history, the FIR tail and the correlation guard.  The
filtered chunk and its correlation come back to host ring buffers, where
the greedy sync selection runs as the reference's left fold
(``decode.rs:236-254``, :class:`_GreedyState`): peaks before the last
are final, so their rows go out at once.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import FINAL_RATE, PX_PER_ROW, err
from .core.frequency import Rate
from .core.profiles import DecodeProfile
from .device import resolve_device
from .graph.decode import DecodeTables
from .ops import demod as dm
from .ops.resample import polyphase_resample
from .ops.stage import demod_fir_corr


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def chunk_alignment(l: int) -> int:
    """The granularity, in work samples, of a chunk's start and of its
    halos: one polyphase period, ``l`` outputs (1 at l == 1).

    K1 computes output ``k = i*l + c`` from the tap row of its class ``c``
    and the inputs from ``s_c[c] + i*m`` on, summed in one fixed order, and
    K2 sums each output's taps and template terms in one fixed order too;
    neither result depends on where the launch starts.  A window that
    starts on a whole period (work sample ``j*l``, input sample ``j*m``)
    therefore sees every output's classes and inputs at the same offsets
    as the offline launch, and gives its floats bit for bit.  (The JAX
    package aligns to its TPU matmul blocks instead, ``out_alignment``.)"""
    return max(1, l)


class _GreedyState:
    """Incremental greedy sync selection: the reference's sequential fold
    (``decode.rs:236-254``) fed segment by segment, a copy of
    ``noaa_apt_tpu/stream.py:_GreedyState``.  ``peaks[:-1]`` are final
    (the loop only appends, or replaces the last entry)."""

    def __init__(self, spr: int):
        self.spr = spr
        self.md = spr * 8 // 10
        self.peaks: list[tuple[int, float]] = [(0, 0.0)]
        self.i = 0  # next corr index to consume

    def feed(self, corr: np.ndarray) -> None:
        peaks, spr, md = self.peaks, self.spr, self.md
        i = self.i
        for c in corr.astype(np.float32, copy=False):
            c = float(c)
            if i - peaks[-1][0] > md:
                while i // spr > len(peaks):
                    peaks.append((i, c))
            elif c > peaks[-1][1]:
                peaks[-1] = (i, c)
            i += 1
        self.i = i

    def positions(self) -> list[int]:
        return [p for p, _ in self.peaks]


class StreamingDecoder:
    """Decode an APT pass incrementally, bit for bit the offline decode.

    ``push(samples)`` takes float32 PCM at ``input_rate`` in any chunk
    sizes and returns the newly final image rows ``[k, PX_PER_ROW]
    float32``; ``finish()`` flushes the tail.  ``sync_positions`` (after
    ``finish``) is the offline decoder's list.  ``sync=False`` slices rows
    at the nominal rate instead (the reference's ``--no-sync``).
    ``device``: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``.

    Counters for the caller: ``chunks`` (each one K1 and one K2 launch),
    ``fold_s`` (host seconds in the greedy fold) and ``chunk_ms`` (per
    chunk, the milliseconds from its upload to its fetch: CUDA events on
    the card, the host clock on the CPU)."""

    def __init__(self, profile: DecodeProfile, input_rate: Rate, sync: bool = True,
                 chunk_rows: int = 8, device=None):
        self.profile = profile
        self.input_rate = input_rate
        self.sync = sync
        self.device = resolve_device(device)
        self.spr = PX_PER_ROW * profile.work_rate // FINAL_RATE
        self.m_final = profile.work_rate // FINAL_RATE

        t = DecodeTables.design(profile, input_rate)
        l, m = t.l, t.m
        self.l, self.m = l, m
        self._work_len = t.work_len
        align = chunk_alignment(l)
        # Work chunk W: about chunk_rows rows, on whole polyphase periods.
        w = _ceil_to(max(1, chunk_rows) * self.spr, align)
        ci = w * m // l
        self.w, self.ci = w, ci
        self.guard = t.template.shape[0]
        taps = t.bank.shape[1]
        l_ctx = _ceil_to(t.taps.shape[0] + 1, align)
        g_ctx = _ceil_to(self.guard, align)
        if l > 1:
            l_in = l_ctx * m // l
            r_in = g_ctx * m // l + int(t.s_c.max()) + taps + 1
        else:
            # causal_tables: output j reads x[j*m - K + 1 .. j*m] (K = taps).
            l_in = l_ctx * m + taps - 1
            r_in = g_ctx * m
        self.l_ctx, self.g_ctx, self.l_in, self.r_in = l_ctx, g_ctx, l_in, r_in
        self._ext_out = l_ctx + w + g_ctx
        # Every table once per decoder, on its device: K1's table cache
        # keys on the bank tensor, so later chunks need no host work.
        dev = self.device
        self._bank, self._p_c, self._s_c = (torch.from_numpy(a).to(dev) for a in (t.bank, t.p_c, t.s_c))
        self._taps = torch.from_numpy(t.taps).to(dev)
        self._tmpl = torch.from_numpy(t.template).to(dev)
        self._cosphi2, self._inv = t.cosphi2, dm.inv_sinphi(t.sinphi)
        self.chunk_bit_exact = True  # K1 and K2 are position-independent (chunk_alignment)

        # -- mutable stream state --
        self._in_buf = np.zeros(0, np.float32)  # input tail (absolute)
        self._in_start = 0  # absolute index of _in_buf[0]
        self._n_in = 0  # total input samples received
        self._k = 0  # chunks processed
        self._f_buf = np.zeros(0, np.float32)  # work-signal tail
        self._f_start = 0  # absolute work index of _f_buf[0]
        self._corr_buf = np.zeros(0, np.float32)  # unconsumed corr tail
        self._corr_fed = 0  # corr samples handed to the selector
        self._greedy = _GreedyState(self.spr)
        self._emitted = 0  # rows emitted so far
        self._finished = False
        self.sync_positions: list[int] | None = None
        self.fold_s = 0.0
        self.chunk_ms: list[float] = []

    @property
    def chunks(self) -> int:
        return self._k

    # -- internals -----------------------------------------------------
    def _chunk(self, ext: np.ndarray, skip: int) -> np.ndarray:
        """K1 and K2 over the haloed window ``ext`` -> ``[f_seg, corr]``
        (``2*w`` floats, or ``w`` without sync) on the host.  The first
        ``skip`` work samples of the window lie before global sample 0
        (the first chunk's left halo) and do not exist offline: K2 runs
        from global sample 0 on, so its own ``dem[0] = 0`` and zero
        history are the offline graph's."""
        cuda = self.device.type == "cuda"
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            h0 = time.perf_counter()
        x = torch.from_numpy(ext).to(self.device)
        y = polyphase_resample(x, self._bank, self._p_c, self._s_c, self.m, self._ext_out)
        y, lo = y[skip:], self.l_ctx - skip
        filt, corr = demod_fir_corr(y, self._taps, self._tmpl, self._cosphi2, self._inv)
        w = self.w
        seg = torch.cat([filt[lo : lo + w], corr[lo : lo + w]]) if self.sync else filt[lo : lo + w]
        if cuda:
            t1.record()
        out = seg.cpu().numpy()
        self.chunk_ms.append(t0.elapsed_time(t1) if cuda else (time.perf_counter() - h0) * 1e3)
        return out

    def _run_chunk(self, pad_to: int | None = None) -> None:
        """Process chunk ``self._k``; ``pad_to`` zero-pads a final partial
        window (finish), as the offline resample reads 0 past the end."""
        k, ci, l_in, r_in = self._k, self.ci, self.l_in, self.r_in
        a = k * ci - l_in  # absolute window start (may be < 0)
        b = (k + 1) * ci + r_in
        ext = np.zeros(b - a, np.float32)
        lo = max(a, self._in_start)
        hi = min(b, self._n_in if pad_to is None else pad_to)
        if hi > lo:
            ext[lo - a : hi - a] = self._in_buf[lo - self._in_start : hi - self._in_start]
        if self.l == 1 and a <= 0:
            # causal_input's semantics: the reference's strict i > j guard
            # drops x[0], and nothing comes before it.
            ext[: 1 - a] = 0.0
        out = self._chunk(ext, max(0, self.l_ctx - k * self.w))
        f_seg, corr = out[: self.w], out[self.w :]
        if self._f_buf.size == 0:
            self._f_start = k * self.w
            self._f_buf = f_seg
        else:
            self._f_buf = np.concatenate([self._f_buf, f_seg])
        self._corr_buf = np.concatenate([self._corr_buf, corr])
        self._k += 1
        # Drop input this and all future chunks no longer need.
        keep_from = max(self._in_start, self._k * ci - l_in)
        self._in_buf = self._in_buf[keep_from - self._in_start :]
        self._in_start = keep_from

    def _feed_selector(self, n_valid_cap: int) -> None:
        """Hand the selector corr up to ``n_valid_cap`` (a lower bound of
        the offline n_valid that only grows, so it never overshoots)."""
        have = self._corr_fed + self._corr_buf.shape[0]
        take = min(have, n_valid_cap) - self._corr_fed
        if take > 0:
            t0 = time.perf_counter()
            self._greedy.feed(self._corr_buf[:take])
            self.fold_s += time.perf_counter() - t0
            self._corr_buf = self._corr_buf[take:]
            self._corr_fed += take

    def _emit_rows(self, work_true_bound: int, final: bool) -> np.ndarray:
        """Rows for final peaks (offline: ``sync_pos[:-1]`` where
        ``p + spr < work_true``).  ``work_true_bound`` is the current lower
        bound of work_true (exact when ``final``)."""
        spr, m_final = self.spr, self.m_final
        if self.sync:
            rows_pos = [p for p, _ in self._greedy.peaks[:-1] if p + spr < work_true_bound]
        else:
            n_rows = work_true_bound // spr if final else max(
                0, (work_true_bound - spr) // spr  # strict: wait for a full row
            )
            rows_pos = [r * spr for r in range(n_rows)]
        out = []
        for p in rows_pos[self._emitted :]:
            if p + spr > self._f_start + self._f_buf.shape[0]:
                break
            seg = self._f_buf[p - self._f_start : p - self._f_start + spr]
            out.append(seg[::m_final])
        if not out:
            return np.zeros((0, PX_PER_ROW), np.float32)
        rows = np.stack(out)
        if self._emitted == 0:
            rows[0, 0] = 0.0  # the NoFilter causal path's quirk (dsp.rs:105-123)
        self._emitted += len(out)
        # Trim f no later row will need.
        if self.sync:
            frontier = min((p for p, _ in self._greedy.peaks[self._emitted :]),
                           default=self._f_start + self._f_buf.shape[0])
        else:
            frontier = self._emitted * spr
        keep_from = max(self._f_start, frontier)
        self._f_buf = self._f_buf[keep_from - self._f_start :]
        self._f_start = keep_from
        return rows

    # -- API -------------------------------------------------------------
    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed PCM samples; returns the newly final rows [k, 2080] f32."""
        if self._finished:
            raise err.InternalError("push() after finish()")
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            self._in_buf = np.concatenate([self._in_buf, samples])
            self._n_in += samples.size
        while self._n_in >= (self._k + 1) * self.ci + self.r_in:
            self._run_chunk()
        bound = self._work_len(self._n_in)
        if self.sync:
            self._feed_selector(max(0, bound - self.guard))
        return self._emit_rows(bound, final=False)

    def finish(self) -> np.ndarray:
        """Flush: process the zero-padded tail, finalize the peaks, emit
        the remaining rows.  Afterwards ``sync_positions`` is set."""
        if self._finished:
            return np.zeros((0, PX_PER_ROW), np.float32)
        self._finished = True
        work_true = self._work_len(self._n_in)
        # Process the remaining chunks (zero-padded) until every work
        # sample in [0, work_true) exists.
        while self._k * self.w < work_true:
            self._run_chunk(pad_to=self._n_in)
        if self.sync:
            self._feed_selector(max(0, work_true - self.guard))
            self.sync_positions = self._greedy.positions()
        return self._emit_rows(work_true, final=True)

    @property
    def n_rows(self) -> int:
        return self._emitted
