"""Multi-device decode: sequence sharding with a ring halo exchange, and
data-parallel batches.

Behavioral contract: ``noaa_apt_tpu/parallel/shard.py``.

- **Sequence parallelism** (:class:`ShardedDecoder`): the recording's
  time axis is split into one chunk a device along the mesh's "seq"
  axis.  Each device takes the boundary tails of its ring neighbours'
  chunks (zeros at the recording's edges), and runs kernel K1 (resample)
  and kernel K2 (demod, FIR, correlation) over its haloed window
  (``graph/window.py``).  The filtered signal and the correlation are
  gathered to the mesh's first device, where kernel K3 selects the sync
  peaks and the rows are gathered, as in the one-device decode.
- **Data parallelism** (:func:`batch_decode`): a batch of recordings is
  spread over the "data" axis, one recording a device in turn.

Exactness: chunks start on whole polyphase periods
(``graph/window.chunk_alignment``), and K1 and K2 sum each output's terms
in one fixed order wherever it sits, so every device computes its
samples bit for bit as the one-device launch does: the sharded decode
equals ``Decoder.decode`` exactly (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import err
from ..core.frequency import Rate
from ..core.profiles import DecodeProfile
from ..device import resolve_device
from ..graph.decode import _TOO_SHORT, DecodeResult, DecodeTables, Decoder, _StageClock, pad_bucket
from ..graph.window import HaloGeometry, WindowTables, ceil_to, chunk_alignment, window_resample, window_stage
from .dist import GlobalBatch, Mesh


@dataclass(frozen=True)
class ShardPlan:
    """The sharded geometry of one (length bucket, input rate):
    ``n_pad = d * ci`` input samples, chunk ``k`` of ``ci`` on device
    ``k``, and the window around it (``geom``)."""

    tables: DecodeTables
    geom: HaloGeometry
    n_pad: int

    def work_len(self, n_true: int) -> int:
        return self.tables.work_len(n_true)


class ShardedDecoder(Decoder):
    """Decode one long recording across the devices of ``mesh``'s
    ``axis`` (time-sharded).

    A drop-in for :class:`Decoder`: :meth:`decode` (sync on and off) and
    :meth:`decode_render_input` (every fused render, ``fetch=False``)
    take the sharded front (upload, halo exchange, K1 and K2 per device,
    gather), then the one-device tail.  The other entry points (the
    batched renders, host ingest) run on the first device, as in the JAX
    package.  The decoder's ``device`` is the mesh's first device along
    ``axis``, where the results lie."""

    def __init__(self, profile: DecodeProfile, mesh: Mesh, axis: str = "seq"):
        devices = mesh.local_axis_devices(axis)
        if len(devices) != mesh.shape[axis]:
            raise ValueError(f"the {axis!r} axis leaves this process: it owns {len(devices)} of its "
                             f"{mesh.shape[axis]} devices")
        super().__init__(profile, device=devices[0])
        self.mesh = mesh
        self.axis = axis
        self.devices = [resolve_device(d) for d in devices]
        self.n_dev = len(self.devices)
        # K1 and K2 are bit-stable under any period-aligned chunking
        # (graph/window.chunk_alignment): always True here.
        self.chunk_bit_exact = True
        self._plans: dict = {}
        self._window_tables: dict = {}

    # -- geometry ------------------------------------------------------
    def plan(self, n_true: int, input_rate: Rate) -> ShardPlan:
        """The geometry of an ``n_true``-sample recording, keyed on its
        length bucket (``pad_bucket``) as the JAX package's is
        (``noaa_apt_tpu/parallel/shard.py:70-86``): the per-device work
        chunk ``w``, a whole number of polyphase periods, and the input
        chunk ``ci = w*m/l``; the +align margin keeps ``n_pad = d*ci >=
        n_true`` after rounding.  Raises ``InternalError`` when a halo is
        wider than a chunk."""
        key = (pad_bucket(int(n_true)), input_rate.get_hz())
        plan = self._plans.get(key)
        if plan is None:
            t = self._device_tables(input_rate).tables
            align, d = chunk_alignment(t.l), self.n_dev
            out_needed = pad_bucket(max(1, -(-key[0] * t.l // t.m)) + align)
            geom = HaloGeometry.design(t, ceil_to(ceil_to(out_needed, d) // d, align))
            halo = max(geom.l_in, geom.r_in)
            if halo > geom.ci:
                raise err.InternalError(
                    f"Chunk too small for halo exchange: Ci={geom.ci}, halo={halo}; "
                    "use fewer devices or a longer recording"
                )
            plan = self._plans[key] = ShardPlan(t, geom, d * geom.ci)
        return plan

    def _tables_on(self, input_rate: Rate, device: torch.device) -> WindowTables:
        key = (input_rate.get_hz(), device)
        if key not in self._window_tables:
            self._window_tables[key] = WindowTables.upload(self._device_tables(input_rate).tables, device)
        return self._window_tables[key]

    def _clock(self) -> _StageClock:
        return _StageClock(self.device, others=self.devices)

    # -- the sharded front -----------------------------------------------
    def _upload_windows(self, signal, n_true: int, plan: ShardPlan) -> list:
        """Device ``k``'s window buffer, ``l_in + ci + r_in`` samples, with
        chunk ``k`` of the zero-padded recording copied into its middle
        (its halos are filled by :meth:`_halo_exchange`).  16-bit PCM stays
        int16, anything else goes as f32; a tensor already on a device must
        be ``n_pad`` long."""
        g = plan.geom
        ci, lo = g.ci, g.l_in
        if isinstance(signal, torch.Tensor):
            if int(signal.shape[0]) != plan.n_pad:
                raise err.InternalError(f"pre-uploaded input is {int(signal.shape[0])}, expected {plan.n_pad}")
            x = signal if signal.dtype == torch.int16 else signal.to(torch.float32)
            parts = [x[k * ci : (k + 1) * ci] for k in range(self.n_dev)]
        else:
            arr = np.asarray(signal)[:n_true]
            if arr.dtype != np.int16:
                arr = arr.astype(np.float32)
            # A read-only memmap is copied out a chunk at a time.
            parts = [torch.from_numpy(p if p.flags.writeable else np.array(p))
                     for p in (arr[k * ci : (k + 1) * ci] for k in range(self.n_dev))]
        windows = []
        for part, dev in zip(parts, self.devices):
            ext = torch.empty(lo + ci + g.r_in, dtype=parts[0].dtype, device=dev)
            n = part.shape[0]
            ext[lo : lo + n].copy_(part)
            ext[lo + n : lo + ci].zero_()
            windows.append(ext)
        if not isinstance(signal, torch.Tensor):
            self.last_upload = {"bytes": sum(p.numel() * p.element_size() for p in parts)}
        return windows

    def _halo_exchange(self, windows: list, g: HaloGeometry) -> None:
        """The ring halo exchange, in place: device ``k``'s window takes the
        last ``l_in`` samples of its left neighbour's chunk and the first
        ``r_in`` of its right neighbour's (between cards, a peer copy);
        zeros past the recording's edges, and the l == 1 edge rule on the
        first device."""
        lo, ci = g.l_in, g.ci
        for k, ext in enumerate(windows):
            if k > 0:
                ext[:lo].copy_(windows[k - 1][ci : ci + lo])
            else:
                ext[:lo].zero_()
            if k < len(windows) - 1:
                ext[lo + ci :].copy_(windows[k + 1][lo : lo + g.r_in])
            else:
                ext[lo + ci :].zero_()
            g.zero_before_start(ext, g.window(k)[0])

    def _front(self, signal, n_true: int, input_rate: Rate, clock: _StageClock, context=None):
        """The sharded stage 1 -> ``(filt, corr, work_true)`` on the first
        device, both the one-device decode's floats bit for bit.  Stages:
        upload, halo, resample (K1 per device), demod_fir_corr (K2 per
        device), gather."""
        n_true = int(n_true)
        plan = self.plan(n_true, input_rate)
        geom = plan.geom
        work_true = plan.work_len(n_true)
        if context is not None:
            context.status(0.1, f"Resampling to {self.work_rate.get_hz()} ({self.n_dev}-chip)")
        if work_true < 10 * self.samples_per_work_row:
            raise err.InternalError(_TOO_SHORT)
        if plan.n_pad < n_true or self.n_dev * geom.w < work_true:
            raise err.InternalError("Sharded geometry smaller than recording")
        windows = self._upload_windows(signal, n_true, plan)
        clock.mark("upload")
        self._halo_exchange(windows, geom)
        clock.mark("halo")
        tabs = [self._tables_on(input_rate, dev) for dev in self.devices]
        ys = [window_resample(ext, geom, tb) for ext, tb in zip(windows, tabs)]
        clock.mark("resample")
        segs = [window_stage(y, geom, k, tb) for k, (y, tb) in enumerate(zip(ys, tabs))]
        clock.mark("demod_fir_corr")
        # The all-gather that XLA inserts for the JAX package's tail.
        filt = torch.cat([f.to(self.device) for f, _ in segs])[:work_true]
        corr = torch.cat([c.to(self.device) for _, c in segs])[:work_true]
        clock.mark("gather")
        return filt, corr, work_true

    def decode(self, signal, input_rate: Rate, sync: bool = True, context=None,
               host_work=None) -> DecodeResult:
        """:meth:`Decoder.decode` with the sharded front.  ``host_work`` is
        refused: host ingest resamples to the work rate, and this decoder
        shards the input domain."""
        if host_work is not None:
            raise err.InternalError(
                "host_work is not supported by the sequence-sharded decoder; "
                "use ingest='device' (the default) with --distributed"
            )
        return super().decode(signal, input_rate, sync, context)


def batch_decode(
    decoder: Decoder,
    signals,
    input_rate: Rate,
    mesh: Mesh,
    axis: str = "data",
    sync: bool = True,
    n_true: int | None = None,
) -> list[DecodeResult]:
    """Data-parallel decode of equal-length recordings (``signals``:
    ``[B, N]``, or a :func:`~.dist.global_batch` spanning processes):
    member ``i`` runs K1 and K2 on the ``axis`` device ``i % n``, then K3
    and its rows there; ``n_true`` samples of each (default ``N``).  Each
    result equals ``decoder.decode`` of its recording.

    On a global batch each process decodes its own rows, then the fetched
    results (sync list, row count, f32 image) are exchanged, and every
    process returns the whole batch's results in rank order, their images
    on ``decoder``'s device."""
    gb = signals if isinstance(signals, GlobalBatch) else None
    rows = list(gb.local if gb is not None else signals)
    n_true = int(rows[0].shape[0]) if n_true is None else int(n_true)
    devices = mesh.local_axis_devices(axis)
    results, error = [], None
    try:
        members = [decoder.on_device(devices[i % len(devices)]) for i in range(len(rows))]
        clocks = [dec._clock() for dec in members]
        fronts = [dec._front(x, n_true, input_rate, c) for dec, x, c in zip(members, rows, clocks)]
        results = [dec._rows(*front, sync, c) for dec, front, c in zip(members, fronts, clocks)]
    except err.AptError as e:
        if gb is None:
            raise
        error = e  # every process must still reach the exchange below
    if gb is None:
        return results
    mine = error if error is not None else [(r.sync_positions, r.n_rows, r.image_np()) for r in results]
    everyone = [None] * gb.process_count
    dist.all_gather_object(everyone, mine)
    for part in everyone:
        if isinstance(part, BaseException):
            raise part
    return [DecodeResult(torch.from_numpy(img).to(decoder.device), n_rows, sync_pos)
            for part in everyone for sync_pos, n_rows, img in part]
