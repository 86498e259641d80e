"""Fleet serving: many WAVs -> PNGs through a load / device / encode pipeline.

Behavioral contract: ``noaa_apt_tpu/serve.py`` (``PassResult`` ``:46``,
``FleetReport`` ``:62``, ``decode_fleet`` ``:103``).  Loader threads parse
WAVs, run the host ingest (:meth:`Decoder.prepare_work`) or pad the raw
recording, and copy the result to the card; the calling thread dispatches
every decode through one :class:`Decoder` (its tables are built once per
input rate); encoder threads fetch the u8 rows, finish the image and
write the PNG.  Failures are isolated per pass, and per group of batched
payloads.

The JAX package's link gate (``io/link.upload``, ``serve.py:260``) becomes
the port's own upload (:class:`_LoaderUpload`): each loader writes the
padded recording or payload into a pinned host buffer it owns, copies it
to the card on a side CUDA stream, and records an event there.  The
device thread makes its compute stream wait for that event before the
pass's first kernel.
On the CPU the upload is a plain tensor.

The decoder's ``last_ingest_s``, ``last_upload``, ``host8_fallbacks`` and
``last_stage_ms`` are written from several threads here; the fleet reads
none of them and times its stages with its own spans (:mod:`spans`).  The
calling thread's spans (``apt.fleet.wait_loader``, ``apt.fleet.dispatch``,
``apt.fleet.wait_encoder``, ``apt.fleet.drain``) show in any profiler
started on that thread; the loaders' (``apt.fleet.load``,
``apt.fleet.ingest``, ``apt.fleet.wait_pinned``, ``apt.fleet.stage``) and
the encoders' (``apt.fleet.fetch``, ``apt.fleet.encode``, ``apt.wait.rows``,
``apt.png.*``) only in one that records every thread (``cli
--profile-trace``).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from . import err
from .core.profiles import STANDARD, DecodeProfile
from .device import resolve_device
from .graph.decode import (HOST_INGEST, Decoder, PackedWorkPayload, PendingRender,
                           PendingRenderTelemetry, pad_bucket)
from .graph.process import device_levels, finish_image, process
from .io import png, wav
from .spans import span
from .types import Contrast, ContrastKind, Rotate

log = logging.getLogger(__name__)

# Hold a partial group of host payloads at most this long for batchmates
# (``noaa_apt_tpu/serve.py:331``).
GROUP_MAX_AGE_S = 1.0
_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


@dataclass
class PassResult:
    input_path: Path
    output_path: Optional[Path]
    n_rows: int = 0
    seconds: float = 0.0
    error: Optional[str] = None
    # Per-stage wall seconds (stages overlap across passes, so their
    # sum exceeds fleet wall time on purpose).
    load_s: float = 0.0
    ingest_s: float = 0.0  # host ingest and the upload, or the raw pad and upload
    device_s: float = 0.0  # dispatch (the deferred renders wait once, for K3's result)
    fetch_s: float = 0.0  # blocked in .get() waiting for the device result
    encode_s: float = 0.0


@dataclass
class FleetReport:
    """What :func:`decode_fleet` did.

    ``compile_variants``: the port runs eagerly and compiles no graph
    variants; this is the number of device table sets its decoder built
    (``len(Decoder._tables)``, one per input rate that K1 resampled).

    ``link``: the loaders' uploads, under the JAX package's key names:
    ``uploaded_MB`` (bytes copied to the device), ``up_wall_s`` (the
    copies' own time, summed from CUDA events on the side streams) and
    ``eff_up_MBps`` (the two divided; None under a millisecond).  On the
    CPU nothing crosses a link: ``uploaded_MB`` counts the bytes handed to
    the device thread, and the other two are None.  Uploads
    the device thread makes itself (an l == 1 rate under a host ingest,
    ``sync=False`` with device ingest) are not counted.

    ``waits``: the calling (device) thread's seconds blocked, summed from
    its spans: ``loader`` (no loaded pass ready), ``encoder`` (the encode
    queue full) and ``drain`` (from the last dispatch to the threads'
    join).  The stage that the device thread waits on most sets the pace."""

    results: list[PassResult] = field(default_factory=list)
    wall_seconds: float = 0.0
    compile_variants: int = 0
    link: dict = field(default_factory=dict)
    waits: dict = field(default_factory=dict)

    @property
    def ok(self) -> list[PassResult]:
        return [r for r in self.results if r.error is None]

    @property
    def failed(self) -> list[PassResult]:
        return [r for r in self.results if r.error is not None]

    @property
    def decoded_seconds(self) -> float:
        # APT is 2 lines per second.
        return sum(r.n_rows for r in self.ok) / 2.0

    @property
    def realtime_factor(self) -> float:
        return self.decoded_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def stage_totals(self) -> dict:
        """Summed per-stage seconds across passes (pipeline stages run
        concurrently, so totals can exceed wall time; the max stage is
        the pipeline's bottleneck)."""
        out = {"load": 0.0, "ingest": 0.0, "device": 0.0, "fetch": 0.0, "encode": 0.0}
        for r in self.results:
            out["load"] += r.load_s
            out["ingest"] += r.ingest_s
            out["device"] += r.device_s
            out["fetch"] += r.fetch_s
            out["encode"] += r.encode_s
        return {k: round(v, 3) for k, v in out.items()}


class _Uploads:
    """Accounting of every loader's uploads, and the compute stream that
    each uploaded tensor is recorded on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.compute = torch.cuda.current_stream(device) if self.cuda else None
        self._lock = threading.Lock()
        self._bytes = 0
        self._events: list = []  # (start, end) CUDA events of each copy

    def add(self, n_bytes: int, events=None) -> None:
        with self._lock:
            self._bytes += n_bytes
            if events is not None:
                self._events.append(events)

    def stats(self) -> dict:
        with self._lock:
            events, n_bytes = list(self._events), self._bytes
        out = {"uploaded_MB": round(n_bytes / 1e6, 1), "up_wall_s": None, "eff_up_MBps": None}
        if self.cuda:
            for _, end in events:
                end.synchronize()
            wall = sum(start.elapsed_time(end) for start, end in events) / 1e3
            out["up_wall_s"] = round(wall, 3)
            out["eff_up_MBps"] = round(n_bytes / wall / 1e6, 1) if wall > 1e-3 else None
        return out


class _LoaderUpload:
    """One loader thread's host -> device copy: the array goes into a
    pinned host buffer owned by this loader, then to the device on this
    loader's side stream; ``take()`` hands over the event the device
    thread must wait for.  The pinned buffer is rewritten only after its
    last copy has completed.  On the CPU the copy is a plain tensor."""

    def __init__(self, uploads: _Uploads):
        self.uploads = uploads
        self.stream = torch.cuda.Stream(uploads.device) if uploads.cuda else None
        self.pinned: Optional[torch.Tensor] = None
        self.free = None  # event: the last copy out of ``pinned`` has completed
        self.ready = None  # event of the last upload, not yet handed over

    def __call__(self, arr: np.ndarray, pad_to: int | None = None) -> torch.Tensor:
        """``arr`` (1-D) on the device, zero-padded to ``pad_to`` samples;
        the padding is written straight into the pinned buffer."""
        size = len(arr) if pad_to is None else pad_to
        if not self.uploads.cuda:
            with span("apt.fleet.stage"):
                host = np.zeros(size, arr.dtype)
                host[: len(arr)] = arr
            self.uploads.add(host.nbytes)
            return torch.from_numpy(host)
        dtype = _TORCH_DTYPES[arr.dtype]
        n = size * arr.itemsize
        if self.free is not None:
            with span("apt.fleet.wait_pinned"):
                self.free.synchronize()
        if self.pinned is None or self.pinned.numel() < n:
            self.pinned = torch.empty(max(n, 1), dtype=torch.uint8, pin_memory=True)
        host = self.pinned[:n].view(dtype)
        staged = host.numpy()
        with span("apt.fleet.stage"):
            staged[: len(arr)] = arr
            staged[len(arr):] = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            out = torch.empty(size, dtype=dtype, device=self.uploads.device)
            start.record()
            out.copy_(host, non_blocking=True)
            end.record()
        # The tensor is allocated on the side stream and used on the compute stream.
        out.record_stream(self.uploads.compute)
        self.free = self.ready = end
        self.uploads.add(n, events=(start, end))
        return out

    def take(self):
        """The event of the upload made since the last ``take()``, or None."""
        ready, self.ready = self.ready, None
        return ready


def decode_fleet(
    inputs: Iterable,
    out_dir,
    profile: DecodeProfile = STANDARD,
    contrast: Contrast = None,
    rotate: Rotate = Rotate.NO,
    color=None,
    orbit=None,
    orbit_for=None,
    sync: bool = True,
    ingest: str = "host",
    loaders: int | None = None,
    encoders: int | None = None,
    png_compress_level: int = 1,
    gray_png: str = "auto",
    fleet_batch: int = 8,
    device=None,
) -> FleetReport:
    """Decode many WAVs to PNGs with a load/compute/encode pipeline
    (``noaa_apt_tpu/serve.py:103-524``).

    ``loaders`` host threads parse WAVs, run the host ingest
    (``ingest="host"``, ``"host16"``, ``"host16c"``, ``"host8"``: see
    :meth:`Decoder.prepare_work`) or pad the raw recording
    (``"device"``), and upload the buffer, overlapped with the device
    work on earlier passes; ``encoders`` threads fetch, post-process and
    write the PNGs.  Thread counts default to the host's core count.
    Device work stays on the calling thread, on its current stream.

    ``png_compress_level``: zlib level of the output PNGs.

    ``gray_png``: "auto" writes single-channel PNGs when the output
    carries no colour (no false colour, no map overlay, no rotation,
    non-histogram contrast): the same pixels as the RGBA file's R, G and B
    channels.  "never" keeps RGBA files byte-equal to the single-file CLI's.

    ``orbit_for``: optional callable ``Path -> OrbitSettings | None``
    evaluated per recording; overrides the static ``orbit``.

    ``fleet_batch``: group up to this many consecutive same-bucket host
    payloads into one :meth:`Decoder.decode_render_batch` (K3 once over
    the group) and one grouped fetch; 1 dispatches every pass alone.  Raw
    device-ingest passes are dispatched one by one, as in the JAX package.

    ``device``: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``."""
    if gray_png not in ("auto", "never"):
        raise err.InvalidInputError(f"gray_png must be 'auto' or 'never', got {gray_png!r}")
    dev = resolve_device(device)
    ncores = os.cpu_count() or 2
    if loaders is None:
        loaders = max(2, min(4, ncores + 1))
    loaders = max(1, loaders)  # 0 loader threads would deadlock loaded.get()
    if encoders is None:
        encoders = max(1, min(2, ncores))
    contrast = contrast or Contrast.from_percent(0.98)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = [Path(p) for p in inputs]
    # Output names: the input stem, disambiguated when two inputs from
    # different directories share one.
    seen: dict[str, int] = {}
    out_names: list[str] = []
    for p in paths:
        k = seen.get(p.stem, 0)
        seen[p.stem] = k + 1
        out_names.append(p.stem if k == 0 else f"{p.stem}_{k}")
    fused_levels = device_levels(contrast, color) if sync else None

    if ingest == "host16c" and fused_levels is None:
        # The packed codec decodes only on the fused renders; the unfused
        # path takes the byte-identical plain host16 payload.
        ingest = "host16"
    dec = Decoder(profile, device=dev, ingest=ingest)

    gray_ok = (
        gray_png == "auto"
        and color is None
        and rotate == Rotate.NO
        and contrast.kind != ContrastKind.HISTOGRAM
    )

    loaded: "queue.Queue" = queue.Queue(maxsize=max(2, loaders))
    to_encode: "queue.Queue" = queue.Queue(maxsize=4)
    report = FleetReport(waits={"loader": 0.0, "encoder": 0.0, "drain": 0.0})
    uploads = _Uploads(dev)
    compute = uploads.compute  # None on the CPU: torch.cuda.stream(None) does nothing
    t_start = time.perf_counter()

    path_iter = iter(enumerate(paths))
    iter_lock = threading.Lock()

    def loader(up: _LoaderUpload):
        while True:
            with iter_lock:
                try:
                    i, p = next(path_iter)
                except StopIteration:
                    return
            try:
                with span("apt.fleet.load") as load:
                    signal, rate = wav.load_device_ready(p)
                with span("apt.fleet.ingest") as ingested:
                    if ingest in HOST_INGEST:
                        work = dec.prepare_work(signal, rate, to_device=True, upload=up)
                    elif fused_levels is not None:
                        # Device ingest: upload the raw recording, padded to its bucket.
                        work = ("raw", up(signal, pad_to=pad_bucket(len(signal))), len(signal))
                    else:
                        work = None
                    ready = up.take()
                loaded.put((i, p, signal, rate, work, ready, None, load.seconds, ingested.seconds))
            except Exception as e:  # noqa: BLE001 - per-pass isolation
                up.take()
                loaded.put((i, p, None, None, None, None, str(e), 0.0, 0.0))

    def write_img(res_item, img, out_name):
        out = out_dir / (out_name + ".png")
        png.write_png(out, img, level=png_compress_level)
        res_item.output_path = out

    def encoded(res_item, encode: span):
        res_item.encode_s = encode.seconds
        res_item.seconds += res_item.fetch_s + res_item.encode_s

    def encode_gray(res_item, p, out_name, gray):
        with span("apt.fleet.encode") as encode:
            orb = orbit_for(p) if orbit_for is not None else orbit
            res_item.n_rows = gray.shape[0]
            if gray_ok and orb is None:
                img = gray  # single-channel PNG: the same pixels, a quarter of the bytes
            else:
                img = finish_image(gray, contrast.kind, rotate, color, orb)
            write_img(res_item, img, out_name)
        encoded(res_item, encode)

    def encode_item(item):
        if item[0] == "group":
            # One grouped fetch serves the whole batch; a member's guard
            # failure is its own error entry.
            _, metas, pending_batch = item
            try:
                with span("apt.fleet.fetch") as fetch:
                    results = pending_batch.get()
            except Exception as e:  # noqa: BLE001 - whole-group failure
                for res_item, _p, _n in metas:
                    res_item.error = str(e)
                return
            fetch_each = fetch.seconds / max(1, len(metas))
            for (res_item, p, out_name), r in zip(metas, results):
                res_item.fetch_s = fetch_each
                try:
                    if isinstance(r, Exception):
                        res_item.error = str(r)
                        continue
                    gray, _sync_pos = r
                    encode_gray(res_item, p, out_name, gray)
                except Exception as e:  # noqa: BLE001
                    res_item.error = str(e)
            return
        res_item, p, out_name, raw = item
        try:
            if isinstance(raw, (PendingRender, PendingRenderTelemetry)):
                with span("apt.fleet.fetch") as fetch:
                    gray, _sync_pos = raw.get()
                res_item.fetch_s = fetch.seconds
                encode_gray(res_item, p, out_name, gray)
            else:
                with span("apt.fleet.encode") as encode:
                    orb = orbit_for(p) if orbit_for is not None else orbit
                    img = process(raw, contrast, rotate, color, orb)
                    if gray_ok and orb is None and img.ndim == 3:
                        img = np.ascontiguousarray(img[..., 0])  # the unfused path's channels are gray
                    write_img(res_item, img, out_name)
                encoded(res_item, encode)
        except Exception as e:  # noqa: BLE001
            res_item.error = str(e)

    def encoder():
        # Fetches and the telemetry maps run on the device thread's stream.
        with torch.cuda.stream(compute):
            while True:
                item = to_encode.get()
                if item is None:
                    return
                encode_item(item)

    def wait_for(ready) -> None:
        """Make the compute stream wait for a loader's copy."""
        if ready is not None:
            compute.wait_event(ready)

    # The device thread's two queue waits: a non-blocking attempt first, so
    # that a span covers only time spent blocked.
    def next_loaded(timeout=None):
        """The next loaded pass (``queue.Empty`` after ``timeout``)."""
        try:
            return loaded.get_nowait()
        except queue.Empty:
            pass
        wait = span("apt.fleet.wait_loader")
        try:
            with wait:
                return loaded.get(timeout=timeout)
        finally:
            report.waits["loader"] += wait.seconds

    def to_encoders(item) -> None:
        try:
            to_encode.put_nowait(item)
            return
        except queue.Full:
            pass
        with span("apt.fleet.wait_encoder") as wait:
            to_encode.put(item)
        report.waits["encoder"] += wait.seconds

    # Each loader's pinned buffer and side stream, made here so that a
    # failure raises from this call, not inside a thread.
    loader_uploads = [_LoaderUpload(uploads) for _ in range(loaders)]
    loader_threads = [threading.Thread(target=loader, args=(up,), daemon=True) for up in loader_uploads]
    for t in loader_threads:
        t.start()
    enc_threads = [threading.Thread(target=encoder, daemon=True) for _ in range(max(1, encoders))]
    for t in enc_threads:
        t.start()

    results_by_idx: dict[int, PassResult] = {}
    # Grouped dispatch of host payloads: [(res_item, path, out_name, payload, ready)].
    group: list = []
    group_key = None
    group_t0 = 0.0  # arrival time of the group's oldest member

    def flush_group():
        nonlocal group, group_key
        if not group:
            return
        try:
            with span("apt.fleet.dispatch") as dispatch:
                for g in group:
                    wait_for(g[4])
                pend_b = dec.decode_render_batch([g[3] for g in group], *fused_levels, fetch=False)
            each = dispatch.seconds / len(group)
            for g in group:
                g[0].device_s = each
                g[0].seconds = each
            to_encoders(("group", [(g[0], g[1], g[2]) for g in group], pend_b))
        except Exception as e:  # noqa: BLE001 - group-level isolation
            for g in group:
                g[0].error = str(e)
            log.warning("grouped decode dispatch failed: %s", e)
        group, group_key = [], None

    try:
        pending = len(paths)
        while pending:
            # Flush-on-idle: with half a batch in hand (or a group older
            # than GROUP_MAX_AGE_S) and no freshly loaded pass, dispatch.
            if group:
                try:
                    item = next_loaded(timeout=0.05)
                except queue.Empty:
                    if (
                        len(group) * 2 >= fleet_batch
                        or time.perf_counter() - group_t0 > GROUP_MAX_AGE_S
                    ):
                        flush_group()
                    continue
            else:
                item = next_loaded()
            i, p, signal, rate, work, ready, load_err, load_s, ingest_s = item
            pending -= 1
            res_item = PassResult(input_path=p, output_path=None)
            res_item.load_s = load_s
            res_item.ingest_s = ingest_s
            results_by_idx[i] = res_item
            if load_err is not None:
                res_item.error = load_err
                continue
            if (
                fused_levels is not None
                and work is not None
                and not isinstance(work, tuple)
                and fleet_batch > 1
            ):
                # dtype in the key: host8 may ship an i16 payload for a
                # noisy pass; packed payloads group by their own geometry.
                if isinstance(work, PackedWorkPayload):
                    key = ("packed", work.nb, work.w_lo, work.n_esc_pad)
                else:
                    key = (
                        pad_bucket(work.work_true),
                        work.inv_scale is not None,
                        str(work.data.dtype),
                    )
                if group and key != group_key:
                    flush_group()
                if not group:
                    group_t0 = time.perf_counter()
                group.append((res_item, p, out_names[i], work, ready))
                group_key = key
                if len(group) >= fleet_batch or pending == 0:
                    flush_group()
                continue
            flush_group()
            try:
                with span("apt.fleet.dispatch") as dispatch:
                    wait_for(ready)
                    if work is not None and fused_levels is not None:
                        if isinstance(work, tuple):
                            out = dec.decode_render_input(
                                work[1], work[2], rate, *fused_levels, fetch=False
                            )
                        else:
                            out = dec.decode_render(work, *fused_levels, fetch=False)
                    else:
                        out = dec.decode(signal, rate, sync=sync, host_work=work)
                        res_item.n_rows = out.n_rows
                res_item.device_s = dispatch.seconds  # a deferred render's: its dispatch
                res_item.seconds = res_item.device_s
                to_encoders((res_item, p, out_names[i], out))
            except Exception as e:  # noqa: BLE001 - per-pass isolation
                res_item.error = str(e)
                log.warning("decode failed for %s: %s", p, e)
    finally:
        flush_group()
        with span("apt.fleet.drain") as drain:
            for _ in enc_threads:
                to_encode.put(None)
            for t in enc_threads:
                t.join()
            # If the device loop died early, blocked loaders must be drained
            # or their join deadlocks on the full queue.
            while any(t.is_alive() for t in loader_threads):
                try:
                    loaded.get_nowait()
                except queue.Empty:
                    time.sleep(0.01)
            for t in loader_threads:
                t.join()
        report.waits["drain"] = drain.seconds

    # An encoder death must not report passes as ok with no output.
    for r in results_by_idx.values():
        if r.error is None and r.output_path is None:
            r.error = "encoder did not produce output"

    report.results = [results_by_idx[i] for i in sorted(results_by_idx)]
    report.wall_seconds = time.perf_counter() - t_start
    report.compile_variants = len(dec._tables)
    report.link = uploads.stats()
    log.info(
        "fleet: %d ok, %d failed, %.1f s wall, %.0fx realtime, %d table sets",
        len(report.ok), len(report.failed), report.wall_seconds,
        report.realtime_factor, report.compile_variants,
    )
    return report
