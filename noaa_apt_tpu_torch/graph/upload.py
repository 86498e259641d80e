"""The decoder's upload of a mapped recording, staged through a pinned ring.

A WAV that ``io/wav.load_device_ready`` maps reaches the decoder as
channel 0 of an ``np.memmap`` over the file's data chunk.  Where
:func:`locate` finds such a view's bytes in its file, :func:`stage` reads
them, as they lie (every channel of each frame), into a ring of host slots
on a small pool of host threads, and copies each filled slot to the device
without blocking, into one byte buffer at its offset.  A slot is read into
again only once its last copy has completed (an event a slot), so the
reads of the next slots overlap the copy of this one.  The decoder then
views the buffer as ``[frames, channels]`` of the file's dtype and takes
channel 0 on the device.  The host makes no copy of the samples of its
own, and the copies to the card leave pinned memory.

The ring is made once per process and device, at the first staged upload
(the CLI makes a decoder a call), and the pool once per process.  On the
CPU the slots are plain tensors and each copy has ended when it returns,
so the same walk runs there.
"""

from __future__ import annotations

import mmap
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import err
from ..native import _threads as _workers
from ..spans import span

_SLOT_BYTES = 8 << 20
_TORCH_DTYPES = {np.dtype(np.int16): torch.int16, np.dtype(np.float32): torch.float32}

_rings: dict = {}
_pool: ThreadPoolExecutor | None = None
_pool_key: tuple[int, int] | None = None
_lock = threading.Lock()


@dataclass(frozen=True)
class MappedSamples:
    """Where ``n`` samples of ``dtype`` lie in the file ``path``: the first
    at byte ``offset``, each ``stride`` bytes (a frame) after the last."""

    path: str
    offset: int
    stride: int
    dtype: np.dtype
    n: int

    @property
    def span(self) -> int:
        """The bytes from the first sample's first byte to the last's last."""
        return (self.n - 1) * self.stride + self.dtype.itemsize

    @property
    def channels(self) -> int:
        return self.stride // self.dtype.itemsize


def locate(arr, n: int) -> MappedSamples | None:
    """Where the first ``n`` samples of ``arr`` lie in its file, or None:
    ``arr`` must be a 1-D int16 or float32 view of a shared ``np.memmap``
    whose stride is a whole number of samples, and every byte from its
    first sample to its ``n``-th must lie inside the map."""
    if (not isinstance(arr, np.memmap) or arr.ndim != 1 or arr.dtype not in _TORCH_DTYPES
            or getattr(arr, "_mmap", None) is None or arr.filename is None or arr.mode == "c"):
        return None
    n, stride = min(int(n), arr.shape[0]), arr.strides[0]
    if n < 1 or stride <= 0 or stride % arr.itemsize:
        return None
    try:
        base = np.frombuffer(arr._mmap, np.uint8)
    except (TypeError, ValueError):  # a closed map
        return None
    rel = arr.ctypes.data - base.ctypes.data
    # numpy maps from the allocation granule at or below the map's offset.
    start = arr.offset - arr.offset % mmap.ALLOCATIONGRANULARITY
    where = MappedSamples(os.fspath(arr.filename), start + rel, stride, arr.dtype, n)
    return where if rel >= 0 and rel + where.span <= base.shape[0] else None


class UploadRing:
    """``slots`` host buffers of ``slot_bytes`` (pinned for a CUDA device)
    and the event of each one's last copy to the device."""

    def __init__(self, device, slots: int, slot_bytes: int):
        cuda = torch.device(device).type == "cuda"
        self.slot_bytes = slot_bytes
        self.slots = [torch.empty(slot_bytes, dtype=torch.uint8, pin_memory=cuda) for _ in range(slots)]
        self.host = [memoryview(s.numpy()) for s in self.slots]
        self.copied = [torch.cuda.Event() if cuda else None for _ in range(slots)]
        self.lock = threading.Lock()  # one staged upload at a time

    def fill(self, k: int, fd: int, offset: int, size: int) -> None:
        """Slot ``k``'s first ``size`` bytes from the file at ``offset``,
        once the slot's last copy has completed (on a pool thread)."""
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        view, got = self.host[k][:size], 0
        while got < size:
            read = os.preadv(fd, [view[got:]], offset + got)
            if read == 0:
                raise err.InternalError(f"the mapped file ended at byte {offset + got}, inside its map")
            got += read

    def ship(self, k: int, out: torch.Tensor, a: int, b: int) -> None:
        """Slot ``k`` into ``out[a:b]``, not blocking, and its event."""
        out[a:b].copy_(self.slots[k][: b - a], non_blocking=True)
        if self.copied[k] is not None:
            self.copied[k].record(torch.cuda.current_stream(out.device))


def upload_ring(device) -> UploadRing:
    """The process's ring for ``device``: two slots a pool thread."""
    key = (os.getpid(), str(torch.device(device)))
    with _lock:
        ring = _rings.get(key)
        if ring is None:
            ring = _rings[key] = UploadRing(device, 2 * _workers(), _SLOT_BYTES)
        return ring


def _executor() -> ThreadPoolExecutor:
    """The shared read pool, made at the first staged upload and again in
    a forked child or where the worker count changed."""
    global _pool, _pool_key
    key = (os.getpid(), _workers())
    with _lock:
        if _pool is None or _pool_key != key:
            _pool = ThreadPoolExecutor(key[1], thread_name_prefix="apt-upload")
            _pool_key = key
        return _pool


def stage(where: MappedSamples, device) -> tuple[torch.Tensor, int] | None:
    """``where``'s frames on ``device``: -> (``[n, channels]`` of its dtype,
    whose column 0 holds the samples, the slots filled), or None where the
    file cannot be opened again.  The bytes past the last sample's are not
    read.  The span ``apt.upload.copy`` runs from the first read to the
    last, ``apt.upload.h2d`` is the wait for the last copy."""
    ring = upload_ring(device)
    out = torch.empty(where.n * where.stride, dtype=torch.uint8, device=device)
    size, slots = where.span, len(ring.slots)
    cuts = [(a, min(a + ring.slot_bytes, size)) for a in range(0, size, ring.slot_bytes)]
    pool = _executor()
    try:
        fd = os.open(where.path, os.O_RDONLY)
    except OSError:
        return None
    with ring.lock:
        reads: deque = deque()

        def ship_oldest() -> None:
            fut, k, a, b = reads.popleft()
            fut.result()
            ring.ship(k, out, a, b)

        try:
            with span("apt.upload.copy"):
                for i, (a, b) in enumerate(cuts):
                    if len(reads) == slots:  # every slot is being read: ship the oldest
                        ship_oldest()
                    k = i % slots
                    reads.append((pool.submit(ring.fill, k, fd, where.offset + a, b - a), k, a, b))
                while reads:
                    ship_oldest()
            with span("apt.upload.h2d"):
                last = ring.copied[(len(cuts) - 1) % slots]
                if last is not None:
                    last.synchronize()
        finally:
            for fut, *_ in reads:  # after a failed read: no read may outlive the call
                fut.exception()
            os.close(fd)
    return out.view(_TORCH_DTYPES[where.dtype]).view(where.n, where.channels), len(cuts)
