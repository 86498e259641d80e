"""Multi-process execution: runtime init, device meshes, fleet work
assignment.

Behavioral contract: ``noaa_apt_tpu/parallel/dist.py``, on
``torch.distributed`` in place of ``jax.distributed``:

- **Axis placement.** A :class:`Mesh` is a ``("data", "seq")`` grid of
  devices.  The batch ("data") axis, whose passes are independent, spans
  processes; the sequence ("seq") axis, whose halo exchange and gather
  want the fastest link, stays within one process's cards.
  :func:`topology_mesh` builds that layout.
- **Fleet mode needs no collective.**  Recordings are independent, so
  :func:`fleet_shard` partitions the input list by process, and each
  process decodes its share on its own cards: the process group carries
  only the start-up handshake, never signal data.
- **One logical batch may span processes** (:func:`global_batch`, then
  ``parallel.batch_decode``): each process decodes its own rows, and the
  fetched results (sync lists, row counts, f32 images) are exchanged
  with ``all_gather_object``.

**Why the gloo backend, not NCCL.**  No signal data crosses processes:
the fleet needs only coordination, and the global batch exchanges only
fetched host results.  Gloo runs those on the CPU, and it lets two
processes share one card, which NCCL refuses ("duplicate GPU").  So the
real multi-process path runs on a one-card machine too.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

log = logging.getLogger(__name__)


def _distributed_initialized() -> bool:
    """Whether the default process group is up, asked of the runtime."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's index, ``jax.process_index()``'s counterpart (0
    without a process group)."""
    return dist.get_rank() if _distributed_initialized() else 0


def world_size() -> int:
    """The number of processes, ``jax.process_count()``'s counterpart (1
    without a process group)."""
    return dist.get_world_size() if _distributed_initialized() else 1


def _env_int(*names: str) -> int | None:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Start the process group (idempotent); returns whether more than one
    process takes part.

    Arguments left out come from the environment: the JAX package's
    variables first (``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so one launch script drives
    either package, then torchrun's (``MASTER_ADDR`` and ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  With no coordinator and no process count, a
    plain one-process run stays as it is and returns False.

    A process group that is already up (a launcher started it) is kept,
    found from the runtime's own state.  Any other failure propagates: a
    one-process view would hand every process the whole fleet
    (:func:`fleet_shard`), and N processes would decode and overwrite it N
    times."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS") or os.environ.get(
            "COORDINATOR_ADDRESS")
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if coordinator_address is not None or num_processes is not None:
        if _distributed_initialized():
            log.debug("torch.distributed already initialized; skipping")
        else:
            dist.init_process_group(
                "gloo",
                init_method=f"tcp://{coordinator_address}",
                world_size=num_processes,
                rank=process_id,
            )
    return world_size() > 1


class Mesh:
    """A grid of devices with named axes: the counterpart of
    ``jax.sharding.Mesh``.

    ``devices``: a (nested) list or array of devices or their names; a
    device may repeat (``["cpu"] * 8``, or ``["cuda:0"] * 4`` on one card).
    ``process_index``: the owning process of each entry, an int array of
    the same shape (all 0 by default)."""

    def __init__(self, devices, axis_names=("data", "seq"), process_index=None):
        names = np.asarray(devices, dtype=object)
        self.devices = np.empty(names.shape, dtype=object)
        for idx in np.ndindex(names.shape):
            self.devices[idx] = torch.device(names[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid needs as many axis names, "
                             f"got {self.axis_names}")
        self.process_index = (np.zeros(self.devices.shape, np.int64) if process_index is None
                              else np.asarray(process_index, np.int64))
        if self.process_index.shape != self.devices.shape:
            raise ValueError("process_index must have the device grid's shape")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_axis_devices(self, axis: str) -> list[torch.device]:
        """This process's devices along ``axis``, from the first grid entry
        it owns (the other axes held there), in axis order."""
        me = rank()
        own = np.argwhere(self.process_index == me)
        if own.size == 0:
            raise ValueError(f"process {me} owns no device of the mesh")
        ax = self.axis_names.index(axis)
        idx = list(own[0])
        out = []
        for i in range(self.devices.shape[ax]):
            idx[ax] = i
            if self.process_index[tuple(idx)] == me:
                out.append(self.devices[tuple(idx)])
        return out


@dataclass(frozen=True)
class _MeshDevice:
    """A device of some process, as :func:`_rows_by_process` sorts them."""

    process_index: int
    id: int
    device: torch.device


def topology_mesh(n_data: int | None = None, n_seq: int | None = None, local_devices=None) -> Mesh:
    """A ``("data", "seq")`` mesh laid out for the topology: "data" spans
    processes, "seq" each process's own cards, so halo exchange and gather
    never cross processes.

    ``local_devices``: this process's devices, every card (``cuda:i``) by
    default (raises without CUDA); ``["cpu"] * n`` gives n CPU devices.
    Defaults: ``n_data`` = the process count, ``n_seq`` = the devices per
    data row.  With one process this is a reshape of the device list."""
    if local_devices is None:
        resolve_device("cuda")
        local_devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in local_devices]
    n_proc = world_size()
    everyone = [local]
    if n_proc > 1:
        everyone = [None] * n_proc
        dist.all_gather_object(everyone, local)
    devices = [_MeshDevice(p, i, torch.device(name)) for p, names in enumerate(everyone)
               for i, name in enumerate(names)]
    n_local, n_total = len(local), len(devices)
    if n_data is None:
        n_data = n_proc
    if n_seq is None:
        n_seq = n_total // n_data
    if n_data * n_seq > n_total:
        raise ValueError(f"mesh {n_data}x{n_seq} exceeds {n_total} devices")
    if n_proc > 1:
        # Every process owns its full share of mesh rows: data rows split
        # evenly across processes, and each row's n_seq devices come from
        # one process (the seq axis never leaves a process).
        rows_per_proc = n_data // n_proc
        if n_data % n_proc != 0 or rows_per_proc * n_seq > n_local:
            raise ValueError(
                f"multi-host mesh must keep seq within a host: "
                f"data={n_data} (processes: {n_proc}), seq={n_seq} "
                f"(local chips: {n_local})"
            )
        grid = _rows_by_process(devices, rows_per_proc, n_seq)
    else:
        grid = np.empty((n_data, n_seq), dtype=object)
        for i, d in enumerate(devices[: n_data * n_seq]):
            grid[divmod(i, n_seq)] = d
    return Mesh([[d.device for d in row] for row in grid], ("data", "seq"),
                process_index=[[d.process_index for d in row] for row in grid])


def _rows_by_process(devices, rows_per_proc: int, n_seq: int) -> np.ndarray:
    """[n_data, n_seq] device grid where each row's devices come from one
    process and every process owns exactly ``rows_per_proc`` rows."""
    by_proc: dict[int, list] = {}
    for d in sorted(devices, key=lambda d: (d.process_index, d.id)):
        by_proc.setdefault(d.process_index, []).append(d)
    rows = []
    for pid in sorted(by_proc):
        local = by_proc[pid]
        if len(local) < rows_per_proc * n_seq:
            raise ValueError(
                f"process {pid} owns {len(local)} devices, "
                f"needs {rows_per_proc}x{n_seq}"
            )
        for r in range(rows_per_proc):
            rows.append(local[r * n_seq : (r + 1) * n_seq])
    return np.array(rows)


def fleet_shard(paths, process_id: int | None = None, process_count: int | None = None):
    """The subset of recordings this process decodes in fleet mode.

    Deterministic round-robin by sorted order, so every process computes
    the same assignment without communicating.  Identity with one process."""
    pid = rank() if process_id is None else process_id
    n = world_size() if process_count is None else process_count
    return sorted(paths)[pid::n]


@dataclass(frozen=True)
class GlobalBatch:
    """One logical batch of recordings that spans processes: this
    process's rows (``local``, ``[B_local, N]``) and the process layout.
    Row ``r`` of process ``p`` is row ``p * B_local + r`` of the batch."""

    local: object
    process_index: int
    process_count: int
    axis: str = "data"

    @property
    def shape(self) -> tuple[int, int]:
        b, n = self.local.shape
        return b * self.process_count, n


def global_batch(mesh: Mesh, local_signals, axis: str = "data"):
    """Assemble one batch from every process's local recordings
    (``[B_local, N]`` each -> ``[B_local * n_proc, N]``), for
    ``parallel.batch_decode``.  With one process it is the identity: the
    local rows are the whole batch."""
    if axis not in mesh.axis_names:
        raise ValueError(f"the mesh has no {axis!r} axis: {mesh.axis_names}")
    if world_size() == 1:
        return local_signals
    return GlobalBatch(local_signals, rank(), world_size(), axis)
