"""The port's multi-process layer (``noaa_apt_tpu_torch/parallel/dist.py``)
against the JAX package's (``tests/test_dist.py``), on the CPU.

The one-process cases run here; the real multi-process cases start two
processes that join a gloo process group on 127.0.0.1: two port CLIs with
``--multihost``, and two runs of this module as the worker of the fleet
share and the global batch (``python tests/test_torch_dist.py batch PORT
PID``), which imports neither JAX nor the JAX package.
"""

import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
DIST_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
WORKER_TIMEOUT_S = 120


def _worker_batch(port: str, pid: int) -> None:
    """One process of the two-process run: its fleet share, then one
    global batch whose row ``p`` is process ``p``'s recording (seed ``p``)."""
    from noaa_apt_tpu_torch.core.frequency import Rate
    from noaa_apt_tpu_torch.core.profiles import STANDARD
    from noaa_apt_tpu_torch.graph.decode import Decoder
    from noaa_apt_tpu_torch.parallel import (batch_decode, fleet_shard, global_batch, init_distributed,
                                             topology_mesh)
    from noaa_apt_tpu_torch.parallel.dist import GlobalBatch, world_size
    from noaa_apt_tpu_torch.synth import synth_recording

    assert init_distributed(f"127.0.0.1:{port}", 2, pid) is True
    assert world_size() == 2
    assert init_distributed(f"127.0.0.1:{port}", 2, pid) is True  # idempotent
    share = fleet_shard([f"pass{i}.wav" for i in range(5)])
    print(f"SHARE {pid} {','.join(share)}", flush=True)

    rate = Rate(11025)
    sigs = [synth_recording(n_rows=16, sample_rate=11025, noise_db=15.0, seed=p)[0] for p in range(2)]
    dec = Decoder(STANDARD, device="cpu")
    singles = [dec.decode(s, rate) for s in sigs]
    mesh = topology_mesh(local_devices=["cpu"])  # 2 processes x 1 local device
    assert mesh.shape == {"data": 2, "seq": 1}
    assert mesh.process_index.tolist() == [[0], [1]]
    gbatch = global_batch(mesh, np.stack([sigs[pid]]))
    assert isinstance(gbatch, GlobalBatch) and gbatch.shape == (2, len(sigs[pid]))
    results = batch_decode(dec, gbatch, rate, mesh, axis="data")
    assert len(results) == 2
    for r, s in zip(results, singles):
        assert r.sync_positions == s.sync_positions
        assert torch.equal(r.image, s.image)
    print(f"OK {pid} rows={results[0].n_rows},{results[1].n_rows}", flush=True)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(args_of, env_of=lambda pid: {}) -> list[str]:
    """Start two processes (``args_of(pid)``), wait for both (each within
    ``WORKER_TIMEOUT_S``) and return their outputs; kills both on failure."""
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, *args_of(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env={**env, **env_of(pid)})
             for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
            outs.append(out)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "batch":
        _worker_batch(sys.argv[2], int(sys.argv[3]))
    sys.exit(0)


import pytest  # noqa: E402

from noaa_apt_tpu.core.frequency import Rate as JRate  # noqa: E402
from noaa_apt_tpu.core.profiles import STANDARD as JSTANDARD  # noqa: E402
from noaa_apt_tpu.graph.decode import Decoder as JDecoder  # noqa: E402
from noaa_apt_tpu.graph.decode import pad_bucket as jpad_bucket  # noqa: E402
from noaa_apt_tpu.io import wav as jwav  # noqa: E402
from noaa_apt_tpu.parallel import batch_decode as jbatch_decode  # noqa: E402
from noaa_apt_tpu.parallel import global_batch as jglobal_batch  # noqa: E402
from noaa_apt_tpu.parallel import topology_mesh as jtopology_mesh  # noqa: E402
from noaa_apt_tpu.synth import synth_recording  # noqa: E402

from noaa_apt_tpu_torch import cli  # noqa: E402
from noaa_apt_tpu_torch.core.frequency import Rate  # noqa: E402
from noaa_apt_tpu_torch.core.profiles import STANDARD  # noqa: E402
from noaa_apt_tpu_torch.graph.decode import Decoder, pad_bucket  # noqa: E402
from noaa_apt_tpu_torch.parallel import (Mesh, batch_decode, fleet_shard, global_batch,  # noqa: E402
                                         init_distributed, topology_mesh)
from noaa_apt_tpu_torch.parallel import dist  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_coordinator(monkeypatch):
    for name in DIST_ENV:
        monkeypatch.delenv(name, raising=False)


def test_init_distributed_no_coordinator_is_noop():
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world_size()) == (0, 1)


def test_topology_mesh_layout():
    mesh = topology_mesh(n_data=2, n_seq=4, local_devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "seq": 4}
    assert mesh.devices.shape == (2, 4) and mesh.axis_names == ("data", "seq")
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))
    assert mesh.local_axis_devices("seq") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="exceeds"):
        topology_mesh(n_data=16, n_seq=16, local_devices=["cpu"] * 8)
    jmesh = jtopology_mesh(n_data=2, n_seq=4)
    assert jmesh.shape == mesh.shape


def test_topology_mesh_defaults():
    mesh = topology_mesh(local_devices=["cpu"] * 8)
    assert mesh.shape == {"data": 1, "seq": 8} == dict(jtopology_mesh().shape)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            topology_mesh()  # every card by default: none here


def test_fleet_shard_deterministic_partition():
    paths = [f"{c}.wav" for c in "fedcba"]
    shards = [fleet_shard(paths, process_id=i, process_count=3) for i in range(3)]
    assert sorted(sum(shards, [])) == sorted(paths)  # exact cover
    assert shards[0] == ["a.wav", "d.wav"]  # sorted round-robin
    assert fleet_shard(paths, process_id=0, process_count=1) == sorted(paths) == fleet_shard(paths)


def test_global_batch_decode_matches_single_and_jax():
    """One process: ``global_batch`` is the identity, and ``batch_decode``
    over it gives the one-device decode, on the JAX package's sync list."""
    signal, _ = synth_recording(n_rows=16, sample_rate=11025, noise_db=15.0)
    single = Decoder(STANDARD, device="cpu").decode(signal, Rate(11025))
    mesh = topology_mesh(n_data=2, n_seq=4, local_devices=["cpu"] * 8)
    n_pad = pad_bucket(len(signal))
    assert n_pad == jpad_bucket(len(signal))
    local = np.zeros((2, n_pad), np.float32)
    local[:, : len(signal)] = signal
    gbatch = global_batch(mesh, local)
    assert gbatch is local
    results = batch_decode(Decoder(STANDARD, device="cpu"), gbatch, Rate(11025), mesh, axis="data",
                           n_true=len(signal))
    jmesh = jtopology_mesh(n_data=2, n_seq=4)
    jres = jbatch_decode(JDecoder(JSTANDARD), jglobal_batch(jmesh, local), JRate(11025), jmesh, axis="data",
                         n_true=len(signal))
    assert len(results) == len(jres) == 2
    for r, j in zip(results, jres):
        assert r.sync_positions == single.sync_positions == j.sync_positions
        assert torch.equal(r.image, single.image)


def test_rows_by_process_submesh_spreads_hosts():
    """A sub-mesh gives every process its share of rows."""

    @dataclass(frozen=True)
    class FakeDev:
        process_index: int
        id: int

    devices = [FakeDev(p, p * 4 + i) for p in range(2) for i in range(4)]
    grid = dist._rows_by_process(devices, rows_per_proc=1, n_seq=2)
    assert grid.shape == (2, 2)
    assert {d.process_index for d in grid[0]} == {0}
    assert {d.process_index for d in grid[1]} == {1}
    with pytest.raises(ValueError, match="owns"):
        dist._rows_by_process(devices, rows_per_proc=1, n_seq=8)


def test_mesh_process_layout():
    """Process 0 owns the first data row: its seq devices are that row's,
    and a mesh it owns no entry of is refused."""
    mesh = Mesh([["cpu", "cpu"], ["cuda:0", "cuda:1"]], ("data", "seq"), process_index=[[0, 0], [1, 1]])
    assert mesh.local_axis_devices("seq") == [torch.device("cpu")] * 2
    assert mesh.local_axis_devices("data") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="owns no device"):
        Mesh(["cpu"], ("seq",), process_index=[1]).local_axis_devices("seq")
    with pytest.raises(ValueError, match="axis names"):
        Mesh(["cpu"] * 2, ("data", "seq"))


def test_init_distributed_raises_on_bad_coordinator(monkeypatch):
    """A failed init propagates (never a one-process view); a process
    group that is already up is kept, from the runtime's own state."""
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")  # unreachable
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    called = {}

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        called["args"] = (backend, init_method, world_size, rank)
        raise RuntimeError("Could not connect to the coordinator")

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    with pytest.raises(RuntimeError, match="coordinator"):
        init_distributed()
    assert called["args"] == ("gloo", "tcp://127.0.0.1:1", 2, 0)

    def fake_never(*a, **kw):
        raise AssertionError("init_process_group must not be called when already up")

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_never)
    monkeypatch.setattr(dist, "_distributed_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    assert init_distributed() is False  # a one-process group, no raise

    monkeypatch.setattr(dist, "_distributed_initialized", lambda: False)

    def fake_misleading(*a, **kw):
        raise RuntimeError("barrier already timed out once: coordinator gone")

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_misleading)
    with pytest.raises(RuntimeError, match="barrier"):
        init_distributed()


def test_init_distributed_reads_torchrun_env(monkeypatch):
    """Without the JAX package's variables, torchrun's drive the init."""
    for name, value in (("MASTER_ADDR", "10.0.0.7"), ("MASTER_PORT", "29500"), ("WORLD_SIZE", "4"),
                        ("RANK", "3")):
        monkeypatch.setenv(name, value)
    called = {}

    def fake_init(backend, init_method=None, world_size=-1, rank=-1):
        called["args"] = (backend, init_method, world_size, rank)
        raise RuntimeError("no such host")

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    with pytest.raises(RuntimeError, match="no such host"):
        init_distributed()
    assert called["args"] == ("gloo", "tcp://10.0.0.7:29500", 4, 3)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError):
        init_distributed()
    assert called["args"] == ("gloo", "tcp://127.0.0.1:1234", 4, 1)


def test_two_process_fleet_shard_and_global_batch():
    """Two real gloo processes: a disjoint, complete fleet partition, and
    one global batch decoded across both, every process getting both
    results equal to the one-device decode."""
    port = _free_port()
    outs = _run_two(lambda pid: [__file__, "batch", str(port), str(pid)])
    shares = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("SHARE "):
                _, pid, files = line.split(" ", 2)
                shares[int(pid)] = files.split(",")
        assert "OK" in out, out
    assert sorted(shares[0] + shares[1]) == [f"pass{i}.wav" for i in range(5)]
    assert not set(shares[0]) & set(shares[1])


def test_two_process_cli_multihost(tmp_path, monkeypatch):
    """Two CLI processes with ``--multihost`` over a directory of three
    passes, coordinated by the JAX package's variables: each decodes its
    share (disjoint, complete), and each PNG equals the one-process
    fleet's."""
    d = tmp_path / "passes"
    d.mkdir()
    for seed in range(3):
        sig, _ = synth_recording(n_rows=12, sample_rate=11025, noise_db=18.0, seed=seed)
        jwav.write_wav(d / f"pass_{seed}.wav", sig, jwav.WavSpec(1, 11025, 16, "int"))
    env = {"XDG_CONFIG_HOME": str(tmp_path / "cfg")}
    monkeypatch.setenv("XDG_CONFIG_HOME", env["XDG_CONFIG_HOME"])
    assert cli.main([str(d), "-o", str(tmp_path / "single"), "--device", "cpu", "-q"]) == 0
    port = _free_port()
    outs = _run_two(
        lambda pid: ["-m", "noaa_apt_tpu_torch", str(d), "-o", str(tmp_path / f"out_{pid}"), "--device", "cpu",
                     "--multihost"],
        lambda pid: {**env, "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}", "JAX_NUM_PROCESSES": "2",
                     "JAX_PROCESS_ID": str(pid), "OMP_NUM_THREADS": "1"})
    shares = [sorted(p.name for p in (tmp_path / f"out_{pid}").glob("*.png")) for pid in range(2)]
    assert shares == [["pass_0.png", "pass_2.png"], ["pass_1.png"]]
    for pid, out in enumerate(outs):
        assert f"multihost fleet: process {pid}/2 decoding {len(shares[pid])} of the recordings" in out, out
        for name in shares[pid]:
            got = (tmp_path / f"out_{pid}" / name).read_bytes()
            assert got == (tmp_path / "single" / name).read_bytes(), name
