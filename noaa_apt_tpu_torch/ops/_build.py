"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries land in
``noaa_apt_tpu_torch/_build/``, named by a hash of the source and the
flags, so an edit rebuilds and an unchanged tree reuses the build.

Nothing here runs at import time: the first kernel launch builds every
library (one ``nvcc`` per source, all started together), and
``chip_smoke.py`` calls :func:`build_all` up front to time the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# csrc/<name>.cu -> lib<name>-<hash>.so
SOURCES = ("resample", "stage", "select", "unpack")

# sm_90a: Hopper.  --fmad=false plus the explicit __fmul_rn/__fadd_rn in
# the sources: every multiply and add rounds once, which is what makes
# each kernel bit-equal to its plain PyTorch twin.  No fast math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_BUILD_TIMEOUT_S = 600
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$NVCC``, else ``nvcc`` on ``PATH``, else ``$CUDA_HOME/bin/nvcc``."""
    env = os.environ.get("NVCC")
    if env:
        return env
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: put it on PATH or set NVCC or CUDA_HOME "
        "(the CUDA kernels are built from source at first use)"
    )


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library that is not built yet, one ``nvcc`` per
    source, all running at once.  Returns the wall seconds spent.  The
    ptxas report (registers, shared memory, spills) of each build is
    kept beside its library as ``.log``."""
    t0 = time.perf_counter()
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = []
    try:
        for name in todo:
            out = lib_path(name)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = open(out.with_suffix(".log"), "wb")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log))
        failed = []
        for name, proc, tmp, out, log in jobs:
            try:
                rc = proc.wait(timeout=_BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = -1
            log.close()
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"{name} (rc {rc}): {out.with_suffix('.log').read_text(errors='replace')[-4000:]}")
    finally:
        for _, proc, _, _, log in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building all first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")
