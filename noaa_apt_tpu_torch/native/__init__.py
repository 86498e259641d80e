"""Host C++ of the ingest payload modes, loaded through ctypes.

``ingest.cpp`` (a copy of the JAX package's native ingest functions,
bodies unchanged) is compiled at first use with g++ into
``noaa_apt_tpu_torch/_build/libingest-<hash>.so``, named by a hash of
the source and the flags, so an edit rebuilds and an unchanged tree
reuses the build.  The command is exactly the JAX package's
(``g++ -O3 [-march=native] -ffp-contract=off -shared -fPIC -pthread``,
first with ``-march=native``, then without): the fast-math dot
product's summation order follows the flags, and the same command gives
byte-identical payloads.

There is no numpy fallback: if g++ fails, the build raises.  (The JAX
package falls back to its numpy encoder for small passes; the port has
no such branch.)  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "ingest.cpp"
BUILD_DIR = _DIR.parent / "_build"
# -ffp-contract=off: without it -O3 (-march=native especially) fuses
# mul+add into FMA inside the exact dot products.
GXX_BASE = ("-O3", "-ffp-contract=off", "-shared", "-fPIC", "-pthread")
GXX_VARIANTS = (("-march=native",), ())
_BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None


def _flags(extra: tuple) -> list[str]:
    return [GXX_BASE[0], *extra, *GXX_BASE[1:]]


def lib_path(extra: tuple) -> Path:
    h = hashlib.sha256(" ".join(_flags(extra)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libingest-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library built with the first flag set that g++ takes (an
    existing build of the same source and flags is reused)."""
    for extra in GXX_VARIANTS:
        if lib_path(extra).exists():
            return lib_path(extra)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for extra in GXX_VARIANTS:
        out = lib_path(extra)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *_flags(extra), "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"{' '.join(cmd)}: {e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: concurrent builders each land a whole file
            return out
        tmp.unlink(missing_ok=True)
        errors.append(f"{' '.join(cmd)} (rc {proc.returncode}): {proc.stderr[-2000:]}")
    raise RuntimeError("g++ could not build the host ingest library:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded host ingest library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            i64, f32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
            i16p = ctypes.POINTER(ctypes.c_int16)
            lib.apt_fast_resample.restype = i64
            lib.apt_fast_resample.argtypes = [f32p, i64, i64, i64, f32p, i64, f32p, i64, i64, i64]
            for name, outp in (("apt_ingest_i16", i16p), ("apt_ingest_i8", ctypes.POINTER(ctypes.c_int8))):
                fn = getattr(lib, name)
                fn.restype = i64
                fn.argtypes = [i16p, i64, i64, i64, f32p, i64, outp, i64, i64, f32p, i64]
            lib.apt_pack_work_i16.restype = i64
            lib.apt_pack_work_i16.argtypes = [
                i16p, i64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint32), i64, i16p,
                ctypes.POINTER(ctypes.c_int32), i16p, i64, i64, i64, ctypes.POINTER(i64),
            ]
            _lib = lib
        return _lib


def _threads() -> int:
    return min(8, os.cpu_count() or 1)


def fast_resample_native(x: np.ndarray, l: int, m: int, coeff: np.ndarray, out_len: int,
                         exact: bool = True) -> np.ndarray:
    """Host polyphase L/M resample (``dsp.rs:186-289``).  ``exact=True``:
    the reference's per-output sequential accumulation; ``exact=False``:
    the same taps with a vectorized reduction (the quantized modes)."""
    lib = get_lib()
    # Aligned too: a float WAV's mapped samples may start 2 bytes off a float.
    x = np.require(x, np.float32, ["C", "A"])
    coeff = np.ascontiguousarray(coeff, dtype=np.float32)
    out = np.empty(out_len, dtype=np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.apt_fast_resample(x.ctypes.data_as(f32p), x.shape[0], l, m, coeff.ctypes.data_as(f32p),
                          coeff.shape[0], out.ctypes.data_as(f32p), out_len, _threads(),
                          0 if exact else 1)
    return out


def ingest_i16_native(x: np.ndarray, l: int, m: int, coeff: np.ndarray, out_true: int, out_pad: int,
                      bits: int = 16) -> tuple[np.ndarray, float]:
    """Fused ingest: raw int16 PCM -> polyphase work signal -> i16
    (``bits=16``) or i8 (``bits=8``) quantization in one call.  Returns
    ``(int work buffer of out_pad samples, zero past out_true;
    inv_scale)``.  ``x`` may be a read-only memmap: it is only read."""
    if x.dtype != np.int16:
        raise ValueError(f"ingest_i16 needs int16 input, got {x.dtype}")
    if bits not in (8, 16):
        raise ValueError(f"ingest quantization must be 8 or 16 bits, got {bits}")
    lib = get_lib()
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    coeff = np.ascontiguousarray(coeff, dtype=np.float32)
    inv_scale = ctypes.c_float(0.0)
    if bits == 8:
        out = np.empty(out_pad, dtype=np.int8)
        fn, ctype = lib.apt_ingest_i8, ctypes.c_int8
    else:
        out = np.empty(out_pad, dtype=np.int16)
        fn, ctype = lib.apt_ingest_i16, ctypes.c_int16
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = fn(x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), x.shape[0], l, m,
            coeff.ctypes.data_as(f32p), coeff.shape[0], out.ctypes.data_as(ctypes.POINTER(ctype)),
            out_true, out_pad, ctypes.byref(inv_scale), _threads())
    if rc < 0:
        raise ValueError(f"apt_ingest refused l={l} m={m} out_true={out_true} out_pad={out_pad}")
    return out, float(inv_scale.value)


def pack_work_i16_native(x: np.ndarray, work_rate_hz: int):
    """The host16c encoder (``ops/pack.py`` scheme), bit-identical to
    ``pack.pack_work_i16``.  Returns a ``PackedWork``, or the string
    ``"incompressible"`` when more than a quarter of the blocks would
    escape (callers ship the plain i16 payload)."""
    from ..ops.pack import BLOCK, PackedWork, predictor_coeff, unit_geometry

    if x.dtype != np.int16:
        raise ValueError(f"pack_work_i16 needs int16 input, got {x.dtype}")
    lib = get_lib()
    if not x.flags.c_contiguous:
        x = np.ascontiguousarray(x)
    n = int(x.shape[0])
    nb = -(-n // BLOCK)
    coeff = predictor_coeff(work_rate_hz)
    base = np.empty(nb * 63, np.uint32)  # worst-case stride (w_lo = 16)
    anchors = np.empty((nb, 2), np.int16)
    esc_cap = nb // 4 + 1
    esc_idx = np.empty(esc_cap, np.int32)
    esc_rows = np.empty((esc_cap, BLOCK), np.int16)
    n_esc = ctypes.c_int64(0)
    i16p = ctypes.POINTER(ctypes.c_int16)
    w_lo = lib.apt_pack_work_i16(
        x.ctypes.data_as(i16p), n, coeff, base.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        base.shape[0], anchors.ctypes.data_as(i16p), esc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        esc_rows.ctypes.data_as(i16p), esc_cap, nb, _threads(), ctypes.byref(n_esc),
    )
    if w_lo == -2:
        return "incompressible"
    if w_lo < 0:
        raise ValueError(f"apt_pack_work_i16 refused n={n} nb={nb}")
    _, _, _, bw = unit_geometry(int(w_lo))
    ne = int(n_esc.value)
    return PackedWork(base=base[: nb * bw].copy(), anchors=anchors, esc_idx=esc_idx[:ne].copy(),
                      esc_rows=esc_rows[:ne].copy(), w_lo=int(w_lo), n_samples=n, coeff=coeff)
