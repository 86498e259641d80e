#!/usr/bin/env python3
"""Time the decoder's upload of a mapped WAV in its variants, on one GPU.

    python3 tools/upload_ab.py [REPS]

Writes a 10-minute 48 kHz pass as a stereo 32-bit float WAV (SDR#'s
layout: the data chunk 58 bytes in) and as a mono 16-bit WAV, so both
lie in the page cache, then uploads each ``REPS`` times (default 10) with
``Decoder._upload`` in every variant, the variants in turn within each
repetition, each from a fresh map as the CLI's load makes it:

- ``host_copy``: no ring (``upload.locate`` finds nothing), the copy or
  float32 cast on the host and a pageable ``.to(device)``;
- ``pread``: the ring as the decoder runs it, the slots filled by
  ``os.preadv`` from the file;
- ``copyto``: the same ring, the slots filled by ``np.copyto`` out of a
  map of the file;
- ``pread_4thr``, ``pread_16mb``: ``pread`` on 4 pool threads, and with
  16 MB slots.

Each upload ends in ``torch.cuda.synchronize()`` and is held bit-equal
to ``host_copy``'s.  Prints the ``nvidia-smi`` line of the card, the
time of the first pinned ring's allocation, then one JSON line per file:
each variant's median and quartiles of milliseconds.  Needs CUDA.
"""

from __future__ import annotations

import json
import logging
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from aptbench.entries.single_wavfmt import write_wav as write_float_wav  # noqa: E402
from noaa_apt_tpu_torch.core.profiles import STANDARD  # noqa: E402
from noaa_apt_tpu_torch.graph import upload  # noqa: E402
from noaa_apt_tpu_torch.graph.decode import Decoder  # noqa: E402
from noaa_apt_tpu_torch.io import wav  # noqa: E402

RATE = 48000


def copyto_fill(maps: dict):
    """``UploadRing.fill`` by ``np.copyto`` out of ``maps["src"]``, a map of the file."""

    def fill(self, k, fd, offset, size):
        if self.copied[k] is not None:
            self.copied[k].synchronize()
        np.copyto(np.frombuffer(self.host[k], np.uint8, size), maps["src"][offset : offset + size])

    return fill


def run(dec, path: Path, variant: str, maps: dict) -> tuple[float, torch.Tensor]:
    sig = wav.load_device_ready(path)[0]
    patches = {}
    if variant == "host_copy":
        patches[(upload, "locate")] = lambda arr, n: None
    elif variant == "copyto":
        maps["src"] = np.memmap(path, np.uint8, mode="r")
        patches[(upload.UploadRing, "fill")] = copyto_fill(maps)
    elif variant in ("pread_4thr", "pread_16mb"):
        workers, slot = (4, 8 << 20) if variant == "pread_4thr" else (upload._workers(), 16 << 20)
        if variant not in maps:  # allocated once, outside the timing
            maps[variant] = upload.UploadRing(dec.device, 2 * workers, slot)
        patches[(upload, "upload_ring")] = lambda device: maps[variant]
        patches[(upload, "_workers")] = lambda: workers
    saved = {key: getattr(*key) for key in patches}
    try:
        for (obj, name), value in patches.items():
            setattr(obj, name, value)
        upload._executor()  # a changed worker count makes its pool here, outside the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = dec._upload(sig, len(sig))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (obj, name), value in saved.items():
            setattr(obj, name, value)
    return ms, x


def main() -> int:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__}), flush=True)
    logging.getLogger("noaa_apt_tpu_torch").setLevel(logging.ERROR)  # the stereo file's warning
    dec = Decoder(STANDARD, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    upload.upload_ring(dec.device)
    print(json.dumps({"ring_alloc_ms": (time.perf_counter() - t0) * 1e3,
                      "slots": len(upload.upload_ring(dec.device).slots), "slot_bytes": upload._SLOT_BYTES}))
    rng = np.random.default_rng(23)
    pcm = rng.integers(-20000, 20000, RATE * 600, dtype=np.int16)
    variants = ("host_copy", "pread", "copyto", "pread_4thr", "pread_16mb")
    with tempfile.TemporaryDirectory() as tmp:
        files = {"stereo_f32": Path(tmp) / "f32.wav", "mono_i16": Path(tmp) / "i16.wav"}
        scaled = pcm.astype(np.float32) * np.float32(2.0**-15)
        write_float_wav(files["stereo_f32"], [scaled, -scaled], RATE)
        wav.write_wav(files["mono_i16"], pcm.astype(np.float32), wav.WavSpec(1, RATE, 16, "int"))
        for name, path in files.items():
            maps: dict = {}
            times = {v: [] for v in variants}
            want = run(dec, path, "host_copy", maps)[1]
            for r in range(reps + 1):  # the first repetition warms up
                order = variants if r % 2 == 0 else variants[::-1]
                for v in order:
                    ms, x = run(dec, path, v, maps)
                    bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t)
                    if x.dtype != want.dtype or not torch.equal(bits(x), bits(want)):
                        raise AssertionError(f"{name}: {v} differs from host_copy")
                    if r:
                        times[v].append(ms)
            out = {}
            for v, ts in times.items():
                q = statistics.quantiles(ts, n=4)
                out[v] = {"median_ms": statistics.median(ts), "q1": q[0], "q3": q[2]}
            print(json.dumps({"file": name, "bytes": path.stat().st_size, "reps": reps, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
