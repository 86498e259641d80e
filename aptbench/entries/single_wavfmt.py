"""Entry ``single_wavfmt``: ``single``'s station, whose recorder
writes each pass as 32-bit IEEE float WAV.

At set-up, before the window, each pool pass is written beside its
16-bit twin as the configuration's recorder writes it: ``channels``
interleaved channels of 32-bit IEEE float (an 18-byte ``fmt `` with
format tag 3, a ``fact`` chunk, then ``data``), every channel the same
AF, ``int16 / 32768``.  The CLI is pointed at the float files; the kept
PNGs are judged against the twins, as in ``single``.  After the window,
and before the check, each file is read back with the plain reader
(``reference/wavread.py``), and its channel 0 has to equal the twin's
samples times 2**-15 bit for bit; a power of two scales exactly, so the
harness's check, which decodes the twin, holds the float file to the
same reference.  The read-back is not set-up: it runs outside
``setup_s`` and the window.
"""

from __future__ import annotations

import contextlib
import struct

import numpy as np

from aptbench import spec
from aptbench.gen.pool import read_wav
from aptbench.reference import wavread

single = spec.Spec.entry("single")

SCALE = np.float32(2.0**-15)  # int16 counts to the recorder's float full scale


def write_wav(path, chans: list, rate: int) -> None:
    """A 32-bit IEEE float WAV of the interleaved ``chans`` (equal-length
    float32 arrays): an 18-byte ``fmt `` of tag 3, a ``fact`` chunk and
    ``data``."""
    frames = chans[0].shape[0]
    inter = np.empty((frames, len(chans)), dtype="<f4")
    for c, x in enumerate(chans):
        inter[:, c] = x
    align = 4 * len(chans)
    fmt = struct.pack("<HHIIHHH", wavread.IEEE_FLOAT, len(chans), rate, rate * align, align, 32, 0)
    head = (b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"fact" + struct.pack("<II", 4, frames)
            + b"data" + struct.pack("<I", inter.nbytes))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(head) + inter.nbytes) + b"WAVE" + head)
        f.write(inter.data)


class Entry(single.Entry):
    def __init__(self, run):
        super().__init__(run)
        if run.config["sample_format"] != "float32":
            raise ValueError(f"single_wavfmt writes float32 WAVs, not {run.config['sample_format']}")
        self.channels = int(run.config["channels"])
        d = run.pool_dir / "float32"
        d.mkdir()
        self.files = []
        self.report: dict = {}
        for p in run.passes:
            f = d / p.path.name
            write_wav(f, [(read_wav(p.path).astype(np.float32) * SCALE)] * self.channels, p.rate)
            self.files.append(f)

    def _main(self, k: int, png, report: dict) -> int:
        argv = [str(self.files[k]), "-o", str(png), "-q", *self.run.config["cli_args"], *self.run.extra_args]
        self.report = report
        with contextlib.redirect_stdout(self.sink):
            return self.cli.main(argv, report=report)

    def call(self, i: int, record: bool = False) -> dict:
        out = super().call(i, record)
        out["passes"][0]["wav_bytes"] = self.report.get("wav_bytes")  # None where the CLI has no such counter
        return out

    def outputs(self) -> list:
        """``single``'s outputs, once every float file the CLI read has
        been read back: channel 0 the twin's samples / 32768."""
        for p, f in zip(self.run.passes, self.files):
            back, info = wavread.read(f)
            if ((info.tag, info.channels, info.rate) != (wavread.IEEE_FLOAT, self.channels, p.rate)
                    or not np.array_equal(back.astype(np.float64), read_wav(p.path) / 32768.0)):
                raise RuntimeError(f"{f.name}: channel 0 read back is not the 16-bit twin's samples / 32768")
        return super().outputs()

    def close(self) -> None:
        """Delete the float files, then the PNGs but the kept ones."""
        for f in self.files:
            f.unlink(missing_ok=True)
        super().close()
