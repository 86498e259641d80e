"""A plain WAV reader: the RIFF chunks walked with ``struct``, the
samples read with numpy, channel 0 returned.

It reads 16-bit PCM and 32-bit IEEE float (format tag 3, or
``WAVE_FORMAT_EXTENSIBLE`` with the PCM or the IEEE-float sub-format) at
any channel count, as upstream noaa-apt reads them through hound
(``src/wav.rs``): integer samples at their integer scale, floats as
they are, channel 0 of a multichannel file.  The last ``fmt `` and
``data`` chunks win; a data chunk that claims more bytes than the file
holds is read as far as whole frames go.  Anything else raises
``ValueError``.

It imports nothing of the program under test.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

PCM, IEEE_FLOAT, EXTENSIBLE = 1, 3, 0xFFFE
# The tail that KSDATAFORMAT_SUBTYPE_PCM and _IEEE_FLOAT share after
# their first two bytes (the format tag) and two zero bytes.
GUID_TAIL = bytes.fromhex("000000001000800000aa00389b71")
DTYPES = {(PCM, 16): "<i2", (IEEE_FLOAT, 32): "<f4"}


@dataclass(frozen=True)
class WavInfo:
    tag: int  # PCM or IEEE_FLOAT, after the extensible sub-format
    channels: int
    rate: int
    bits: int
    frames: int


def chunks(raw: bytes) -> dict:
    """``{chunk id: (body offset, declared size)}`` of a RIFF/WAVE file,
    the last chunk of each id winning."""
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    out, off = {}, 12
    while off + 8 <= len(raw):
        cid, size = raw[off : off + 4], struct.unpack_from("<I", raw, off + 4)[0]
        out[cid] = (off + 8, size)
        off += 8 + size + (size & 1)
    return out


def parse_fmt(body: bytes) -> tuple[int, int, int, int]:
    """``(tag, channels, rate, bits)`` of a ``fmt `` chunk's body."""
    if len(body) < 16:
        raise ValueError(f"fmt chunk of {len(body)} bytes")
    tag, channels, rate, _byte_rate, _align, bits = struct.unpack_from("<HHIIHH", body, 0)
    if tag == EXTENSIBLE:
        if len(body) < 40 or body[26:40] != GUID_TAIL:
            raise ValueError("WAVE_FORMAT_EXTENSIBLE without a PCM or IEEE-float sub-format")
        tag = struct.unpack_from("<H", body, 24)[0]
    return tag, channels, rate, bits


def read(path) -> tuple[np.ndarray, WavInfo]:
    """Channel 0 of the WAV at ``path`` (int16 or float32, as stored) and
    what its header says."""
    raw = Path(path).read_bytes()
    found = chunks(raw)
    if b"fmt " not in found or b"data" not in found:
        raise ValueError("no fmt or data chunk")
    o, size = found[b"fmt "]
    tag, channels, rate, bits = parse_fmt(raw[o : o + size])
    if (tag, bits) not in DTYPES or channels < 1:
        raise ValueError(f"format tag {tag}, {bits} bits, {channels} channels: not read here")
    o, size = found[b"data"]
    frame = channels * bits // 8
    frames = min(size, len(raw) - o) // frame
    samples = np.frombuffer(raw, dtype=DTYPES[(tag, bits)], count=frames * channels, offset=o)
    return samples[::channels].copy(), WavInfo(tag, channels, rate, bits, frames)
