"""A PNG reader in numpy and zlib: 8-bit greyscale, grey+alpha, RGB and
RGBA, non-interlaced, every filter type.  The card's host has no PIL, and
the benchmark reads the program's PNGs back with code of its own."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = a.astype(np.int16), b.astype(np.int16), c.astype(np.int16)
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 2:
            cur = line + prev
        elif f in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):  # sequential along the row
                left = cur[x - bpp] if x >= bpp else np.uint8(0)
                if f == 1:
                    cur[x] = cur[x] + left
                elif f == 3:
                    cur[x] = cur[x] + np.uint8((int(left) + int(prev[x])) // 2)
                else:
                    ul = prev[x - bpp] if x >= bpp else np.uint8(0)
                    cur[x] = cur[x] + _paeth(np.array(left), np.array(prev[x]), np.array(ul))
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """``[h, w]`` for greyscale, else ``[h, w, channels]``, uint8."""
    data = Path(path).read_bytes()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, colour {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (w * ch + 1)}")
    img = _unfilter(raw, h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)
