"""Minimal PNG reader and writer for 8-bit grayscale, RGB and RGBA images.

The JAX package saves its CLI output and loads its palettes with PIL; the
port reads and writes PNGs itself (zlib + struct + numpy) so that it needs
nothing beyond torch and numpy on the machine with the card.  The decoded
pixels are identical (PNG is lossless); only the compressed container
differs.  The writer uses filter type 0 and one zlib stream, as
``noaa_apt_tpu/io/png.py`` does.  The reader takes what the vendored
palettes use and what PNG encoders commonly write: bit depth 8, colour
types 0/2/6, no interlace, all five scanline filters.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from .. import err

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray, RGB, RGBA)
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """[H, W], [H, W, 3] or [H, W, 4] uint8 -> PNG bytes."""
    ch = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if img.dtype != np.uint8 or ch not in _COLOR_TYPE:
        raise ValueError(f"expected [H, W], [H, W, 3] or [H, W, 4] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = np.empty((h, 1 + w * ch), np.uint8)
    raw[:, 0] = 0  # filter type None per scanline
    raw[:, 1:] = img.reshape(h, w * ch)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    idat = zlib.compress(raw.tobytes(), level)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def write_png(path, img: np.ndarray, level: int = 1) -> None:
    Path(path).write_bytes(encode_png(img, level))


def png_size(path) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk."""
    head = Path(path).read_bytes()[:24]
    if head[:8] != _SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline with its filter undone (PNG spec, section 9.2)."""
    if kind == 0:  # None
        return row
    if kind == 1:  # Sub: a running sum per channel, mod 256
        return (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return row + prev  # uint8 wraps mod 256
    if kind not in (3, 4):
        raise err.InvalidInputError(f"unknown PNG scanline filter {kind}")
    cur, up = row.tolist(), prev.tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:  # Average
            pred = (a + b) >> 1
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced grey, RGB or RGBA PNG -> uint8 [H, W, C]
    (C = 1, 3 or 4).  Anything else raises ``InvalidInputError``."""
    try:
        data = Path(path).read_bytes()
    except OSError as e:
        raise err.InvalidInputError(f"Could not read {str(path)!r}: {e}") from e
    if data[:8] != _SIG:
        raise err.InvalidInputError(f"{str(path)!r} is not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise err.InvalidInputError(f"{str(path)!r}: truncated {tag!r} chunk")
        if tag == b"IHDR":
            if length != 13:
                raise err.InvalidInputError(f"{str(path)!r}: bad IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise err.InvalidInputError(f"{str(path)!r}: no IHDR or IDAT chunk")
    w, h, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or compression != 0 or filt != 0 or interlace != 0:
        raise err.InvalidInputError(
            f"{str(path)!r}: unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); 8-bit non-interlaced grey, RGB or RGBA only"
        )
    ch = _CHANNELS[color]
    stride = w * ch
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise err.InvalidInputError(f"{str(path)!r}: corrupt image data: {e}") from e
    if len(raw) < h * (stride + 1):
        raise err.InvalidInputError(f"{str(path)!r}: image data too short")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, ch)
    return out.reshape(h, w, ch)
