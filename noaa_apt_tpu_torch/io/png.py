"""Minimal PNG writer for 8-bit grayscale and RGBA images.

The JAX package saves its CLI output with PIL; the port writes the PNG
itself (zlib + struct) so that it needs nothing beyond torch and numpy
on the machine with the card.  The decoded pixels are identical (PNG is
lossless); only the compressed container differs.  Scanlines use filter
type 0 and one zlib stream, as ``noaa_apt_tpu/io/png.py`` does.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 4: 6}  # channels -> PNG color type (gray, RGBA)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """[H, W] or [H, W, 4] uint8 -> PNG bytes."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 4):
        raise ValueError(f"expected [H, W] or [H, W, 4] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else 4
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
