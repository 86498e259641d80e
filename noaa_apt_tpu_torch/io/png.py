"""Minimal PNG reader and writer for 8-bit grayscale, RGB and RGBA images.

The JAX package saves its CLI output and loads its palettes with PIL; the
port reads and writes PNGs itself (zlib + struct + numpy) so that it needs
nothing beyond torch and numpy on the machine with the card.  The decoded
pixels are identical (PNG is lossless); only the compressed container
differs.  The writer uses filter type 0, as ``noaa_apt_tpu/io/png.py``
does.  An image under two strips' worth of filtered rows (``_STRIP_BYTES``)
is one ``zlib.compress`` stream in one IDAT chunk, byte for byte the JAX
package's writer.  A larger one is cut into strips of whole rows, each
deflated on a shared pool of ``min(8, cpu_count)`` host threads (zlib
releases the GIL), primed with the 32 KiB of filtered rows before it as
its dictionary, as pigz does, and written as one IDAT chunk a strip: the
chunks join into one zlib stream, whose adler32 trailer is combined from
the strips'.  The plan depends on the image's shape alone, so the bytes
do not depend on the core count.  The reader takes what the vendored
palettes use and what PNG encoders commonly write: bit depth 8, colour
types 0/2/6, no interlace, all five scanline filters.
"""

from __future__ import annotations

import math
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .. import err
from ..native import _threads as _workers
from ..spans import span

_SIG = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type (gray, RGB, RGBA)
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


_STRIP_BYTES = 256 * 1024  # about the least filtered bytes of a strip
_MAX_STRIPS = 16
_ADLER_BASE = 65521
_WINDOW = 32768  # deflate's window: a strip's dictionary

_pool: ThreadPoolExecutor | None = None
_pool_key: tuple[int, int] | None = None
_pool_lock = threading.Lock()


def strip_rows(h: int, row_bytes: int) -> list[tuple[int, int]]:
    """The strips' row ranges of an image of ``h`` filtered rows of
    ``row_bytes`` each: one range under two strips' worth, else at most
    ``_MAX_STRIPS`` ranges a row apart at most, of about ``_STRIP_BYTES``
    or more."""
    n = min(_MAX_STRIPS, h * row_bytes // _STRIP_BYTES)
    if n < 2:
        return [(0, h)]
    cuts = [h * k // n for k in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def png_strips(img: np.ndarray) -> int:
    """The number of IDAT strips :func:`encode_png` writes for ``img``."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    return len(strip_rows(img.shape[0], 1 + img.shape[1] * ch))


def adler32_combine(a: int, b: int, len_b: int) -> int:
    """The adler32 of ``A + B`` from ``a = adler32(A)``, ``b = adler32(B)``
    and ``len(B)`` (zlib's ``adler32_combine``)."""
    n = len_b % _ADLER_BASE
    a1, a2, b1, b2 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    s1 = (a1 + b1 - 1) % _ADLER_BASE
    s2 = (a2 + b2 + n * (a1 - 1)) % _ADLER_BASE
    return (s2 << 16) | s1


def _executor() -> ThreadPoolExecutor:
    """The shared deflate pool, made at the first multi-strip PNG and again
    in a forked child or where the worker count changed."""
    global _pool, _pool_key
    key = (os.getpid(), _workers())
    with _pool_lock:
        if _pool is None or _pool_key != key:
            if _pool is not None and _pool_key[0] == key[0]:
                _pool.shutdown(wait=False)  # its queued strips still run
            _pool = ThreadPoolExecutor(key[1], thread_name_prefix="apt-png")
            _pool_key = key
        return _pool


def _filtered(rows: np.ndarray) -> np.ndarray:
    """``[n, W]`` or ``[n, W, C]`` pixels -> ``[n, 1 + W * C]`` scanlines with
    filter type 0."""
    n, stride = rows.shape[0], math.prod(rows.shape[1:])
    raw = np.empty((n, 1 + stride), np.uint8)
    raw[:, 0] = 0  # filter type None per scanline
    raw[:, 1:] = rows.reshape(n, stride)
    return raw


def _deflate_strip(rows: np.ndarray, before: np.ndarray, level: int, head: bytes,
                   last: bool) -> tuple[bytes, int, int, int]:
    """One strip in a pool thread: its filtered rows deflated raw behind
    ``head``, with the last 32 KiB of the rows ``before`` it filtered as the
    dictionary, ending in a sync flush (the stream's end on the last
    strip); their adler32 and length; the CRC of ``IDAT`` and the body."""
    with span("apt.png.strip"):
        raw = _filtered(rows)
        zdict = {"zdict": _filtered(before).reshape(-1)[-_WINDOW:]} if len(before) else {}
        c = zlib.compressobj(level, zlib.DEFLATED, -15, **zdict)
        body = head + c.compress(raw) + c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)
        return body, zlib.adler32(raw), raw.nbytes, zlib.crc32(body, zlib.crc32(b"IDAT"))


def _strip_idats(img: np.ndarray, strips: list[tuple[int, int]], level: int) -> bytes:
    """The IDAT chunks of ``img``'s rows, one a strip, deflated in the pool."""
    pool = _executor()
    head = zlib.compress(b"", level)[:2]  # the header zlib.compress writes at this level
    back = -(-_WINDOW // (1 + math.prod(img.shape[1:])))  # rows that hold a window
    futures = [pool.submit(_deflate_strip, img[r0:r1], img[max(0, r0 - back):r0], level,
                           head if k == 0 else b"", k == len(strips) - 1)
               for k, (r0, r1) in enumerate(strips)]
    chunks, adler = [], 1
    for k, f in enumerate(futures):
        body, a, n, crc = f.result()
        adler = adler32_combine(adler, a, n)
        if k == len(futures) - 1:
            tail = struct.pack(">I", adler)
            body, crc = body + tail, zlib.crc32(tail, crc)
        chunks.append(struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(">I", crc & 0xFFFFFFFF))
    return b"".join(chunks)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """[H, W], [H, W, 3] or [H, W, 4] uint8 -> PNG bytes."""
    ch = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if img.dtype != np.uint8 or ch not in _COLOR_TYPE:
        raise ValueError(f"expected [H, W], [H, W, 3] or [H, W, 4] uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    strips = strip_rows(h, 1 + w * ch)
    with span("apt.png.deflate"):
        if len(strips) == 1:
            idat = _chunk(b"IDAT", zlib.compress(_filtered(img), level))
        else:
            idat = _strip_idats(img, strips, level)
    return _SIG + _chunk(b"IHDR", ihdr) + idat + _chunk(b"IEND", b"")


def write_png(path, img: np.ndarray, level: int = 1) -> None:
    data = encode_png(img, level)
    with span("apt.png.write"):
        Path(path).write_bytes(data)


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
