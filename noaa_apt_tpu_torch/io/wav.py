"""WAV container I/O.

Behavioral contract: reference ``src/wav.rs`` (via the hound crate):

- ``load_wav``: int samples are exposed at their raw integer scale
  (an i16 sample becomes e.g. -32768..32767 as f32 — *not* normalized),
  floats pass through; only channel 0 of multichannel files is kept.
- ``write_wav``: samples are normalized by the (signed) maximum sample
  before writing as f32 or i16 (``wav.rs:62-98``).
- The hound "wrong length in header" failure mode
  (``noaa_apt.rs:114-130``) is handled by reading as many whole frames
  as the data chunk actually contains.

Implemented directly over the RIFF layout with NumPy (the stdlib
``wave`` module cannot read float WAVs).  The port of
``noaa_apt_tpu/io/wav.py``, the live-stream reader (:class:`PcmStreamReader`,
``--stream``) included; both file loaders run one chunk walk and one
sample decode (:func:`_load`).
"""

from __future__ import annotations

import logging
import os
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import err
from ..core.frequency import Rate
from ..spans import span

log = logging.getLogger(__name__)

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


@dataclass(frozen=True)
class WavSpec:
    channels: int
    sample_rate: int
    bits_per_sample: int
    sample_format: str  # "int" | "float"


# (format tag, bits) -> the dtype numpy views the samples as, where they lie.
_VIEWS = {(_FMT_PCM, 16): "<i2", (_FMT_PCM, 32): "<i4", (_FMT_FLOAT, 32): "<f4", (_FMT_FLOAT, 64): "<f8"}
# The formats the decoder takes as they lie, which load_device_ready maps.
_MAPPED = ((_FMT_PCM, 16), (_FMT_FLOAT, 32))


def _decode_pcm(data, audio_fmt: int, bits: int) -> tuple[str, np.ndarray]:
    """Raw sample bytes -> ("int"|"float", sample array); trailing
    partial samples are dropped (hound tolerance, noaa_apt.rs:114-130).
    ``data`` is ``bytes`` or a uint8 array; where numpy can view the
    samples as they lie, the result is a view of it, so a map of the data
    chunk stays an ``np.memmap``."""
    if audio_fmt not in (_FMT_PCM, _FMT_FLOAT):
        raise err.WavOpenError(f"Unsupported WAV format tag: {audio_fmt}")
    sample_format = "int" if audio_fmt == _FMT_PCM else "float"
    raw = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    dtype = _VIEWS.get((audio_fmt, bits))
    if dtype is not None:
        arr = raw[: len(raw) // (bits // 8) * (bits // 8)].view(dtype)
    elif (audio_fmt, bits) == (_FMT_PCM, 8):
        # 8-bit WAV is unsigned with 128 offset; hound exposes it as
        # a signed value centered at 0.
        arr = raw.astype(np.int16) - 128
    elif (audio_fmt, bits) == (_FMT_PCM, 24):
        b = raw[: len(raw) // 3 * 3].reshape(-1, 3).astype(np.int32)
        arr = ((b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) << 8) >> 8  # sign-extend
    else:
        raise err.WavOpenError(f"Unsupported {'PCM' if sample_format == 'int' else 'float'} bit depth: {bits}")
    return sample_format, arr


def _parse_fmt(body: bytes) -> tuple[int, WavSpec]:
    """A fmt chunk's body (16 bytes or more) -> (format tag, or the
    EXTENSIBLE sub-format where it has one; spec)."""
    (audio_fmt, channels, sample_rate, _brate, _align, bits) = struct.unpack_from("<HHIIHH", body, 0)
    if audio_fmt == _FMT_EXTENSIBLE and len(body) >= 26:
        (audio_fmt,) = struct.unpack_from("<H", body, 24)
    return audio_fmt, WavSpec(channels, sample_rate, bits, "float" if audio_fmt == _FMT_FLOAT else "int")


def _walk(f, path: Path) -> tuple[int, WavSpec, int, int]:
    """The RIFF chunk walk over the open file ``f``, reading only chunk
    headers and the fmt chunk: ``(format tag, spec, data chunk offset,
    data bytes)``.  The last fmt and the last data chunk win, and a data
    size lying past EOF is clamped to what exists."""
    size_total = os.fstat(f.fileno()).st_size
    head = f.read(12)
    if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise err.WavOpenError(f"{path} is not a RIFF/WAVE file")
    fmt = data = None
    off = 12
    while off + 8 <= size_total:
        f.seek(off)
        cid, size = struct.unpack("<4sI", f.read(8))
        if cid == b"fmt ":
            fmt = f.read(min(size, 26))
        elif cid == b"data":
            # Tolerate truncated files whose header claims more data
            # than exists (the hound issue worked around at
            # noaa_apt.rs:114-130): take what is actually present.
            data = (off + 8, min(size, size_total - off - 8))
        off += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise err.WavOpenError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        # A truncated fmt chunk would otherwise escape as a raw
        # struct.error instead of the documented open error.
        raise err.WavOpenError(f"{path}: fmt chunk too short ({len(fmt)} bytes)")
    return (*_parse_fmt(fmt), *data)


def _load(path, raw_int16: bool, use_mmap: bool) -> tuple[np.ndarray, WavSpec]:
    """Both loaders' pipeline.  Under the span ``apt.wav.read``: the chunk
    walk, then the data chunk, mapped read-only (``use_mmap``, for 16-bit
    PCM and 32-bit float) or read.  Under ``apt.wav.convert``:
    :func:`_decode_pcm`, channel 0, and a float32 copy, but for 16-bit PCM
    with ``raw_int16`` and for a map, which stay views."""
    path = Path(path)
    try:
        with span("apt.wav.read"), open(path, "rb") as f:
            audio_fmt, spec, offset, n_bytes = _walk(f, path)
            data = None
            if (use_mmap and (audio_fmt, spec.bits_per_sample) in _MAPPED and spec.sample_rate > 0
                    and n_bytes >= spec.channels * spec.bits_per_sample // 8 > 0):
                try:
                    data = np.memmap(f, np.uint8, mode="r", offset=offset, shape=(n_bytes,))
                except (OSError, ValueError):
                    pass  # read below
            if data is None:
                f.seek(offset)
                data = f.read(n_bytes)
    except OSError as e:
        raise err.WavOpenError(str(e)) from e
    with span("apt.wav.convert"):
        sample_format, arr = _decode_pcm(data, audio_fmt, spec.bits_per_sample)
        if spec.channels < 1:
            raise err.WavOpenError("WAV has zero channels")
        arr = arr[: len(arr) // spec.channels * spec.channels : spec.channels]
        if not (raw_int16 and sample_format == "int" and spec.bits_per_sample == 16):
            arr = arr.astype(np.float32, copy=not isinstance(data, np.memmap))
    if spec.channels != 1:
        log.warning(
            "WAV file has %d channels (probably stereo), processing only the first one",
            spec.channels,
        )
    return arr, spec


def load_wav(path, raw_int16: bool = False) -> tuple[np.ndarray, WavSpec]:
    """Load a WAV file; returns (float32 channel-0 samples, spec).

    ``raw_int16``: return 16-bit PCM as the raw int16 buffer (values
    identical after the usual exact f32 conversion).  The chunk walk and
    the read of the data chunk are the span ``apt.wav.read``; the decode,
    the channel-0 take and the float32 copy are ``apt.wav.convert``."""
    return _load(path, raw_int16, use_mmap=False)


def write_wav(path, signal: np.ndarray, spec: WavSpec) -> None:
    """Write a normalized signal (reference ``wav.rs:62-98``)."""
    signal = np.asarray(signal, dtype=np.float32)
    if signal.size == 0:
        raise err.InternalError("Can't get maximum of a zero length vector")
    mx = np.float32(signal.max())  # signed max, as the reference

    if spec.bits_per_sample == 32 and spec.sample_format == "float":
        out = (signal / mx).astype("<f4").tobytes()
        fmt_tag = _FMT_FLOAT
    elif spec.bits_per_sample == 16 and spec.sample_format == "int":
        scaled = (signal / mx * np.float32(np.iinfo(np.int16).max)).astype(np.float32)
        # Rust `as i16` saturates; match that.
        out = np.clip(np.trunc(scaled), -32768, 32767).astype("<i2").tobytes()
        fmt_tag = _FMT_PCM
    else:
        raise err.InternalError(f"Can't write WAV with spec {spec}")

    channels = 1
    byte_rate = spec.sample_rate * channels * spec.bits_per_sample // 8
    block_align = channels * spec.bits_per_sample // 8
    hdr = b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + len(out)),
            b"WAVE",
            b"fmt ",
            struct.pack(
                "<IHHIIHH",
                16,
                fmt_tag,
                channels,
                spec.sample_rate,
                byte_rate,
                block_align,
                spec.bits_per_sample,
            ),
            b"data",
            struct.pack("<I", len(out)),
        ]
    )
    Path(path).write_bytes(hdr + out)


def load(path) -> tuple[np.ndarray, Rate]:
    """Reference ``noaa_apt::load`` (``noaa_apt.rs:114-130``)."""
    signal, spec = load_wav(path)
    return signal, Rate(spec.sample_rate)


class PcmStreamReader:
    """Incremental PCM source for live decoding (``cli --stream``).

    Wraps a binary file object (stdin, a pipe, a growing file) holding
    either a WAV byte stream — the header is parsed up front, with the
    same format support and truncation tolerance as :func:`load_wav` —
    or headerless raw PCM, for which ``rate`` (Hz) and ``fmt``
    (``"s16"`` little-endian i16, or ``"f32"``) must describe the
    bytes.  ``fmt="auto"`` sniffs the first 12 bytes: RIFF/WAVE means
    WAV, anything else raw PCM of format ``raw_fmt`` (requiring
    ``rate``).

    ``read(max_frames)`` returns the next float32 mono chunk at the
    same scale as :func:`load_wav` (raw integer scale for int formats),
    keeping channel 0 of multichannel data; ``None`` signals EOF.

    Data-chunk size semantics: a real declared size is honored (so
    trailing LIST/INFO/id3 metadata chunks are not decoded as audio,
    matching the offline loader), but the live-source placeholders
    0, 0xFFFFFFFF and 0x7FFFFFFE mean "unknown" and data is read until
    the stream ends; a stream that ends early is truncation-tolerated
    either way.  Unlike :func:`load_wav` (which scans the whole file,
    last fmt/data chunk winning), a stream cannot seek: the FIRST data
    chunk is decoded and ``fmt`` must precede it.
    """

    def __init__(
        self, fileobj, rate: int | None = None, fmt: str = "auto", raw_fmt: str = "s16"
    ):
        self._f = fileobj
        self._buf = b""
        self._eof = False
        self._data_left = None  # bytes left of a declared data chunk
        if fmt not in ("auto", "s16", "f32"):
            raise err.InvalidInputError(f"stream format must be s16 or f32, got {fmt!r}")
        if raw_fmt not in ("s16", "f32"):
            raise err.InvalidInputError(
                f"stream format must be s16 or f32, got {raw_fmt!r}"
            )

        head = b""
        if fmt == "auto":
            head = self._read_exact(12)
            if len(head) >= 12 and head[0:4] == b"RIFF" and head[8:12] == b"WAVE":
                self._init_wav()
                return
            # Not a WAV: the sniffed bytes are raw PCM payload.
            self._buf = head + self._buf
            fmt = raw_fmt
        if rate is None:
            raise err.InvalidInputError(
                "raw PCM stream needs an explicit sample rate (--stream-rate)"
            )
        self._audio_fmt = _FMT_PCM if fmt == "s16" else _FMT_FLOAT
        self.spec = WavSpec(1, int(rate), 16 if fmt == "s16" else 32, "int" if fmt == "s16" else "float")

    def _read_exact(self, n: int) -> bytes:
        """Up to n bytes, short only at EOF (pipes may return less per read)."""
        out = b""
        while len(out) < n and not self._eof:
            b = self._f.read(n - len(out))
            if not b:
                self._eof = True
                break
            out += b
        return out

    def _init_wav(self) -> None:
        fmt_body = None
        while True:
            hdr = self._read_exact(8)
            if len(hdr) < 8:
                raise err.WavOpenError("stream ended before a WAV data chunk")
            cid = hdr[0:4]
            (size,) = struct.unpack_from("<I", hdr, 4)
            if cid == b"data":
                # Honor the declared size so trailing metadata chunks
                # (LIST/INFO, id3) are not decoded as audio — EXCEPT
                # the live-source placeholders (0, 0xFFFFFFFF, and the
                # streaming-RIFF 0x7FFFFFFE convention), which mean
                # "unknown: read to end of stream".
                self._data_left = (
                    None if size in (0, 0xFFFFFFFF, 0x7FFFFFFE) else size
                )
                break
            body = self._read_exact(size + (size & 1))
            if cid == b"fmt ":
                fmt_body = body[:size]
        if fmt_body is None or len(fmt_body) < 16:
            raise err.WavOpenError("WAV stream: missing or short fmt chunk before data")
        self._audio_fmt, self.spec = _parse_fmt(fmt_body)
        if self.spec.channels < 1:
            raise err.WavOpenError("WAV has zero channels")
        if self.spec.channels != 1:
            log.warning(
                "WAV stream has %d channels (probably stereo), processing only the first one",
                self.spec.channels,
            )
        # Validate format support now, not at the first read.
        _decode_pcm(b"", self._audio_fmt, self.spec.bits_per_sample)

    @property
    def sample_rate(self) -> int:
        return self.spec.sample_rate

    def read(self, max_frames: int) -> np.ndarray | None:
        """Next float32 chunk of up to ``max_frames`` mono frames;
        ``None`` at end of stream (or of the declared data chunk)."""
        channels, bits = self.spec.channels, self.spec.bits_per_sample
        frame_bytes = channels * (bits // 8)
        want = max_frames * frame_bytes
        if self._data_left is not None:
            want = min(want, self._data_left + len(self._buf))
        if len(self._buf) < want and not self._eof:
            got = self._read_exact(want - len(self._buf))
            if self._data_left is not None:
                self._data_left -= len(got)
            self._buf += got
        n_frames = len(self._buf) // frame_bytes
        if n_frames == 0:
            # Anything left is a partial frame — dropped, like load_wav.
            return None
        take, self._buf = (
            self._buf[: n_frames * frame_bytes],
            self._buf[n_frames * frame_bytes :],
        )
        _, arr = _decode_pcm(take, self._audio_fmt, bits)
        if channels != 1:
            arr = arr[::channels]
        return arr.astype(np.float32)


def load_device_ready(path, use_mmap: bool = True) -> tuple[np.ndarray, Rate]:
    """Like :func:`load`, but 16-bit PCM stays int16 so the decoder can
    ship half the bytes to the card and convert there (exactly equal to
    the reference's f32-of-raw-int values; the resample kernel reads
    i16 directly).  With ``use_mmap`` (the default) a 16-bit PCM or
    32-bit float file, of any channel count, is not read here: the
    returned array is channel 0 of a read-only ``np.memmap`` over its
    data chunk (strided for more than one channel), and the one host copy
    of its samples is the decoder's.  Other formats, and every file
    without ``use_mmap``, are read into RAM as :func:`load_wav` reads
    them (``noaa_apt_tpu/io/wav.py:382-402``)."""
    signal, spec = _load(path, True, use_mmap)
    return signal, Rate(spec.sample_rate)
