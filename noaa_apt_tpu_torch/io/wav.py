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
``wave`` module cannot read float WAVs).  A copy of
``noaa_apt_tpu/io/wav.py``, the live-stream reader (:class:`PcmStreamReader`,
``--stream``) included.
"""

from __future__ import annotations

import logging
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


def _decode_pcm(data: bytes, audio_fmt: int, bits: int) -> tuple[str, np.ndarray]:
    """Raw sample bytes -> ("int"|"float", sample array); trailing
    partial samples are dropped (hound tolerance, noaa_apt.rs:114-130)."""
    if audio_fmt == _FMT_PCM:
        sample_format = "int"
        if bits == 16:
            arr = np.frombuffer(data[: len(data) // 2 * 2], dtype="<i2")
        elif bits == 32:
            arr = np.frombuffer(data[: len(data) // 4 * 4], dtype="<i4")
        elif bits == 8:
            # 8-bit WAV is unsigned with 128 offset; hound exposes it as
            # a signed value centered at 0.
            arr = np.frombuffer(data, dtype=np.uint8).astype(np.int16) - 128
        elif bits == 24:
            b = np.frombuffer(data[: len(data) // 3 * 3], dtype=np.uint8).reshape(-1, 3)
            arr = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            arr = (arr << 8) >> 8  # sign-extend
        else:
            raise err.WavOpenError(f"Unsupported PCM bit depth: {bits}")
    elif audio_fmt == _FMT_FLOAT:
        sample_format = "float"
        if bits == 32:
            arr = np.frombuffer(data[: len(data) // 4 * 4], dtype="<f4")
        elif bits == 64:
            arr = np.frombuffer(data[: len(data) // 8 * 8], dtype="<f8")
        else:
            raise err.WavOpenError(f"Unsupported float bit depth: {bits}")
    else:
        raise err.WavOpenError(f"Unsupported WAV format tag: {audio_fmt}")
    return sample_format, arr


def load_wav(path, raw_int16: bool = False, info: dict | None = None) -> tuple[np.ndarray, WavSpec]:
    """Load a WAV file; returns (float32 channel-0 samples, spec).

    ``raw_int16``: return mono 16-bit PCM as the raw int16 buffer
    (values identical after the usual exact f32 conversion).  ``info``,
    if given, receives the file's counters (:func:`_counters`).  The
    file's read is the span ``apt.wav.read``; the chunk walk, the
    channel-0 take and the float32 copy are ``apt.wav.convert``."""
    path = Path(path)
    try:
        with span("apt.wav.read"):
            raw = path.read_bytes()
    except OSError as e:
        raise err.WavOpenError(str(e)) from e
    with span("apt.wav.convert"):
        signal, spec = _parse_wav(path, raw, raw_int16)
    if info is not None:
        info.update(_counters(len(raw), spec))
    return signal, spec


COUNTERS = ("wav_bytes", "wav_channels", "wav_bits", "wav_format", "wav_mapped")


def _counters(n_bytes: int, spec: WavSpec) -> dict:
    """The counters of a loaded WAV that the CLI's report carries
    (``COUNTERS``), but ``wav_mapped``, which :func:`load_device_ready`
    sets."""
    return {"wav_bytes": n_bytes, "wav_channels": spec.channels, "wav_bits": spec.bits_per_sample,
            "wav_format": spec.sample_format}


def _parse_wav(path: Path, raw: bytes, raw_int16: bool) -> tuple[np.ndarray, WavSpec]:
    """:func:`load_wav` on the file's bytes ``raw``."""
    if len(raw) < 12 or raw[0:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise err.WavOpenError(f"{path} is not a RIFF/WAVE file")

    fmt = None
    data = None
    off = 12
    while off + 8 <= len(raw):
        cid = raw[off : off + 4]
        (size,) = struct.unpack_from("<I", raw, off + 4)
        body = raw[off + 8 : off + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            # Tolerate truncated files whose header claims more data
            # than exists (the hound issue worked around at
            # noaa_apt.rs:114-130): take what is actually present.
            data = raw[off + 8 : off + 8 + size] if off + 8 + size <= len(raw) else raw[off + 8 :]
        off += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise err.WavOpenError(f"{path}: missing fmt/data chunk")
    if len(fmt) < 16:
        # A truncated fmt chunk would otherwise escape as a raw
        # struct.error instead of the documented open error.
        raise err.WavOpenError(f"{path}: fmt chunk too short ({len(fmt)} bytes)")

    (audio_fmt, channels, sample_rate, _brate, _align, bits) = struct.unpack_from(
        "<HHIIHH", fmt, 0
    )
    if audio_fmt == _FMT_EXTENSIBLE and len(fmt) >= 26:
        (audio_fmt,) = struct.unpack_from("<H", fmt, 24)

    sample_format, arr = _decode_pcm(data, audio_fmt, bits)

    if channels < 1:
        raise err.WavOpenError("WAV has zero channels")
    if channels != 1:
        log.warning(
            "WAV file has %d channels (probably stereo), processing only the first one",
            channels,
        )
        arr = arr[: len(arr) // channels * channels : channels]

    spec = WavSpec(channels, sample_rate, bits, sample_format)
    if raw_int16 and arr.dtype == np.int16 and sample_format == "int" and bits == 16:
        return arr, spec
    return arr.astype(np.float32), spec


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
        self._bits = 16 if fmt == "s16" else 32
        self._channels = 1
        self.spec = WavSpec(1, int(rate), self._bits, "int" if fmt == "s16" else "float")

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
        (audio_fmt, channels, sample_rate, _br, _ba, bits) = struct.unpack_from(
            "<HHIIHH", fmt_body, 0
        )
        if audio_fmt == _FMT_EXTENSIBLE and len(fmt_body) >= 26:
            (audio_fmt,) = struct.unpack_from("<H", fmt_body, 24)
        if channels < 1:
            raise err.WavOpenError("WAV has zero channels")
        if channels != 1:
            log.warning(
                "WAV stream has %d channels (probably stereo), processing only the first one",
                channels,
            )
        # Validate format support now, not at the first read.
        _decode_pcm(b"", audio_fmt, bits)
        self._audio_fmt, self._bits, self._channels = audio_fmt, bits, channels
        self.spec = WavSpec(
            channels, sample_rate, bits,
            "float" if audio_fmt == _FMT_FLOAT else "int",
        )

    @property
    def sample_rate(self) -> int:
        return self.spec.sample_rate

    def read(self, max_frames: int) -> np.ndarray | None:
        """Next float32 chunk of up to ``max_frames`` mono frames;
        ``None`` at end of stream (or of the declared data chunk)."""
        frame_bytes = self._channels * (self._bits // 8)
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
        _, arr = _decode_pcm(take, self._audio_fmt, self._bits)
        if self._channels != 1:
            arr = arr[:: self._channels]
        return arr.astype(np.float32)


# (format tag, bits) -> the dtype numpy can view the samples as, where they lie.
_VIEWABLE = {(_FMT_PCM, 16): "<i2", (_FMT_FLOAT, 32): "<f4"}


def _viewable_data(path) -> tuple[str, int, int, WavSpec, int] | None:
    """The header walk of :func:`load_device_ready`'s map, reading only the
    chunk headers: ``(dtype, data chunk offset, whole frames, spec, file
    size)`` of a WAV whose samples numpy can view as they lie (16-bit PCM
    or 32-bit IEEE float, by format tag or EXTENSIBLE sub-format, one
    channel or more).  None where the file needs the general loader
    (other formats, no whole frame, malformed headers).  Chunk semantics
    match :func:`load_wav`: last fmt/data chunk wins, a data size lying
    past EOF is clamped to what exists, and a trailing partial frame is
    dropped."""
    path = Path(path)
    try:
        size_total = path.stat().st_size
        with open(path, "rb") as f:
            head = f.read(12)
            if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
                return None
            fmt_body = None
            data_span = None
            off = 12
            while off + 8 <= size_total:
                f.seek(off)
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid = hdr[0:4]
                (sz,) = struct.unpack_from("<I", hdr, 4)
                if cid == b"fmt ":
                    fmt_body = f.read(min(sz, 64))
                elif cid == b"data":
                    data_span = (off + 8, min(sz, size_total - off - 8))
                off += 8 + sz + (sz & 1)
    except OSError:
        return None
    if fmt_body is None or data_span is None or len(fmt_body) < 16:
        return None
    (audio_fmt, channels, sample_rate, _br, _al, bits) = struct.unpack_from(
        "<HHIIHH", fmt_body, 0
    )
    if audio_fmt == _FMT_EXTENSIBLE and len(fmt_body) >= 26:
        (audio_fmt,) = struct.unpack_from("<H", fmt_body, 24)
    dtype = _VIEWABLE.get((audio_fmt, bits))
    if dtype is None or channels < 1 or sample_rate <= 0:
        return None
    o, n_bytes = data_span
    frames = n_bytes // (channels * bits // 8)
    if frames == 0:
        return None
    spec = WavSpec(channels, sample_rate, bits, "int" if audio_fmt == _FMT_PCM else "float")
    return dtype, o, frames, spec, size_total


def _map_channel0(path, dtype: str, offset: int, frames: int, channels: int) -> np.ndarray:
    """Channel 0 of the data chunk as a read-only ``np.memmap``: the map
    itself for mono 16-bit PCM, else column 0 of the ``(frames,
    channels)`` map (strided for more than one channel).  A float file's
    or a multichannel file's map is the span
    ``apt.wav.read`` and its channel-0 view ``apt.wav.convert``; a mono
    16-bit map enters no span."""
    if channels == 1 and dtype == "<i2":
        return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=(frames,))
    with span("apt.wav.read"):
        m = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=(frames, channels))
    with span("apt.wav.convert"):
        return m[:, 0]


def load_device_ready(path, use_mmap: bool = True, info: dict | None = None) -> tuple[np.ndarray, Rate]:
    """Like :func:`load`, but 16-bit PCM stays int16 so the decoder can
    ship half the bytes to the card and convert there (exactly equal to
    the reference's f32-of-raw-int values; the resample kernel reads
    i16 directly).  With ``use_mmap`` (the default) a 16-bit PCM or
    32-bit float file, of any channel count, is not read here: the
    returned array is channel 0 of a read-only ``np.memmap`` over its
    data chunk (strided for more than one channel), and the one host copy
    of its samples is the decoder's.  Other formats, and every file
    without ``use_mmap``, are read into RAM by :func:`load_wav`, and any
    16-bit integer WAV still comes back as int16
    (``noaa_apt_tpu/io/wav.py:382-402``).  ``info``, if given, receives
    the file's counters: its size, channels, bits and sample format
    (from the map's header, or :func:`load_wav`'s spec), and
    ``wav_mapped``, whether the samples are a view of the map."""
    if use_mmap:
        v = _viewable_data(path)
        if v is not None:
            dtype, offset, frames, spec, n_bytes = v
            try:
                arr = _map_channel0(path, dtype, offset, frames, spec.channels)
            except (OSError, ValueError):
                pass  # the general loader reads the file, or raises its own error
            else:
                if spec.channels != 1:
                    log.warning(
                        "WAV file has %d channels (probably stereo), processing only the first one",
                        spec.channels,
                    )
                if info is not None:
                    info.update(_counters(n_bytes, spec), wav_mapped=True)
                return arr, Rate(spec.sample_rate)
    signal, spec = load_wav(path, raw_int16=True, info=info)
    if info is not None:
        info["wav_mapped"] = False
    if signal.dtype != np.int16 and spec.sample_format == "int" and spec.bits_per_sample == 16:
        signal = signal.astype(np.int16)  # exact: values are in i16 range
    return signal, Rate(spec.sample_rate)
