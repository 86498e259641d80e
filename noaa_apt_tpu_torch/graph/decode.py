"""The eager decode pipeline on one device.

Behavioral contract: reference ``src/decode.rs:43-162`` (``decode()``),
as ported by ``noaa_apt_tpu/graph/decode.py``.  Stage order and every
numeric parameter match; the execution model differs: PyTorch runs
eagerly, so there are no length buckets and no jit variants.  Each
stage runs on the true length, which gives the same values below the
true length as the JAX package's zero-padded graph (every stage is
causal or windowed, and zero padding is the reference's out-of-range
skip).

The hot path of :meth:`Decoder.decode_render_input` on the card:

1. the raw i16 (or f32) recording is uploaded as-is;
2. kernel K1 (``ops/resample.py``) resamples it to the work rate (at a
   rate that is a multiple of the work rate, l == 1, K1 runs the causal
   FIR decimated by m: ``ops/resample.causal_tables``);
3. kernel K2 (``ops/stage.py``) demodulates, filters and correlates;
4. kernel K3 (``ops/select.py``) selects the sync peaks; its one fetch
   (k, the overflow flag and the peak list, a few KB) is the first;
5. row compaction, the row gather with the work->4160 Hz decimation,
   the percent buckets and the u8 map are plain torch ops; the u8 image
   is the second fetch.  Telemetry contrast fetches the per-row band
   statistics (``[3, rows]`` floats) in between, and runs the wedge math
   on the host while the f32 image stays on the card.

The host-ingest modes (``Decoder(ingest="host"|"host16"|"host16c"|"host8")``,
``noaa_apt_tpu/graph/decode.py:577-745``) resample on the host in C++
(``native/``) and ship a work-rate payload instead of the raw recording:
f32 (``host``), i16 or i8 plus a scale (``host16``, ``host8``), or the
lossless codec's sealed buffer (``host16c``), which kernel K4
(``ops/pack.py``) decodes on the card.  :meth:`Decoder.decode_render`
then dequantizes (two torch ops) and runs K2, K3 and the tail as above;
K1 does not run.  The batched renders run K1 (or K4) and K2 per member
and K3 once over the members' rows.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field, fields
from typing import Optional

import numpy as np
import torch

from .. import CARRIER_FREQ, FINAL_RATE, PX_PER_ROW, err
from ..core import Lowpass, LowpassDcRemoval
from ..core.frequency import Freq, Rate
from ..core.profiles import DecodeProfile
from ..device import resolve_device
from ..ops import demod as dm
from ..ops import pack as pk
from ..ops import resample as rs
from ..ops import sync as sy
from ..ops.pack import unpack_sealed
from ..ops.resample import polyphase_resample
from ..ops.select import select_peaks
from ..ops.stage import demod_fir_corr
from ..post.telemetry import telemetry_from_stats
from ..spans import span

log = logging.getLogger(__name__)

_TOO_SHORT = "Got less than 10 rows of samples, audio file is too short"
HOST_INGEST = ("host", "host16", "host16c", "host8")


def pad_bucket(n: int, shift: int = 3) -> int:
    """Round ``n`` up to a coarse geometric bucket
    (``noaa_apt_tpu/graph/decode.py:41-47``): the length of an uploaded
    work payload, which the batched render groups by."""
    if n <= 0:
        return 1
    g = max(1, 1 << max(0, n.bit_length() - 1 - shift))
    return -(-n // g) * g


def _ingest_filter(profile: DecodeProfile, input_rate: Rate) -> LowpassDcRemoval:
    """The stage-1 DC-removal lowpass of ``profile`` at ``input_rate``
    (``decode.rs:65-77``): the one design every ingest path (K1's tables,
    the host C++ resample) agrees on."""
    return LowpassDcRemoval(
        cutout=Freq.hz(profile.resample_cutout, input_rate),
        atten=profile.resample_atten,
        delta_w=Freq.hz(profile.resample_delta_freq, input_rate),
    )


def _chain_design(profile: DecodeProfile):
    """``(taps, template, cosphi2, sinphi)`` of the work-rate chain: the
    post-demod lowpass, the +-1 sync frame and the demod constants
    (``Decoder._chain_params``, ``noaa_apt_tpu/graph/decode.py:533-545``)."""
    work = Rate(profile.work_rate)
    carrier = Freq.hz(float(CARRIER_FREQ), work)
    cutout = Freq.from_pi_rad(np.float32(FINAL_RATE) / np.float32(work.get_hz()))
    taps = Lowpass(cutout=cutout, atten=profile.demodulation_atten, delta_w=cutout / 5.0).design()
    cosphi2, sinphi = dm.demod_constants(carrier)
    return taps, sy.generate_sync_frame(work), cosphi2, sinphi


@dataclass
class WorkPayload:
    """A work-rate signal prepared on the host (:meth:`Decoder.prepare_work`,
    ``noaa_apt_tpu/graph/decode.py:91-104``).

    ``data``: a numpy array of ``work_true`` samples, or a torch tensor
    already on the device, padded to ``pad_bucket(work_true)``.
    ``inv_scale`` set => an i16 (or i8) payload whose f32 values are
    ``data * inv_scale``."""

    data: object
    work_true: int
    inv_scale: Optional[float] = None


@dataclass
class PackedWorkPayload:
    """The lossless codec's payload (``ingest="host16c"``,
    ``noaa_apt_tpu/graph/decode.py:107-127``): ``buf`` is the sealed
    buffer (``ops/pack.seal_packed``), an int32 torch tensor on the device
    (or a u32/int32 numpy array), of ``nb = pad_bucket(work_true) / 128``
    blocks; kernel K4 decodes it back to the bit-identical i16 work
    signal, so every result equals the ``host16`` payload's."""

    buf: object
    nb: int
    w_lo: int
    n_esc_pad: int
    work_true: int
    inv_scale: float
    coeff: int


def _i8_ingest_snr_estimate(signal) -> "float | None":
    """Predicted SNR (dB) of i8 work-signal quantization for this
    recording, from input AC statistics (``noaa_apt_tpu/graph/decode.py:219-255``).

    i8 quantization noise is ``step/sqrt(12)`` with ``step = peak/127``,
    so ``SNR ~= 20*log10(ac_rms/ac_peak * 127 * sqrt(12))``: about
    44.5 dB for a sine-crest signal, far less for spiky or near-silent
    recordings.  DC is removed from both rms and peak (the work signal is
    DC-free by construction).  Returns None when no estimate is possible
    (callers then keep i8)."""
    try:
        x = np.asarray(signal)
        if x.size > 4_000_000:
            # Statistics, not exactness: an 8x stride keeps >3.5M samples
            # of a 10-minute pass and skips a ~115 MB f32 copy.
            x = x[::8]
        x = np.asarray(x, np.float32)
    except (TypeError, ValueError):  # estimation is best-effort
        return None
    if x.size == 0:
        return None
    mean = float(x.mean(dtype=np.float64))
    rms2 = float(np.mean(np.square(x), dtype=np.float64))
    ac2 = max(rms2 - mean * mean, 0.0)
    peak = float(np.max(np.abs(x - np.float32(mean))))
    if peak <= 0.0 or ac2 <= 0.0:
        return 0.0  # silent/constant recording: force the i16 path
    return float(20.0 * np.log10(np.sqrt(ac2) / peak * 127.0 * np.sqrt(12.0)))


def _splice_errors(results: list, errors) -> list:
    """Merge a batch's member results with its pre-decode per-member
    errors (keyed by the ORIGINAL batch index) back into input order."""
    if not errors:
        return results
    total = len(results) + len(errors)
    it = iter(results)
    return [errors[b] if b in errors else next(it) for b in range(total)]


def _dtype_name(data) -> str:
    """numpy's name of a payload's dtype (``int16``), for a torch tensor too."""
    if isinstance(data, torch.Tensor):
        return str(data.dtype).removeprefix("torch.")
    return str(np.asarray(data).dtype)


def _plan_resample_with_filter(input_rate: Rate, output_rate: Rate, filt):
    """``(l, m, coeff)`` of ``dsp::resample_with_filter``
    (``dsp.rs:62-126``): for l == 1 the filter is designed at the input
    rate (``noaa_apt_tpu/graph/decode.py:82-88``), else at the
    interpolated rate."""
    if output_rate.get_hz() == 0:
        raise err.InternalError("Can't resample to 0Hz")
    g = math.gcd(input_rate.get_hz(), output_rate.get_hz())
    l = output_rate.get_hz() // g
    m = input_rate.get_hz() // g
    if l == 1:
        return l, m, filt.design()
    interpolated = input_rate.checked_mul(l)
    if interpolated is None:
        raise err.RateOverflowError(
            "Can't resample, looks like the sample rates do not have a big "
            f"divisor in common. input_rate: {input_rate.get_hz()}, "
            f"output_rate: {output_rate.get_hz()}, l: {l}, m: {m}"
        )
    return l, m, filt.resample(input_rate, interpolated).design()


@dataclass(frozen=True, eq=False)
class DecodeTables:
    """The designed tables of one (profile, input rate): everything the
    decode path multiplies by.  This system has no learned weights;
    these are its parameters.

    - ``bank[l, T]``, ``p_c[l]``, ``s_c[l]``, ``offset``: the ingest
      polyphase filter bank (``noaa_apt_tpu/ops/resample.py:294-311``);
      at l == 1, the decimation path's tables instead
      (``ops/resample.causal_tables``: a causal FIR decimated by m over
      ``causal_input``, ``offset`` unused);
    - ``taps[k]``: the post-demod lowpass, ``template[g]``: the +-1 sync
      frame (``Decoder._chain_params``, ``graph/decode.py:533-545``);
    - ``cosphi2``, ``sinphi``: the demod constants (``ops/demod.py:29-34``).
    """

    input_rate: int
    work_rate: int
    l: int
    m: int
    offset: int
    p_c: np.ndarray  # int32[l]
    s_c: np.ndarray  # int32[l]
    bank: np.ndarray  # float32[l, T]
    taps: np.ndarray  # float32[k]
    template: np.ndarray  # int8[g]
    cosphi2: np.float32
    sinphi: np.float32

    @classmethod
    def design(cls, profile: DecodeProfile, input_rate: Rate) -> "DecodeTables":
        """Design every table on the host from the port's own filter code."""
        work = Rate(profile.work_rate)
        l, m, coeff = _plan_resample_with_filter(input_rate, work, _ingest_filter(profile, input_rate))
        if l == 1:
            (p_c, s_c, bank), offset = rs.causal_tables(coeff), 0
        else:
            p_c, s_c, bank, _, offset = rs.phase_tables(rs.resample_plan(0, l, m, coeff))
        taps, template, cosphi2, sinphi = _chain_design(profile)
        return cls.from_numpy(
            input_rate=input_rate.get_hz(), work_rate=work.get_hz(), l=l, m=m, offset=offset,
            p_c=p_c, s_c=s_c, bank=bank, taps=taps, template=template, cosphi2=cosphi2,
            sinphi=sinphi,
        )

    @classmethod
    def from_numpy(cls, *, input_rate: int, work_rate: int, l: int, m: int, offset: int,
                   p_c, s_c, bank, taps, template, cosphi2, sinphi) -> "DecodeTables":
        """Tables from numpy arrays, e.g. the JAX package's own
        (``rs._phase_tables``, or ``ops/resample.causal_tables`` of its
        l == 1 ``coeff``; ``Decoder._chain_params``,
        ``dm.demod_constants``), so a test can run both packages on
        identical taps."""
        arrays = {
            name: np.ascontiguousarray(np.asarray(v, dtype))
            for name, v, dtype in (
                ("p_c", p_c, np.int32), ("s_c", s_c, np.int32), ("bank", bank, np.float32),
                ("taps", taps, np.float32), ("template", template, np.int8),
            )
        }
        if arrays["bank"].ndim != 2 or arrays["bank"].shape[0] != l:
            raise ValueError(f"bank must be [l={l}, T], got {arrays['bank'].shape}")
        if arrays["p_c"].shape != (l,) or arrays["s_c"].shape != (l,):
            raise ValueError(f"p_c and s_c must have l={l} entries")
        # Kernel K1 indexes the bank by p_c and the input by s_c unchecked.
        if (arrays["p_c"] < 0).any() or (arrays["p_c"] >= l).any() or (arrays["s_c"] < 0).any():
            raise ValueError(f"p_c must lie in [0, {l}) and s_c must be >= 0")
        if l == 1 and arrays["s_c"][0] != 0:
            raise ValueError("l = 1 (decimation) tables need s_c = [0]")
        return cls(
            input_rate=int(input_rate), work_rate=int(work_rate), l=int(l), m=int(m),
            offset=int(offset), cosphi2=np.float32(cosphi2), sinphi=np.float32(sinphi), **arrays,
        )

    def as_numpy(self) -> dict:
        """The keyword arguments of :meth:`from_numpy`."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def work_len(self, n_true: int) -> int:
        """True work-rate length of an ``n_true``-sample recording."""
        if self.l == 1:
            return n_true // self.m  # decimate (dsp.rs:294-307)
        return rs.out_len_for(n_true, self.l, self.m, self.offset)


@dataclass
class _DeviceTables:
    """K1's tables of one input rate, on the device."""

    tables: DecodeTables
    bank: torch.Tensor
    p_c: torch.Tensor
    s_c: torch.Tensor


@dataclass
class _DeviceChain:
    """K2's tables (work rate only), on the device."""

    taps: torch.Tensor
    template: torch.Tensor
    cosphi2: np.float32
    inv_sinphi: np.float32


class _StageClock:
    """Per-stage times of one decode: CUDA events on the card (read once
    the decode has fetched its result, so no extra synchronisation),
    the host clock on the CPU.

    ``others``: further cards the decode runs on.  Each mark then first
    makes ``device``'s stream wait for theirs, so that a stage ends when
    its work has ended on every card (the sharded decoder's)."""

    def __init__(self, device: torch.device, others=()):
        self.cuda = device.type == "cuda"
        self.device = device
        self.others = [d for d in dict.fromkeys(others) if d != device] if self.cuda else []
        self.marks: list = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            home = torch.cuda.current_stream(self.device)
            for d in self.others:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(d))
                home.wait_event(done)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(home)
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


@dataclass
class DecodeResult:
    """Raw decoded image rows (``decode.rs:43`` contract: one float
    sample per pixel at FINAL_RATE), resident on the decoder's device."""

    image: torch.Tensor  # [n_rows, PX_PER_ROW] float32
    n_rows: int
    sync_positions: Optional[list[int]]

    def image_np(self) -> np.ndarray:
        return self.image.cpu().numpy()

    def signal(self) -> np.ndarray:
        return self.image_np().reshape(-1)


def _check_sync_count(sync_pos: list) -> "err.AptError | None":
    """The decode guard shared by every render path (``decode.rs:112-118``)."""
    log.info("Found %d sync frames", len(sync_pos))
    if len(sync_pos) < 5:
        return err.InternalError(
            "Found less than 5 sync frames, audio file is too short or too noisy"
        )
    return None


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=like.device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True of a 1-D mask, or ``len(mask)`` if none."""
    none = torch.full((), mask.shape[0], dtype=torch.int64, device=mask.device)
    return torch.where(mask.any(), torch.argmax(mask.to(torch.uint8)), none)


def _percent_buckets(img: torch.Tensor, mn, rng, pct: float):
    """(low_b, high_b) of the reference's 1000-bucket scan
    (``misc.rs:151-174``): bucket counts by ``bincount`` and their
    running sum by ``cumsum`` are exact integers, so the first bucket
    whose f32 fraction passes each threshold is the sequential scan's
    (``noaa_apt_tpu/graph/decode.py:147``, ``_percent_bucket_search``).
    The ``elif`` (low and high never share a bucket) is the +1 step."""
    remainder = np.float32((np.float32(1.0) - np.float32(pct)) / np.float32(2.0))
    hi_thresh = np.float32(np.float32(1.0) - remainder)
    bidx = torch.trunc((img - mn) / rng * _f32(1000.0, img))
    bidx = torch.clamp(torch.nan_to_num(bidx, nan=0.0), 0, 999).to(torch.int64)
    counts = torch.bincount(bidx.reshape(-1), minlength=1000)
    n_px = _f32(img.numel(), img)
    frac = torch.cumsum(counts, 0).to(torch.float32) / n_px
    first1 = _first_true(frac > _f32(remainder, img))
    low_b = torch.where(first1 >= 1000, torch.zeros_like(first1), first1)
    first2 = _first_true(frac > _f32(hi_thresh, img))
    nxt = torch.where(first2 == low_b, torch.clamp(first2 + 1, max=999), first2)
    high_b = torch.where(first2 < 1000, nxt, torch.full_like(first2, 999))
    return low_b, high_b


def _telemetry_stats(img: torch.Tensor):
    """Per-row telemetry band means and pooled variance on the device
    (``telemetry.rs:147-170``): columns 994:1038 and 2034:2078, the
    counterpart of ``Decoder._telemetry_stats_body``
    (``noaa_apt_tpu/graph/decode.py:868-880``) -> ``[3, rows]`` f32."""
    a = img[:, 994 : 994 + 44]
    b = img[:, 2034 : 2034 + 44]
    mean_a = a.mean(dim=1)
    mean_b = b.mean(dim=1)
    variance = (((a - mean_a[:, None]) ** 2).sum(dim=1)
                + ((b - mean_b[:, None]) ** 2).sum(dim=1)) / _f32(88.0, img)
    return torch.stack([mean_a, mean_b, variance])


def _telemetry_levels(ma, mb, var) -> tuple[float, float]:
    """Host wedge math -> (low, high) contrast levels: wedge 9 / wedge 8
    averaged over both bands (``noaa_apt.rs:144-147``)."""
    tel = telemetry_from_stats(ma, mb, var)
    return tel.get_wedge_value(9, None), tel.get_wedge_value(8, None)


def _levels(img: torch.Tensor, kind: str, pct: float):
    """Device contrast levels (0-dim f32 tensors) of the valid rows:
    ``"minmax"`` or the reference's ``"percent"`` scan.  The bucket ->
    level step is ``scan_buckets``' f32 arithmetic (``misc.rs:170-173``)
    with two roundings, as ``_seq_mul_add`` pins in the JAX package: the
    quotient ``b/1000`` from a table of host-rounded values, then one
    multiply op and one add op."""
    mn, mx = img.min(), img.max()
    if kind == "minmax":
        return mn, mx
    if kind != "percent":
        raise err.InternalError(f"render_u8 does not handle contrast {kind!r}")
    rng = mx - mn
    low_b, high_b = _percent_buckets(img, mn, rng, pct)
    lut = torch.from_numpy(np.arange(1001, dtype=np.float32) / np.float32(1000.0)).to(img.device)
    low = lut[low_b] * rng
    low = low + mn
    high = lut[high_b] * rng
    high = high + mn
    return low, high


def _map_u8(img: torch.Tensor, low, high) -> torch.Tensor:
    """``map_signal_u8`` (``noaa_apt.rs:249-259``; round half-up): sub,
    div, mul, NaN -> 0 (a flat signal's 0/0), clamp, add 0.5, floor."""
    v = (img - low) / (high - low) * _f32(255.0, img)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    v = torch.clamp(v, 0.0, 255.0)
    return torch.floor(v + _f32(0.5, img)).to(torch.uint8)


def _grouped_fetch(tensors: list) -> list:
    """One device -> host copy for ``tensors`` (equal trailing shapes):
    concatenated along the first dim, fetched, split back."""
    if not tensors:
        return []
    with span("apt.wait.rows"):
        host = torch.cat(tensors).cpu().numpy()
    return np.split(host, np.cumsum([t.shape[0] for t in tensors])[:-1])


def _close_clock(pending) -> None:
    """A deferred render's last stage mark; its stage times go into its
    decoder's ``last_stage_ms`` (once)."""
    if pending.clock is not None:
        pending.clock.mark("fetch_image")
        pending.decoder.last_stage_ms = pending.clock.ms()
        pending.clock = None


@dataclass
class PendingRender:
    """A dispatched-but-not-fetched fused render
    (``noaa_apt_tpu/graph/decode.py:331-351``).  CUDA launches are
    asynchronous: the u8 image may still be computing.  Dispatch waited
    once, for K3's small result (k and the peaks); :meth:`get` is the image
    fetch, and raises the decode guard's error (fewer than 5 sync frames)."""

    u8: Optional[torch.Tensor]
    sync_pos: list
    error: Optional[err.AptError] = None
    clock: Optional[_StageClock] = field(default=None, repr=False)
    decoder: Optional["Decoder"] = field(default=None, repr=False)

    def get(self) -> tuple[np.ndarray, list[int]]:
        if self.error is not None:
            raise self.error
        with span("apt.wait.rows"):
            out = self.u8.cpu().numpy()
        _close_clock(self)
        return out, self.sync_pos


@dataclass
class PendingRenderTelemetry:
    """A dispatched telemetry-contrast render
    (``noaa_apt_tpu/graph/decode.py:412-438``): the f32 image stays on
    the device; :meth:`get` fetches its per-row band statistics
    (``[3, rows]`` floats), runs the wedge math on the host, maps the image
    with the wedge-9/wedge-8 levels and fetches the u8 rows."""

    img: Optional[torch.Tensor]
    stats: Optional[torch.Tensor]
    sync_pos: list
    error: Optional[err.AptError] = None
    clock: Optional[_StageClock] = field(default=None, repr=False)
    decoder: Optional["Decoder"] = field(default=None, repr=False)

    def get(self) -> tuple[np.ndarray, list[int]]:
        if self.error is not None:
            raise self.error
        with span("apt.wait.rows"):
            stats = self.stats.cpu().numpy()
        low, high = _telemetry_levels(*stats)
        if self.clock is not None:
            self.clock.mark("telemetry")  # row gather, band statistics, their fetch, wedge math
        u8 = _map_u8(self.img, _f32(low, self.img), _f32(high, self.img))
        if self.clock is not None:
            self.clock.mark("rows_levels_u8")
        with span("apt.wait.rows"):
            out = u8.cpu().numpy()
        _close_clock(self)
        return out, self.sync_pos


@dataclass
class PendingRenderBatch:
    """A dispatched batch of renders (``noaa_apt_tpu/graph/decode.py:300-328``).
    :meth:`get` is one grouped fetch of every member's u8 rows; each
    member's guard applies on its own, so a too-noisy member (or a
    too-short one, ``errors``) becomes an error entry and does not fail
    its batchmates."""

    members: list  # PendingRender of each decoded member, in input order
    errors: "dict[int, err.AptError] | None" = None  # pre-decode, by input index
    clock: Optional[_StageClock] = field(default=None, repr=False)
    decoder: Optional["Decoder"] = field(default=None, repr=False)

    def get(self) -> list:
        live = [m for m in self.members if m.error is None]
        it = iter(_grouped_fetch([m.u8 for m in live]))
        _close_clock(self)
        out = [m.error if m.error is not None else (next(it), m.sync_pos) for m in self.members]
        return _splice_errors(out, self.errors)


@dataclass
class PendingRenderTelemetryBatch:
    """Batched :class:`PendingRenderTelemetry`
    (``noaa_apt_tpu/graph/decode.py:354-409``): one grouped statistics
    fetch, the wedge math per member on the host, the u8 maps, one grouped
    image fetch.  A member with too few sync frames or too few rows for
    telemetry becomes an error entry."""

    members: list  # PendingRenderTelemetry of each decoded member, in input order
    errors: "dict[int, err.AptError] | None" = None
    clock: Optional[_StageClock] = field(default=None, repr=False)
    decoder: Optional["Decoder"] = field(default=None, repr=False)

    def get(self) -> list:
        stats = iter(_grouped_fetch([m.stats.T for m in self.members if m.error is None]))
        levels = []  # (low, high) or the error, per member
        for m in self.members:
            if m.error is not None:
                levels.append(m.error)
                continue
            try:
                levels.append(_telemetry_levels(*np.ascontiguousarray(next(stats).T)))
            except err.AptError as e:
                levels.append(e)
        if self.clock is not None:
            self.clock.mark("telemetry")
        mapped = [_map_u8(m.img, _f32(lv[0], m.img), _f32(lv[1], m.img))
                  for m, lv in zip(self.members, levels) if not isinstance(lv, err.AptError)]
        if self.clock is not None:
            self.clock.mark("rows_levels_u8")
        u8 = iter(_grouped_fetch(mapped))
        _close_clock(self)
        out = [lv if isinstance(lv, err.AptError) else (next(u8), m.sync_pos)
               for m, lv in zip(self.members, levels)]
        return _splice_errors(out, self.errors)


class Decoder:
    """Decodes recordings for one profile on one device.

    ``device``: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``
    (the plain PyTorch twins).  ``tables``: a :class:`DecodeTables` to
    use instead of designing them (for its input rate only).  ``ingest``:
    ``"device"`` (K1 resamples the raw recording on the device) or one of
    :data:`HOST_INGEST` (:meth:`prepare_work`)."""

    def __init__(self, profile: DecodeProfile, device=None, tables: DecodeTables | None = None,
                 ingest: str = "device"):
        if profile.work_rate % FINAL_RATE != 0:
            raise err.InternalError("work_rate is not multiple of FINAL_RATE")
        if ingest != "device" and ingest not in HOST_INGEST:
            raise ValueError(f"ingest must be 'device' or one of {HOST_INGEST}, got {ingest!r}")
        self.device = resolve_device(device)
        self.profile = profile
        self.work_rate = Rate(profile.work_rate)
        self.samples_per_work_row = PX_PER_ROW * profile.work_rate // FINAL_RATE
        self.ingest = ingest
        # host8 quality gate: passes whose predicted i8 ingest SNR sits
        # under this threshold ship i16 payloads instead (prepare_work);
        # host8_fallbacks counts them.
        self.host8_min_snr_db = 42.0
        self.host8_fallbacks = 0
        self._override = tables
        self._tables: dict[int, _DeviceTables] = {}
        self._chain_dev: _DeviceChain | None = None
        # Per-stage milliseconds of the last decode (see _StageClock).
        self.last_stage_ms: dict[str, float] = {}
        # The bytes of the last host -> device copy of a signal or
        # payload; and prepare_work's seconds.
        self.last_upload: dict | None = None
        self.last_ingest_s: float | None = None
        self._peers: dict = {}

    def on_device(self, device) -> "Decoder":
        """A plain decoder of this one's profile and tables on ``device``
        (this one where it is a plain decoder there): a member's decoder in
        ``parallel.batch_decode``."""
        dev = torch.device(device)
        if dev == self.device and type(self) is Decoder:
            return self
        if dev not in self._peers:
            self._peers[dev] = Decoder(self.profile, device=dev, tables=self._override)
        return self._peers[dev]

    def _clock(self) -> _StageClock:
        return _StageClock(self.device)

    # -- tables --------------------------------------------------------
    def tables(self, input_rate: Rate) -> DecodeTables:
        t = self._override
        if t is None:
            return DecodeTables.design(self.profile, input_rate)
        if t.input_rate != input_rate.get_hz() or t.work_rate != self.work_rate.get_hz():
            raise err.InternalError(
                f"tables are for {t.input_rate} Hz -> {t.work_rate} Hz, not "
                f"{input_rate.get_hz()} Hz -> {self.work_rate.get_hz()} Hz"
            )
        return t

    def _device_tables(self, input_rate: Rate) -> _DeviceTables:
        dt = self._tables.get(input_rate.get_hz())
        if dt is None:
            t = self.tables(input_rate)
            up = {k: torch.from_numpy(getattr(t, k)).to(self.device) for k in ("bank", "p_c", "s_c")}
            dt = _DeviceTables(t, **up)
            self._tables[input_rate.get_hz()] = dt
        return dt

    def _chain(self) -> _DeviceChain:
        """K2's tables: the override's, else designed for the profile."""
        if self._chain_dev is None:
            t = self._override
            taps, template, cosphi2, sinphi = (
                (t.taps, t.template, t.cosphi2, t.sinphi) if t is not None else _chain_design(self.profile))
            self._chain_dev = _DeviceChain(
                torch.from_numpy(np.ascontiguousarray(taps, np.float32)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(template, np.int8)).to(self.device),
                np.float32(cosphi2), dm.inv_sinphi(sinphi))
        return self._chain_dev

    # -- host ingest ---------------------------------------------------
    def _ingest_plan(self, input_rate: Rate, n_true: int):
        """Host-ingest resample plan ``(l, m, coeff, out_len)`` of an
        ``n_true``-sample recording, or None when the rate pair has no
        interpolation (l == 1: the decimation stays on the device)
        (``noaa_apt_tpu/graph/decode.py:1726-1752``)."""
        g = math.gcd(input_rate.get_hz(), self.work_rate.get_hz())
        if self.work_rate.get_hz() // g <= 1:
            return None
        l, m, coeff = _plan_resample_with_filter(input_rate, self.work_rate,
                                                 _ingest_filter(self.profile, input_rate))
        return l, m, coeff, rs.out_len_for(n_true, l, m, (len(coeff) - 1) // 2)

    def _host_ingest(self, signal, input_rate: Rate, context=None, exact: bool = True):
        """The host C++ polyphase resample to the work rate (reference
        accumulation order with ``exact``), or None for an l == 1 rate."""
        from ..native import fast_resample_native

        plan = self._ingest_plan(input_rate, int(signal.shape[0]))
        if plan is None:
            return None
        l, m, coeff, out_len = plan
        if context is not None:
            context.status(0.1, f"Resampling to {self.work_rate.get_hz()} (host)")
        return fast_resample_native(np.asarray(signal, np.float32), l, m, coeff, out_len, exact=exact)

    def _host_to_device(self, arr: np.ndarray, upload=None) -> torch.Tensor:
        """``arr`` on the decoder's device; records the copy's bytes in
        ``last_upload``.  The host copy out of a read-only memmap (span
        ``apt.upload.copy``, empty where none is made) and the copy to the
        device (``apt.upload.h2d``) are timed apart.  A caller's ``upload``
        (:meth:`prepare_work`) makes the copy instead and keeps its own
        accounting."""
        if upload is not None:
            return upload(arr)
        with span("apt.upload.copy"):
            if not arr.flags.writeable or not arr.flags.c_contiguous:
                arr = np.array(arr)  # read-only memmap -> a copy torch may wrap
        with span("apt.upload.h2d"):
            out = torch.from_numpy(arr).to(self.device)
        self.last_upload = {"bytes": int(arr.nbytes)}
        return out

    def prepare_work(self, signal, input_rate: Rate, to_device: bool = False, context=None,
                     upload=None):
        """Host-ingest a recording into a work payload
        (``noaa_apt_tpu/graph/decode.py:577-695``): the host C++ polyphase
        resample, quantized to i16 (``host16``, ``host16c``) or i8
        (``host8``) plus a scale (``host`` and ``device``: f32), and with
        ``to_device`` padded to ``pad_bucket(work_true)`` and uploaded
        (``host16c`` then ships the codec's sealed buffer, if the signal
        compresses).  Returns None for an l == 1 rate pair (the device
        path handles it).  ``host8`` ships an i16 payload instead for a
        recording whose predicted i8 SNR is under ``host8_min_snr_db``
        (counted in ``host8_fallbacks``).  ``last_ingest_s`` gets the
        seconds spent.  ``upload``: with ``to_device``, a callable that
        puts the padded host buffer on the device in place of the
        decoder's own copy (the fleet's pinned side-stream copy,
        ``serve.py``); ``last_upload`` is then left as it was."""
        t0 = time.perf_counter()
        try:
            return self._prepare_work(signal, input_rate, to_device, context, upload)
        finally:
            self.last_ingest_s = time.perf_counter() - t0

    def _prepare_work(self, signal, input_rate: Rate, to_device: bool, context, upload):
        from ..native import ingest_i16_native

        quantize = self.ingest in ("host16", "host8", "host16c")
        qbits = 8 if self.ingest == "host8" else 16
        if quantize and qbits == 8:
            est = _i8_ingest_snr_estimate(signal)
            if est is not None and est < self.host8_min_snr_db:
                qbits = 16
                self.host8_fallbacks += 1
                log.info("host8: predicted i8 ingest SNR %.1f dB under the %.1f dB gate; "
                         "using an i16 payload for this pass", est, self.host8_min_snr_db)
        if quantize and isinstance(signal, np.ndarray) and signal.dtype == np.int16:
            # Fused native ingest: i16 PCM -> polyphase -> i16/i8 quantize
            # in one C++ call, straight into the padded upload bucket.
            plan = self._ingest_plan(input_rate, int(signal.shape[0]))
            if plan is not None:
                l, m, coeff, out_len = plan
                if out_len == 0:
                    raise err.InternalError(_TOO_SHORT)
                if context is not None:
                    context.status(0.1, f"Resampling to {self.work_rate.get_hz()} (host)")
                buf, inv_scale = ingest_i16_native(signal, l, m, coeff, out_len, pad_bucket(out_len),
                                                   bits=qbits)
                if self.ingest == "host16c" and to_device:
                    packed = self._pack_payload(buf, out_len, inv_scale, upload)
                    if packed is not None:
                        return packed
                data = self._host_to_device(buf, upload) if to_device else buf[:out_len]
                return WorkPayload(data=data, work_true=out_len, inv_scale=inv_scale)
        # Quantized payloads tolerate the vectorized (reordered-sum)
        # resample: its ~1e-7 relative noise is far below the
        # quantization floor.
        work = self._host_ingest(signal, input_rate, context, exact=not quantize)
        if work is None:
            return None
        work_true = int(work.shape[0])
        if work_true == 0:
            raise err.InternalError(_TOO_SHORT)
        inv_scale = None
        if quantize:
            peak = float(np.max(np.abs(work))) or 1.0
            qmax, qdtype = (127.0, np.int8) if qbits == 8 else (32767.0, np.int16)
            scale = np.float32(qmax / peak)
            work = np.round(work * scale).astype(qdtype)
            inv_scale = float(np.float32(1.0) / scale)
        data = work
        if to_device:
            buf = np.zeros(pad_bucket(work_true), dtype=work.dtype)
            buf[:work_true] = work
            if self.ingest == "host16c" and buf.dtype == np.int16:
                packed = self._pack_payload(buf, work_true, inv_scale, upload)
                if packed is not None:
                    return packed
            data = self._host_to_device(buf, upload)
        return WorkPayload(data=data, work_true=work_true, inv_scale=inv_scale)

    def _pack_payload(self, buf_padded: np.ndarray, work_true: int, inv_scale: float, upload=None):
        """Encode a padded i16 work buffer with the lossless codec and
        upload the sealed buffer (``noaa_apt_tpu/graph/decode.py:697-745``).
        Returns None (the caller ships the plain i16 payload) when the
        bucket is not block-aligned or the signal does not compress
        (the sealed size, escape padding included, is not under 0.97x).
        The JAX package's numpy-encoder fallback (for a host without a
        native library) is not ported: the port's library always builds."""
        from ..native import pack_work_i16_native

        w_pad = int(buf_padded.shape[0])
        if w_pad % pk.BLOCK != 0:
            return None
        p = pack_work_i16_native(buf_padded, self.work_rate.get_hz())
        if p == "incompressible":
            log.info("host16c: signal does not compress; using plain i16")
            return None
        nb = w_pad // pk.BLOCK
        n_esc_pad = pad_bucket(max(4, len(p.esc_idx)))
        sealed_bytes = pk.sealed_len(nb, p.w_lo, n_esc_pad) * 4
        if sealed_bytes >= 0.97 * buf_padded.nbytes:
            log.info("host16c: signal does not compress (%.2fx sealed); using plain i16",
                     sealed_bytes / buf_padded.nbytes)
            return None
        sealed = pk.seal_packed(p, n_esc_pad)
        return PackedWorkPayload(
            buf=self._host_to_device(sealed.view(np.int32), upload), nb=nb, w_lo=p.w_lo, n_esc_pad=n_esc_pad,
            work_true=work_true, inv_scale=float(inv_scale), coeff=p.coeff,
        )

    # -- stages --------------------------------------------------------
    def _upload(self, signal, n_true: int, dtype=None) -> torch.Tensor:
        """The first ``n_true`` samples on the device: 16-bit PCM stays
        int16 (K1 converts in-register), anything else becomes f32
        (``dtype`` float32 makes int16 f32 too, as a mixed batch does)."""
        if isinstance(signal, torch.Tensor):
            x = signal[:n_true]
            if x.dtype != torch.int16 or dtype == np.float32:
                x = x.to(torch.float32)
            return x.to(self.device).contiguous()
        arr = np.asarray(signal)[:n_true]
        if arr.dtype != np.int16 or dtype == np.float32:
            arr = arr.astype(np.float32)
        return self._host_to_device(arr)

    def _fronts(self, signals: list, n_trues: list, input_rate: Rate, clock: _StageClock,
                dtype=None) -> list:
        """Upload, K1, K2 of each recording, stage by stage over them all:
        -> ``[(filt, corr, work_true)]``.  On the l == 1 path the upload
        is followed by K1's zero prefix (``ops/resample.causal_input``,
        stage ``causal_prefix``)."""
        dt = self._device_tables(input_rate)
        t = dt.tables
        xs = [self._upload(s, n, dtype) for s, n in zip(signals, n_trues)]
        clock.mark("upload")
        if t.l == 1:
            xs = [rs.causal_input(x, t.bank.shape[1]) for x in xs]
            clock.mark("causal_prefix")
        ys = [polyphase_resample(x, dt.bank, dt.p_c, dt.s_c, t.m, t.work_len(n))
              for x, n in zip(xs, n_trues)]
        clock.mark("resample")
        return self._chain_stage(ys, clock)

    def _front(self, signal, n_true: int, input_rate: Rate, clock: _StageClock, context=None):
        """One recording through :meth:`_fronts`, with the too-short guard."""
        work_true = self._device_tables(input_rate).tables.work_len(n_true)
        if context is not None:
            context.status(0.1, f"Resampling to {self.work_rate.get_hz()}")
        if work_true < 10 * self.samples_per_work_row:
            raise err.InternalError(_TOO_SHORT)
        return self._fronts([signal], [n_true], input_rate, clock)[0]

    def _chain_stage(self, ys: list, clock: _StageClock) -> list:
        """K2 on each work signal -> ``[(filt, corr, work_true)]``."""
        c = self._chain()
        out = [(*demod_fir_corr(y, c.taps, c.template, c.cosphi2, c.inv_sinphi), y.shape[0]) for y in ys]
        clock.mark("demod_fir_corr")
        return out

    def _payload_on_device(self, p):
        """A payload's signal (plain: its first ``work_true`` samples) or
        sealed buffer on the device; a pre-uploaded plain tensor must be
        padded to ``pad_bucket(work_true)``, as in the JAX package."""
        if isinstance(p, PackedWorkPayload):
            if isinstance(p.buf, torch.Tensor):
                return p.buf.to(self.device)
            return self._host_to_device(np.ascontiguousarray(p.buf).view(np.int32))
        w_pad = pad_bucket(p.work_true)
        if isinstance(p.data, torch.Tensor):
            if p.data.shape[0] != w_pad:
                raise err.InternalError(
                    f"pre-uploaded work buffer is {p.data.shape[0]}, "
                    f"expected pad_bucket({p.work_true}) = {w_pad}"
                )
            return p.data[: p.work_true].to(self.device)
        return self._host_to_device(np.asarray(p.data)[: p.work_true])

    def _work_fronts(self, payloads: list, clock: _StageClock) -> list:
        """Work payloads -> ``[(filt, corr, work_true)]``: upload, K4 for
        sealed buffers, the dequantize (``y = x.to(f32)``, then
        ``y * inv_scale``: two ops, as ``xi.astype(f32) * inv_scale`` in
        the JAX graph), K2; stage by stage over them all."""
        xs = [self._payload_on_device(p) for p in payloads]
        clock.mark("upload")
        if isinstance(payloads[0], PackedWorkPayload):
            coeff = pk.predictor_coeff(self.work_rate.get_hz())
            for p in payloads:
                if p.coeff != coeff:
                    raise err.InternalError(
                        f"packed payload's predictor coefficient {p.coeff} is not this decoder's "
                        f"{coeff} (work rate {self.work_rate.get_hz()} Hz)"
                    )
            xs = [unpack_sealed(x, p.nb, p.w_lo, p.n_esc_pad, coeff)[: p.work_true]
                  for x, p in zip(xs, payloads)]
            clock.mark("unpack")
        ys = []
        for x, p in zip(xs, payloads):
            y = x.to(torch.float32)
            if p.inv_scale is not None:
                y = y * _f32(p.inv_scale, y)
            ys.append(y)
        if payloads[0].inv_scale is not None:
            clock.mark("dequant")
        return self._chain_stage(ys, clock)

    def _sync(self, corr: torch.Tensor, work_true: int, clock: _StageClock):
        """K3 over corr[:work_true - g] -> (peaks on device, host list)."""
        spr, md, max_peaks = sy.selector_params(work_true, self.work_rate)
        g = self._chain().template.shape[0]
        with span("apt.wait.peaks"):  # the host blocks for K3's result
            peaks, lists = select_peaks(corr[None, :], [max(0, work_true - g)], spr, md, max_peaks,
                                        to_host=True)
        clock.mark("select")  # K3 and its one fetch of (k, overflow, peaks)
        sync_pos = lists[0]
        bad = _check_sync_count(sync_pos)
        if bad is not None:
            raise bad
        return peaks[0, : len(sync_pos)], sync_pos

    def _image(self, filt: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """Rows at ``pos`` decimated to 4160 Hz (``decode.rs:122-134``,
        ``dsp.rs:294-307``), with the NoFilter causal path's
        ``img[0, 0] = 0`` quirk (``dsp.rs:105-123``)."""
        m_final = self.work_rate.get_hz() // FINAL_RATE
        cols = torch.arange(0, self.samples_per_work_row, m_final, device=filt.device)
        img = filt[pos.to(torch.int64)[:, None] + cols[None, :]]
        if img.shape[0]:
            img[0, 0] = 0.0
        return img

    def _tails(self, fronts: list, clock: _StageClock, contrast_kind: str, pct: float) -> list:
        """K3 once over every member's correlation (zero-padded to one
        ``[B, L]``, each row read below its own length), then each
        member's rows, levels and u8 map, dispatched but not fetched:
        -> a :class:`PendingRender` (or :class:`PendingRenderTelemetry`)
        per member, whose ``error`` is set where the guard failed."""
        g = self._chain().template.shape[0]
        spr, md, _ = sy.selector_params(0, self.work_rate)
        max_peaks = max(sy.selector_params(wt, self.work_rate)[2] for _, _, wt in fronts)
        length = max(c.shape[0] for _, c, _ in fronts)
        rows = torch.zeros((len(fronts), length), dtype=torch.float32, device=self.device)
        for b, (_, c, _) in enumerate(fronts):
            rows[b, : c.shape[0]] = c
        with span("apt.wait.peaks"):  # the host blocks for K3's result
            peaks, lists = select_peaks(rows, [max(0, wt - g) for _, _, wt in fronts], spr, md,
                                        max_peaks, to_host=True)
        clock.mark("select")  # K3 and its one fetch of (k, overflow, peaks)
        members = []
        for b, ((filt, _, work_true), sync_pos) in enumerate(zip(fronts, lists)):
            bad = _check_sync_count(sync_pos)
            if bad is not None:
                members.append((PendingRenderTelemetry(None, None, sync_pos, bad)
                                if contrast_kind == "telemetry" else PendingRender(None, sync_pos, bad)))
                continue
            # rows_pos = [p for p in sync_pos[:-1] if p + spr < work_true],
            # compacted to the front (decode.rs:122-134 gather semantics).
            pk_row = peaks[b, : len(sync_pos)]
            idx = torch.arange(len(sync_pos), device=pk_row.device)
            img = self._image(filt, pk_row[(idx < len(sync_pos) - 1) & (pk_row + spr < work_true)])
            if contrast_kind == "telemetry":
                members.append(PendingRenderTelemetry(img, _telemetry_stats(img), sync_pos))
            elif img.shape[0] == 0:
                members.append(PendingRender(torch.zeros((0, PX_PER_ROW), dtype=torch.uint8,
                                                         device=img.device), sync_pos))
            else:
                members.append(PendingRender(_map_u8(img, *_levels(img, contrast_kind, pct)), sync_pos))
        if contrast_kind != "telemetry":
            clock.mark("rows_levels_u8")
        return members

    def _pending(self, fronts: list, clock: _StageClock, contrast_kind: str, pct: float):
        """One member's deferred render, which closes the stage clock."""
        p = self._tails(fronts, clock, contrast_kind, pct)[0]
        p.clock, p.decoder = clock, self
        return p

    # -- entry points --------------------------------------------------
    def decode_render_input(self, signal, n_true: int, input_rate: Rate,
                            contrast_kind: str = "percent", pct: float = 0.98, fetch: bool = True):
        """Raw recording -> (u8 rows [n_rows, 2080], sync positions), the
        whole chain on the device with two small fetches (the peak list,
        then the u8 image).

        ``contrast_kind``: "percent", "minmax" or "telemetry".  Telemetry
        (``PendingRenderTelemetry.get``, ``noaa_apt_tpu/graph/decode.py:428-438``)
        keeps the f32 image on the device, fetches its band statistics
        (``[3, rows]`` floats), runs the wedge math on the host and maps
        the image with the wedge-9/wedge-8 levels; its ``telemetry``
        stage times the row gather, the statistics, their fetch and the
        wedge math.  ``fetch=False`` returns the :class:`PendingRender`
        (or :class:`PendingRenderTelemetry`) whose ``get()`` fetches."""
        clock = self._clock()
        fronts = [self._front(signal, n_true, input_rate, clock)]
        pending = self._pending(fronts, clock, contrast_kind, pct)
        return pending.get() if fetch else pending

    def decode_render(self, payload, contrast_kind: str = "percent", pct: float = 0.98,
                      fetch: bool = True):
        """Work payload (:meth:`prepare_work`) -> (u8 rows, sync positions)
        (``noaa_apt_tpu/graph/decode.py:1246-1301``): a sealed buffer
        through K4, the dequantize, then K2, K3 and the tail of
        :meth:`decode_render_input` (no K1).  A pre-uploaded plain payload
        must be padded to ``pad_bucket(work_true)``."""
        if payload.work_true < 10 * self.samples_per_work_row:
            raise err.InternalError(_TOO_SHORT)
        clock = self._clock()
        pending = self._pending(self._work_fronts([payload], clock), clock, contrast_kind, pct)
        return pending.get() if fetch else pending

    def _batch_pending(self, fronts: list, clock: _StageClock, contrast_kind: str, pct: float, errors):
        cls = PendingRenderTelemetryBatch if contrast_kind == "telemetry" else PendingRenderBatch
        return cls(self._tails(fronts, clock, contrast_kind, pct), errors or None, clock, self)

    @staticmethod
    def _empty_batch(contrast_kind: str, errors, fetch: bool):
        if fetch:
            return _splice_errors([], errors)
        cls = PendingRenderTelemetryBatch if contrast_kind == "telemetry" else PendingRenderBatch
        return cls([], errors or None)

    def decode_render_batch(self, payloads: list, contrast_kind: str = "percent", pct: float = 0.98,
                            fetch: bool = True, pad_to: int | None = None):
        """Batched work-domain render (``noaa_apt_tpu/graph/decode.py:1342-1502``):
        K4 (sealed buffers) and K2 per member, K3 once over the batch, one
        grouped fetch.  Every member equals its unbatched
        :meth:`decode_render` byte for byte.

        All payloads must share ``pad_bucket(work_true)``, quantization and
        dtype (or, packed, one ``(w_pad, w_lo, n_esc_pad)``); packed and
        plain payloads do not mix.  A too-short member, or one with fewer
        than 5 sync frames, becomes an error entry.  ``pad_to`` is accepted
        and not computed: eager torch has no jit variants to pin."""
        spr = self.samples_per_work_row
        errors = {b: err.InternalError(_TOO_SHORT)
                  for b, p in enumerate(payloads) if p.work_true < 10 * spr}
        keep = [b for b in range(len(payloads)) if b not in errors]
        if not keep:
            return self._empty_batch(contrast_kind, errors, fetch)
        n_packed = sum(isinstance(payloads[b], PackedWorkPayload) for b in keep)
        if n_packed and n_packed != len(keep):
            raise err.InternalError(
                "decode_render_batch cannot mix packed (host16c) and plain "
                "work payloads in one batch"
            )
        if n_packed:
            geoms = {(payloads[b].nb * pk.BLOCK, payloads[b].w_lo, payloads[b].n_esc_pad) for b in keep}
            if len(geoms) != 1:
                raise err.InternalError(
                    "packed decode_render_batch needs one (w_pad, w_lo, n_esc_pad) "
                    f"bucket, got {sorted(geoms)}"
                )
        else:
            w_pads = {pad_bucket(payloads[b].work_true) for b in keep}
            if len(w_pads) != 1:
                raise err.InternalError(f"decode_render_batch needs one length bucket, got {sorted(w_pads)}")
            if len({payloads[b].inv_scale is not None for b in keep}) != 1:
                raise err.InternalError("decode_render_batch needs uniform quantization across the batch")
            dtypes = {_dtype_name(payloads[b].data) for b in keep}
            if len(dtypes) != 1:
                raise err.InternalError(f"decode_render_batch needs one payload dtype, got {sorted(dtypes)}")
        clock = self._clock()
        fronts = self._work_fronts([payloads[b] for b in keep], clock)
        pending = self._batch_pending(fronts, clock, contrast_kind, pct, errors)
        return pending.get() if fetch else pending

    def decode_render_input_batch(self, signals: list, n_trues: list, input_rate: Rate,
                                  contrast_kind: str = "percent", pct: float = 0.98, fetch: bool = True,
                                  pad_to: int | None = None):
        """Batched raw-recording render (``noaa_apt_tpu/graph/decode.py:1504-1619``):
        K1 and K2 per member, K3 once over the batch, one grouped fetch;
        every member equals its unbatched :meth:`decode_render_input`
        byte for byte.  Pre-uploaded tensors must all be padded to
        ``pad_bucket(max(n_trues))`` and share a dtype; host arrays that
        are not all int16 go as float32.  A too-short member, or one with
        fewer than 5 sync frames, becomes an error entry.  ``pad_to`` is
        accepted and not computed."""
        if len(signals) == 0:
            return self._empty_batch(contrast_kind, None, fetch)
        n_pad = pad_bucket(max(n_trues))
        work_len = self._device_tables(input_rate).tables.work_len
        errors = {b: err.InternalError(_TOO_SHORT)
                  for b, nt in enumerate(n_trues) if work_len(nt) < 10 * self.samples_per_work_row}
        keep = [b for b in range(len(signals)) if b not in errors]
        if not keep:
            return self._empty_batch(contrast_kind, errors, fetch)
        if all(isinstance(signals[b], torch.Tensor) for b in keep):
            for b in keep:
                if int(signals[b].shape[0]) != n_pad:
                    raise err.InternalError(
                        f"pre-uploaded input is {int(signals[b].shape[0])}, expected {n_pad}"
                    )
            dtypes = {_dtype_name(signals[b]) for b in keep}
            if len(dtypes) != 1:
                raise err.InternalError(
                    f"pre-uploaded batch mixes dtypes {sorted(dtypes)}; "
                    "upload every member as the same type"
                )
            dtype = None
        else:
            dtype = None if all(np.asarray(signals[b]).dtype == np.int16 for b in keep) else np.float32
        clock = self._clock()
        fronts = self._fronts([signals[b] for b in keep], [n_trues[b] for b in keep], input_rate, clock,
                              dtype)
        pending = self._batch_pending(fronts, clock, contrast_kind, pct, errors)
        return pending.get() if fetch else pending

    def decode(self, signal, input_rate: Rate, sync: bool = True, context=None,
               host_work=None) -> DecodeResult:
        """Decode a recording into raw image rows (``decode.rs:43-162``):
        resample to the work rate with the DC-removal lowpass,
        AM-demodulate, lowpass, sync-align (or truncate), decimate to
        4160 Hz.  ``context`` (``io/context.Context``) gets the
        reference's status calls.

        ``host_work``: a work payload (or a work-rate array) prepared on
        the host; with a host ``ingest`` and none given, :meth:`prepare_work`
        makes one (host16c then ships the plain i16 payload: the codec
        pays off only on the upload).  An l == 1 rate takes the device
        path (``noaa_apt_tpu/graph/decode.py:1643-1680``)."""
        spr = self.samples_per_work_row
        if host_work is None and self.ingest in HOST_INGEST:
            host_work = self.prepare_work(signal, input_rate, context=context)
        if isinstance(host_work, PackedWorkPayload):
            raise err.InternalError(
                "packed (host16c) payloads decode via decode_render/"
                "decode_render_batch, not decode()"
            )
        clock = self._clock()
        if host_work is not None:
            if not isinstance(host_work, WorkPayload):
                host_work = WorkPayload(data=np.asarray(host_work), work_true=int(host_work.shape[0]))
            if host_work.work_true < 10 * spr:
                raise err.InternalError(_TOO_SHORT)
            filt, corr, work_true = self._work_fronts([host_work], clock)[0]
        else:
            filt, corr, work_true = self._front(signal, len(signal), input_rate, clock, context)
        result = self._rows(filt, corr, work_true, sync, clock, context)
        self.last_stage_ms = clock.ms()
        return result

    def _rows(self, filt: torch.Tensor, corr: torch.Tensor, work_true: int, sync: bool,
              clock: _StageClock, context=None) -> DecodeResult:
        """:meth:`decode`'s tail: K3 and its guard with ``sync`` (else rows
        at the nominal row length), then the row gather."""
        spr = self.samples_per_work_row
        if sync:
            if context is not None:
                context.status(0.5, "Syncing")
            _, sync_pos = self._sync(corr, work_true, clock)
            rows_pos = [p for p in sync_pos[:-1] if p + spr < work_true]
        else:
            if context is not None:
                context.status(0.5, "Skipping Syncing")
            sync_pos = None
            rows_pos = list(range(0, (work_true // spr) * spr, spr))
        if context is not None:
            context.status(0.90, "Resampling to 4160")
        pos = torch.tensor(rows_pos, dtype=torch.int64, device=self.device)
        img = self._image(filt, pos)
        clock.mark("rows")
        return DecodeResult(image=img, n_rows=len(rows_pos), sync_positions=sync_pos)

    # The renders below hold no decoder state: they run on the device
    # the result's image lies on.
    @staticmethod
    def render_u8(result: DecodeResult, contrast_kind: str, pct: float = 0.98) -> np.ndarray:
        """Grayscale u8 rows with device contrast levels ("percent" or
        "minmax"), identical to :meth:`decode_render_input`'s."""
        if result.n_rows == 0:
            return np.zeros((0, PX_PER_ROW), np.uint8)
        low, high = _levels(result.image, contrast_kind, pct)
        return _map_u8(result.image, low, high).cpu().numpy()

    @staticmethod
    def telemetry_stats(result: DecodeResult):
        """Per-row telemetry band statistics of the resident image, in one
        fetch: ``(mean_a, mean_b, variance)``, f32 numpy arrays of
        ``n_rows``."""
        ma, mb, var = _telemetry_stats(result.image).cpu().numpy()
        return ma, mb, var

    @staticmethod
    def render_u8_levels(result: DecodeResult, low: float, high: float) -> np.ndarray:
        """u8 map with explicit levels (e.g. from telemetry wedges)."""
        img = result.image
        return _map_u8(img, _f32(low, img), _f32(high, img)).cpu().numpy()
