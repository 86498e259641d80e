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
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from .. import CARRIER_FREQ, FINAL_RATE, PX_PER_ROW, err
from ..core import Lowpass, LowpassDcRemoval
from ..core.frequency import Freq, Rate
from ..core.profiles import DecodeProfile
from ..device import resolve_device
from ..ops import demod as dm
from ..ops import resample as rs
from ..ops import sync as sy
from ..ops.resample import polyphase_resample
from ..ops.select import select_peaks
from ..ops.stage import demod_fir_corr
from ..post.telemetry import telemetry_from_stats

log = logging.getLogger(__name__)

_TOO_SHORT = "Got less than 10 rows of samples, audio file is too short"


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
        filt = LowpassDcRemoval(
            cutout=Freq.hz(profile.resample_cutout, input_rate),
            atten=profile.resample_atten,
            delta_w=Freq.hz(profile.resample_delta_freq, input_rate),
        )
        l, m, coeff = _plan_resample_with_filter(input_rate, work, filt)
        if l == 1:
            (p_c, s_c, bank), offset = rs.causal_tables(coeff), 0
        else:
            p_c, s_c, bank, _, offset = rs.phase_tables(rs.resample_plan(0, l, m, coeff))
        carrier = Freq.hz(float(CARRIER_FREQ), work)
        cutout = Freq.from_pi_rad(np.float32(FINAL_RATE) / np.float32(work.get_hz()))
        taps = Lowpass(cutout=cutout, atten=profile.demodulation_atten, delta_w=cutout / 5.0).design()
        cosphi2, sinphi = dm.demod_constants(carrier)
        return cls.from_numpy(
            input_rate=input_rate.get_hz(), work_rate=work.get_hz(), l=l, m=m, offset=offset,
            p_c=p_c, s_c=s_c, bank=bank, taps=taps, template=sy.generate_sync_frame(work),
            cosphi2=cosphi2, sinphi=sinphi,
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
    tables: DecodeTables
    bank: torch.Tensor
    p_c: torch.Tensor
    s_c: torch.Tensor
    taps: torch.Tensor
    template: torch.Tensor
    inv_sinphi: np.float32


class _StageClock:
    """Per-stage times of one decode: CUDA events on the card (read once
    the decode has fetched its result, so no extra synchronisation),
    the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
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


class Decoder:
    """Decodes recordings for one profile on one device.

    ``device``: ``"cuda"`` (default; raises without CUDA) or ``"cpu"``
    (the plain PyTorch twins).  ``tables``: a :class:`DecodeTables` to
    use instead of designing them (for its input rate only)."""

    def __init__(self, profile: DecodeProfile, device=None, tables: DecodeTables | None = None):
        if profile.work_rate % FINAL_RATE != 0:
            raise err.InternalError("work_rate is not multiple of FINAL_RATE")
        self.device = resolve_device(device)
        self.profile = profile
        self.work_rate = Rate(profile.work_rate)
        self.samples_per_work_row = PX_PER_ROW * profile.work_rate // FINAL_RATE
        self._override = tables
        self._tables: dict[int, _DeviceTables] = {}
        # Per-stage milliseconds of the last decode (see _StageClock).
        self.last_stage_ms: dict[str, float] = {}

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
            up = {k: torch.from_numpy(getattr(t, k)).to(self.device)
                  for k in ("bank", "p_c", "s_c", "taps", "template")}
            dt = _DeviceTables(t, inv_sinphi=dm.inv_sinphi(t.sinphi), **up)
            self._tables[input_rate.get_hz()] = dt
        return dt

    # -- stages --------------------------------------------------------
    def _upload(self, signal, n_true: int) -> torch.Tensor:
        """The first ``n_true`` samples on the device: 16-bit PCM stays
        int16 (K1 converts in-register), anything else becomes f32."""
        if isinstance(signal, torch.Tensor):
            x = signal[:n_true]
            if x.dtype != torch.int16:
                x = x.to(torch.float32)
            return x.to(self.device).contiguous()
        arr = np.asarray(signal)[:n_true]
        if arr.dtype != np.int16:
            arr = arr.astype(np.float32)
        if not arr.flags.writeable or not arr.flags.c_contiguous:
            arr = np.array(arr)  # read-only memmap -> a copy torch may wrap
        return torch.from_numpy(arr).to(self.device)

    def _front(self, signal, n_true: int, input_rate: Rate, clock: _StageClock, context=None):
        """Upload, K1, K2: -> (filt, corr, work_true, device tables).
        On the l == 1 path the upload is followed by K1's zero prefix
        (``ops/resample.causal_input``, stage ``causal_prefix``)."""
        dt = self._device_tables(input_rate)
        work_true = dt.tables.work_len(n_true)
        if context is not None:
            context.status(0.1, f"Resampling to {self.work_rate.get_hz()}")
        if work_true < 10 * self.samples_per_work_row:
            raise err.InternalError(_TOO_SHORT)
        x = self._upload(signal, n_true)
        clock.mark("upload")
        t = dt.tables
        if t.l == 1:
            x = rs.causal_input(x, t.bank.shape[1])
            clock.mark("causal_prefix")
        y = polyphase_resample(x, dt.bank, dt.p_c, dt.s_c, t.m, work_true)
        clock.mark("resample")
        filt, corr = demod_fir_corr(y, dt.taps, dt.template, t.cosphi2, dt.inv_sinphi)
        clock.mark("demod_fir_corr")
        return filt, corr, work_true, dt

    def _sync(self, corr: torch.Tensor, work_true: int, g: int, clock: _StageClock):
        """K3 over corr[:work_true - g] -> (peaks on device, host list)."""
        spr, md, max_peaks = sy.selector_params(work_true, self.work_rate)
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

    # -- entry points --------------------------------------------------
    def decode_render_input(self, signal, n_true: int, input_rate: Rate,
                            contrast_kind: str = "percent", pct: float = 0.98):
        """Raw recording -> (u8 rows [n_rows, 2080], sync positions), the
        whole chain on the device with two small fetches (the peak list,
        then the u8 image).

        ``contrast_kind``: "percent", "minmax" or "telemetry".  Telemetry
        (``PendingRenderTelemetry.get``, ``noaa_apt_tpu/graph/decode.py:428-438``)
        keeps the f32 image on the device, fetches its band statistics
        (``[3, rows]`` floats), runs the wedge math on the host and maps
        the image with the wedge-9/wedge-8 levels; its ``telemetry``
        stage times the row gather, the statistics, their fetch and the
        wedge math."""
        clock = _StageClock(self.device)
        filt, corr, work_true, dt = self._front(signal, n_true, input_rate, clock)
        peaks, sync_pos = self._sync(corr, work_true, dt.template.shape[0], clock)
        # rows_pos = [p for p in sync_pos[:-1] if p + spr < work_true],
        # compacted to the front (decode.rs:122-134 gather semantics).
        k = peaks.shape[0]
        idx = torch.arange(k, device=peaks.device)
        pos = peaks[(idx < k - 1) & (peaks + self.samples_per_work_row < work_true)]
        img = self._image(filt, pos)
        if contrast_kind == "telemetry":
            low, high = _telemetry_levels(*_telemetry_stats(img).cpu().numpy())
            clock.mark("telemetry")
            u8 = _map_u8(img, _f32(low, img), _f32(high, img))
        elif img.shape[0] == 0:
            u8 = torch.zeros((0, PX_PER_ROW), dtype=torch.uint8, device=img.device)
        else:
            u8 = _map_u8(img, *_levels(img, contrast_kind, pct))
        clock.mark("rows_levels_u8")
        out = u8.cpu().numpy()
        clock.mark("fetch_image")
        self.last_stage_ms = clock.ms()
        return out, sync_pos

    def decode(self, signal, input_rate: Rate, sync: bool = True, context=None) -> DecodeResult:
        """Decode a recording into raw image rows (``decode.rs:43-162``):
        resample to the work rate with the DC-removal lowpass,
        AM-demodulate, lowpass, sync-align (or truncate), decimate to
        4160 Hz.  ``context`` (``io/context.Context``) gets the
        reference's status calls."""
        clock = _StageClock(self.device)
        n_true = len(signal)
        filt, corr, work_true, dt = self._front(signal, n_true, input_rate, clock, context)
        spr = self.samples_per_work_row
        if sync:
            if context is not None:
                context.status(0.5, "Syncing")
            _, sync_pos = self._sync(corr, work_true, dt.template.shape[0], clock)
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
        self.last_stage_ms = clock.ms()
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
