"""Lossless fixed-width residual codec of the i16 work signal: kernel K4 and its twin.

Behavioral contract: ``noaa_apt_tpu/ops/pack.py`` (the ``host16c``
ingest mode), of which this module is the port's own copy: the numpy
encoder and host decoder below are that module's, line for line, and
``unpack_sealed`` computes exactly what its ``unpack_sealed_device``
computes (``:246-294``).

Scheme (integer-exact on both sides, so a decoded pass equals the
``host16`` pass byte for byte):

- a resonant 2-tap predictor tuned to the 2400 Hz carrier at the work
  rate, ``pred[n] = ((C * x[n-1]) >> 14) - x[n-2]`` with
  ``C = round(2 cos(2 pi 2400 / work_rate) 2^14)``;
- every 128-sample block stores its two first samples raw (anchors) and
  126 residuals at one pass-level width ``w_lo`` at a fixed stride;
  ``lcm(w_lo, 32)`` bits are one unit of ``g`` residuals in ``u`` words,
  so residual ``j`` of a block starts at bit ``j * w_lo`` of its stride;
- blocks whose residuals do not fit ``w_lo`` ship raw as escape rows and
  overwrite the decoded block at the end.

Sealed single-buffer layout (u32 words; one upload)::

    [nb anchors] [n_esc_pad esc indices] [n_esc_pad * 64 esc rows]
    [nb * block_words(w_lo) base bits]

In torch the sealed buffer is an ``int32`` tensor, a bit view of the u32
words (``torch.uint32`` has almost no CPU ops).  The escape indices are
read as int32, so an index ``>= 2^31`` is negative; as in the JAX
graph, an index in ``[-nb, 0)`` counts from the end and any index
outside ``[-nb, nb)`` is dropped (the padding slots hold ``nb``).  Where
several rows name one block (the encoder never writes that, a corrupt
stream can), the last of them wins, as JAX's scatter on the CPU does.  The
recurrence runs in int32 with wraparound and an arithmetic ``>> 14``, so
a corrupt stream gives garbage samples, never a crash.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

BLOCK = 128
RES_PER_BLOCK = BLOCK - 2  # two raw anchors per block
PRED_SHIFT = 14
W_MIN, W_MAX = 4, 16
ESC_ROW_WORDS = BLOCK // 2  # raw i16 block = 64 u32 words


def predictor_coeff(work_rate_hz: int, carrier_hz: float = 2400.0) -> int:
    """Fixed-point resonator coefficient C (see the module docstring)."""
    return int(round(2.0 * np.cos(2.0 * np.pi * carrier_hz / work_rate_hz)
                     * (1 << PRED_SHIFT)))


def unit_geometry(w_lo: int) -> tuple[int, int, int, int]:
    """(g, u, n_units, block_words): ``g`` residuals per word-aligned
    unit of ``u`` words (``g*w_lo == u*32``), units per block, and the
    block's base-region stride in words."""
    d = math.gcd(w_lo, 32)
    g = 32 // d
    u = w_lo // d
    n_units = -(-RES_PER_BLOCK // g)
    return g, u, n_units, n_units * u


@dataclass
class PackedWork:
    """Encoded work signal (host arrays, seal-ready)."""

    base: np.ndarray     # u32 [nb * block_words] fixed-stride residual bits
    anchors: np.ndarray  # i16 [nb, 2] first two samples of each block
    esc_idx: np.ndarray  # i32 [n_esc] block indices shipped raw
    esc_rows: np.ndarray  # i16 [n_esc, BLOCK] raw samples of those blocks
    w_lo: int
    n_samples: int       # true sample count (<= nb*BLOCK)
    coeff: int           # predictor coefficient C

    @property
    def nb(self) -> int:
        return self.anchors.shape[0]

    @property
    def nbytes(self) -> int:
        return (self.base.nbytes + self.anchors.nbytes
                + self.esc_idx.nbytes + self.esc_rows.nbytes)


def _block_residuals(x: np.ndarray, coeff: int) -> tuple[np.ndarray, np.ndarray]:
    """(blocks [nb, BLOCK] i64, residuals [nb, RES_PER_BLOCK] i64);
    ``>>`` on negatives is an arithmetic (floor) shift."""
    n = int(x.shape[0])
    nb = -(-n // BLOCK)
    xb = np.zeros(nb * BLOCK, np.int16)
    xb[:n] = x
    blocks = xb.reshape(nb, BLOCK).astype(np.int64)
    pred = ((coeff * blocks[:, 1:-1]) >> PRED_SHIFT) - blocks[:, :-2]
    return blocks, blocks[:, 2:] - pred


def block_widths(r: np.ndarray) -> np.ndarray:
    """Smallest signed width per block: -2^(w-1) <= r <= 2^(w-1)-1."""
    neg = np.ceil(np.log2(np.maximum(-r.min(axis=1), 1))).astype(np.int64)
    pos = np.ceil(np.log2(np.maximum(r.max(axis=1) + 1, 1))).astype(np.int64)
    w = np.maximum(np.maximum(neg, pos) + 1, 1)
    lo, hi = -(np.int64(1) << (w - 1)), (np.int64(1) << (w - 1)) - 1
    bad = ~(((r >= lo[:, None]) & (r <= hi[:, None])).all(axis=1))
    if bad.any():  # float log2 rounding edge
        w = np.where(bad, w + 1, w)
    return w


def choose_width(widths: np.ndarray) -> int:
    """Exact byte-cost argmin of the pass-level width: base stride at
    w_lo for every block + a 65-word escape row per block wider than
    w_lo."""
    best_w, best_cost = W_MAX, None
    for w in range(W_MIN, W_MAX + 1):
        _, _, _, bw = unit_geometry(w)
        n_esc = int((widths > w).sum())
        cost = widths.shape[0] * bw * 4 + n_esc * (1 + ESC_ROW_WORDS) * 4
        if best_cost is None or cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def pack_work_i16(x: np.ndarray, work_rate_hz: int) -> PackedWork:
    """Encode an i16 work signal (the vectorized numpy encoder: the
    test oracle of the C++ encoder in ``native/``)."""
    assert x.dtype == np.int16
    coeff = predictor_coeff(work_rate_hz)
    blocks, r = _block_residuals(x, coeff)
    nb = blocks.shape[0]
    widths = block_widths(r)
    w_lo = choose_width(widths)
    g, u, n_units, bw = unit_geometry(w_lo)

    esc = widths > w_lo
    esc_idx = np.nonzero(esc)[0].astype(np.int32)
    esc_rows = blocks[esc].astype(np.int16)

    # Base region: residuals truncated to w_lo bits (two's complement),
    # padded to whole units, packed at fixed stride.  Escape blocks'
    # truncations are deterministic and overwritten at decode.
    mask = (np.int64(1) << w_lo) - 1
    field = (r & mask).astype(np.uint64)  # [nb, 126]
    fpad = np.zeros((nb, n_units * g), np.uint64)
    fpad[:, :RES_PER_BLOCK] = field
    fpad = fpad.reshape(nb * n_units, g)
    words = np.zeros((nb * n_units, u), np.uint64)
    for j in range(g):
        bit = j * w_lo
        wi, sh = bit >> 5, np.uint64(bit & 31)
        v = fpad[:, j] << sh
        words[:, wi] |= v & np.uint64(0xFFFFFFFF)
        if wi + 1 < u:
            words[:, wi + 1] |= v >> np.uint64(32)
    base = words.astype(np.uint32).reshape(-1)
    return PackedWork(
        base=base, anchors=blocks[:, :2].astype(np.int16),
        esc_idx=esc_idx, esc_rows=esc_rows,
        w_lo=w_lo, n_samples=int(x.shape[0]), coeff=coeff,
    )


def seal_packed(p: PackedWork, n_esc_pad: int) -> np.ndarray:
    """Coalesce into ONE u32 upload buffer (see the module docstring).
    ``n_esc_pad >= len(esc_idx)``; padded escape indices hold ``nb``
    (dropped by the decoder's scatter)."""
    nb = p.nb
    assert len(p.esc_idx) <= n_esc_pad
    _, _, _, bw = unit_geometry(p.w_lo)
    buf = np.zeros(nb + n_esc_pad * (1 + ESC_ROW_WORDS) + nb * bw, np.uint32)
    buf[:nb] = p.anchors.view(np.uint32).reshape(-1)
    idx = np.full(n_esc_pad, nb, np.uint32)  # out of range -> dropped
    idx[: len(p.esc_idx)] = p.esc_idx.astype(np.uint32)
    buf[nb : nb + n_esc_pad] = idx
    o = nb + n_esc_pad
    rows = np.zeros((n_esc_pad, BLOCK), np.int16)
    rows[: len(p.esc_idx)] = p.esc_rows
    buf[o : o + n_esc_pad * ESC_ROW_WORDS] = rows.view(np.uint32).reshape(-1)
    o += n_esc_pad * ESC_ROW_WORDS
    buf[o : o + len(p.base)] = p.base
    return buf


def sealed_len(nb: int, w_lo: int, n_esc_pad: int) -> int:
    _, _, _, bw = unit_geometry(w_lo)
    return nb + n_esc_pad * (1 + ESC_ROW_WORDS) + nb * bw


def _unpack_base_np(base: np.ndarray, nb: int, w_lo: int) -> np.ndarray:
    """Base-region residuals [nb, RES_PER_BLOCK] (i64, sign-extended)."""
    g, u, n_units, bw = unit_geometry(w_lo)
    words = base.astype(np.uint64).reshape(nb * n_units, u)
    vals = np.zeros((nb * n_units, g), np.uint64)
    mask = np.uint64((1 << w_lo) - 1)
    for j in range(g):
        bit = j * w_lo
        wi, sh = bit >> 5, np.uint64(bit & 31)
        v = words[:, wi] >> sh
        if (bit & 31) + w_lo > 32:
            v |= words[:, wi + 1] << (np.uint64(32) - sh)
        vals[:, j] = v & mask
    vals = vals.reshape(nb, n_units * g)[:, :RES_PER_BLOCK]
    sign = (vals >> np.uint64(w_lo - 1)) & np.uint64(1)
    return vals.astype(np.int64) - (sign.astype(np.int64) << w_lo)


def unpack_work_np(p: PackedWork) -> np.ndarray:
    """Host reference decoder (int64, no wraparound): the oracle of the
    encoders on valid streams."""
    nb = p.nb
    r = _unpack_base_np(p.base, nb, p.w_lo)
    out = np.zeros((nb, BLOCK), np.int64)
    out[:, :2] = p.anchors.astype(np.int64)
    for jj in range(RES_PER_BLOCK):
        pred = ((p.coeff * out[:, jj + 1]) >> PRED_SHIFT) - out[:, jj]
        out[:, jj + 2] = pred + r[:, jj]
    out[p.esc_idx] = p.esc_rows.astype(np.int64)
    return out.reshape(-1)[: p.n_samples].astype(np.int16)


def _check(buf, nb: int, w_lo: int, n_esc_pad: int):
    if buf.dim() != 1 or buf.dtype != torch.int32:
        raise ValueError(f"buf must be a 1-D int32 tensor (the u32 words), got {buf.dtype}{tuple(buf.shape)}")
    if not W_MIN <= w_lo <= W_MAX:
        raise ValueError(f"w_lo must lie in [{W_MIN}, {W_MAX}], got {w_lo}")
    if nb < 0 or n_esc_pad < 0:
        raise ValueError(f"nb and n_esc_pad must be >= 0, got {nb}, {n_esc_pad}")
    if buf.shape[0] < sealed_len(nb, w_lo, n_esc_pad):
        raise ValueError(f"buf holds {buf.shape[0]} words, the layout needs {sealed_len(nb, w_lo, n_esc_pad)}")


def unpack_sealed_plain(buf: torch.Tensor, nb: int, w_lo: int, n_esc_pad: int, coeff: int) -> torch.Tensor:
    """The plain twin of kernel K4: ``unpack_sealed_device``'s steps in
    torch ops.  Residual ``j`` of a block starts at bit ``j * w_lo`` of
    its stride (read as int64, so the u32 shifts are logical); the
    recurrence runs on int32 tensors (wrapping multiply, arithmetic
    shift); then the escape rows overwrite their blocks."""
    _, _, _, bw = unit_geometry(w_lo)
    dev = buf.device
    anchors = buf[:nb]
    esc_idx = buf[nb : nb + n_esc_pad]
    o = nb + n_esc_pad
    esc_rows = buf[o : o + n_esc_pad * ESC_ROW_WORDS].view(torch.int16).reshape(n_esc_pad, BLOCK)
    o += n_esc_pad * ESC_ROW_WORDS
    words = buf[o : o + nb * bw].to(torch.int64).bitwise_and(0xFFFFFFFF).reshape(nb, bw)

    bit = np.arange(RES_PER_BLOCK) * w_lo
    wi, sh = bit >> 5, bit & 31
    lo = words[:, torch.from_numpy(wi).to(dev)] >> torch.from_numpy(sh).to(dev)
    spill = (sh + w_lo > 32)
    wi1 = torch.from_numpy(np.where(spill, wi + 1, wi)).to(dev)
    hi = words[:, wi1] << torch.from_numpy(np.where(spill, 32 - sh, 0)).to(dev)
    hi = torch.where(torch.from_numpy(spill).to(dev), hi, torch.zeros_like(hi))
    v = (lo | hi) & ((1 << w_lo) - 1)
    r = (v - (((v >> (w_lo - 1)) & 1) << w_lo)).to(torch.int32)  # [nb, 126]

    a = anchors.view(torch.int16).reshape(nb, 2).to(torch.int32)
    x0, x1 = a[:, 0], a[:, 1]
    cc = torch.tensor(coeff, dtype=torch.int32, device=dev)
    out = torch.empty((nb, BLOCK), dtype=torch.int32, device=dev)
    out[:, 0], out[:, 1] = x0, x1
    for j in range(RES_PER_BLOCK):
        pred = ((cc * x1) >> PRED_SHIFT) - x0
        xn = pred + r[:, j]
        out[:, j + 2] = xn
        x0, x1 = x1, xn
    out = out.to(torch.int16)

    idx = esc_idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + nb, idx)
    keep = (idx >= 0) & (idx < nb)
    # Where several rows name one block, the last row wins, as JAX's
    # scatter does on the CPU: each block's largest row number (a max
    # scatter, whose result does not depend on order), then one gather.
    last = torch.full((nb,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, idx[keep], torch.arange(n_esc_pad, device=dev)[keep], "amax")
    hit = last >= 0
    out[hit] = esc_rows[last[hit]]
    return out.reshape(-1)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library("unpack").unpack_sealed
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # buf, nb, w_lo, block_words, n_esc_pad, coeff, out, stream
        f.argtypes = [p, ll, i, i, i, i, p, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def unpack_sealed(buf: torch.Tensor, nb: int, w_lo: int, n_esc_pad: int, coeff: int) -> torch.Tensor:
    """Sealed buffer (int32 bit view of the u32 words) -> the i16 work
    signal ``[nb * 128]``.

    A CUDA tensor launches kernel K4 (``csrc/unpack.cu``: one launch,
    escape rows included); a CPU tensor runs the plain twin."""
    _check(buf, nb, w_lo, n_esc_pad)
    if buf.device.type == "cpu":
        return unpack_sealed_plain(buf, nb, w_lo, n_esc_pad, coeff)
    buf = buf.contiguous()
    out = torch.empty(nb * BLOCK, dtype=torch.int16, device=buf.device)
    if nb == 0:
        return out
    _, _, _, bw = unit_geometry(w_lo)
    with torch.cuda.device(buf.device):
        rc = _kernel()(buf.data_ptr(), nb, w_lo, bw, n_esc_pad, int(np.int32(coeff)), out.data_ptr(),
                       torch.cuda.current_stream().cuda_stream)
    unpack_sealed.launches += 1
    _build.check(rc, "unpack_sealed")
    return out


unpack_sealed.launches = 0
