"""Haloed windows: one chunk of the work signal computed apart from the rest.

Kernel K1 (``ops/resample.polyphase_resample``) computes work sample
``k = i*l + c`` from the tap row of its class ``c`` and the inputs from
``s_c[c] + i*m`` on, and kernel K2 (``ops/stage.demod_fir_corr``) each
filtered and correlation sample from a fixed run of work samples; both
sum each output's terms in one fixed order, wherever it sits in a launch.
So a chunk of ``w`` work samples that starts on a whole polyphase period
(:func:`chunk_alignment`) comes out bit for bit as in the one launch over
the whole recording, when both kernels run over a window of the input
around it: its own ``ci = w*m/l`` input samples, ``l_in`` before them
(``l_ctx`` work samples of left context: the demod's one-sample history
and the FIR's taps) and ``r_in`` after them (``g_ctx`` work samples of
correlation guard, plus the resampler's reach).

Two decoders cut a recording so: the live decoder
(``stream.StreamingDecoder``), one chunk at a time as the audio arrives,
and the sequence-sharded decoder (``parallel/shard.ShardedDecoder``), one
chunk a device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import demod as dm
from ..ops.resample import polyphase_resample
from ..ops.stage import demod_fir_corr
from .decode import DecodeTables


def ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def chunk_alignment(l: int) -> int:
    """The granularity, in work samples, of a chunk's start and of its
    halos: one polyphase period, ``l`` outputs (1 at l == 1).

    K1 computes output ``k = i*l + c`` from the tap row of its class ``c`` and
    the inputs from ``s_c[c] + i*m`` on, summed in one fixed order, and K2
    sums each output's taps and template terms in one fixed order too;
    neither result depends on where the launch starts.  A window that
    starts on a whole period (work sample ``j*l``, input sample ``j*m``)
    therefore sees every output's classes and inputs at the same offsets
    as the offline launch, and gives its floats bit for bit.  (The JAX
    package aligns to its TPU matmul blocks instead, ``out_alignment``.)"""
    return max(1, l)


@dataclass(frozen=True)
class HaloGeometry:
    """Where chunk ``k`` of ``w`` work samples and its input window lie.

    Chunk ``k`` is work samples ``[k*w, (k+1)*w)``; its window is input
    samples ``[k*ci - l_in, (k+1)*ci + r_in)`` (:meth:`window`), 0 outside
    the recording, and K1 gives ``ext_out`` work samples from it, the
    first at ``k*w - l_ctx``."""

    l: int
    m: int
    w: int
    ci: int
    l_ctx: int
    g_ctx: int
    l_in: int
    r_in: int

    @classmethod
    def design(cls, t: DecodeTables, w: int) -> "HaloGeometry":
        """The geometry of ``w``-sample chunks (a multiple of
        :func:`chunk_alignment`) for the tables ``t``."""
        l, m = t.l, t.m
        align = chunk_alignment(l)
        if w <= 0 or w % align:
            raise ValueError(f"a chunk of {w} work samples is not a whole number of periods ({align})")
        taps = t.bank.shape[1]
        l_ctx = ceil_to(t.taps.shape[0] + 1, align)
        g_ctx = ceil_to(t.template.shape[0], align)
        if l > 1:
            l_in = l_ctx * m // l
            r_in = g_ctx * m // l + int(t.s_c.max()) + taps + 1
        else:
            # causal_tables: output j reads x[j*m - K + 1 .. j*m] (K = taps).
            l_in = l_ctx * m + taps - 1
            r_in = g_ctx * m
        return cls(l=l, m=m, w=w, ci=w * m // l, l_ctx=l_ctx, g_ctx=g_ctx, l_in=l_in, r_in=r_in)

    @property
    def ext_out(self) -> int:
        """Work samples K1 gives over one window."""
        return self.l_ctx + self.w + self.g_ctx

    def window(self, k: int) -> tuple[int, int]:
        """Chunk ``k``'s input window ``[a, b)`` (``a`` may be negative)."""
        return k * self.ci - self.l_in, (k + 1) * self.ci + self.r_in

    def skip(self, k: int) -> int:
        """Work samples at the start of chunk ``k``'s window that lie before
        global sample 0 (the first chunk's left context)."""
        return max(0, self.l_ctx - k * self.w)

    def zero_before_start(self, ext, a: int) -> None:
        """The l == 1 edge rule on a window that starts at input sample
        ``a``: ``causal_input``'s semantics (the reference's strict
        ``i > j`` guard drops ``x[0]``, and nothing comes before it), so the
        window's samples at and before global 0 are zeroed in place."""
        if self.l == 1 and a <= 0:
            ext[: 1 - a] = 0


@dataclass
class WindowTables:
    """K1's and K2's tables of one input rate on one device."""

    bank: torch.Tensor
    p_c: torch.Tensor
    s_c: torch.Tensor
    taps: torch.Tensor
    template: torch.Tensor
    cosphi2: np.float32
    inv_sinphi: np.float32

    @classmethod
    def upload(cls, t: DecodeTables, device) -> "WindowTables":
        up = {k: torch.from_numpy(getattr(t, k)).to(device) for k in ("bank", "p_c", "s_c", "taps", "template")}
        return cls(**up, cosphi2=t.cosphi2, inv_sinphi=dm.inv_sinphi(t.sinphi))


def window_resample(ext: torch.Tensor, geom: HaloGeometry, tabs: WindowTables) -> torch.Tensor:
    """K1 over one window -> its ``ext_out`` work samples."""
    return polyphase_resample(ext, tabs.bank, tabs.p_c, tabs.s_c, geom.m, geom.ext_out)


def window_stage(y: torch.Tensor, geom: HaloGeometry, k: int, tabs: WindowTables):
    """K2 over chunk ``k``'s work window ``y`` -> the chunk's ``(filt,
    corr)``, ``w`` samples each.  K2 runs from global sample 0 on (it skips
    :meth:`HaloGeometry.skip` samples), so on the first chunk its own
    ``dem[0] = 0`` and zero history are the offline graph's."""
    skip = geom.skip(k)
    lo = geom.l_ctx - skip
    filt, corr = demod_fir_corr(y[skip:], tabs.taps, tabs.template, tabs.cosphi2, tabs.inv_sinphi)
    return filt[lo : lo + geom.w], corr[lo : lo + geom.w]
