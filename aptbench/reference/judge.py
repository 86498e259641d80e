"""Judge a decoded image against the reference, row by row.

The program and the reference compute the same function in different
precisions, so their greedy sync walks agree except where two candidates
of a window tie to rounding; there a row may start a few samples
elsewhere, and a walk that went another way through a noisy stretch may
hold a row more or less.  So each of the program's rows is matched to
the reference's row of the same index (after any shift already found),
else to a neighbour up to two rows away (a shift), else to the row the
reference would cut at any start within a row's length of that place (a
resync).  What is left over is what the numbers measure:

- ``px_gap``: the widest gap, in u8 levels, between a program pixel and
  the reference's pixel of its best match (any channel of an RGBA image;
  an alpha other than 255 counts as its gap);
- ``rows_off``: rows matched only by a shift or a resync, plus the
  difference in row counts.

Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from .decode import Decoded, map_u8, rows_at

SHIFTS = (-1, 1, -2, 2)
MATCH = 1  # levels within which a row counts as matched without a search
SEARCH_COLS, SEARCH_KEEP = 64, 64


def as_gray(img: np.ndarray) -> tuple[np.ndarray, int]:
    """The grey rows of a decoded image, and the gap of its other
    channels from them (RGBA: G and B equal to R, alpha 255)."""
    if img.ndim == 2:
        return img, 0
    r = img[..., 0].astype(np.int16)
    extra = 0
    for c in (1, 2):
        extra = max(extra, int(np.abs(img[..., c].astype(np.int16) - r).max(initial=0)))
    if img.shape[2] == 4:
        extra = max(extra, int((255 - img[..., 3].astype(np.int16)).max(initial=0)))
    return img[..., 0], extra


def _row_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.int16) - b.to(torch.int16)).abs().amax(dim=1)


def _search(row: torch.Tensor, ref: Decoded, center: int) -> int:
    """The smallest gap of ``row`` to the reference's row cut at any start
    within ``spr`` samples of ``center``: every start is tried on 64
    columns spread over the row, and the 64 best in full."""
    lo = max(0, center - ref.spr)
    hi = min(ref.work_len - ref.spr - 1, center + ref.spr)
    if hi < lo:
        return 256
    dev = ref.filt.device
    row = row.to(dev)
    pos = torch.arange(lo, hi + 1, device=dev)
    cols = torch.linspace(0, row.shape[0] - 1, SEARCH_COLS, device=dev).round().to(torch.int64)
    sub = map_u8(ref.filt[pos[:, None] + cols[None, :] * ref.m_final], ref.low, ref.high)
    coarse = _row_gaps(sub, row[cols][None, :].expand_as(sub))
    best = pos[torch.argsort(coarse, stable=True)[:SEARCH_KEEP]]
    cand = map_u8(rows_at(ref.filt, best, ref.spr, ref.m_final), ref.low, ref.high)
    return int(_row_gaps(cand, row[None, :].expand_as(cand)).min())


def judge(img: np.ndarray, ref: Decoded) -> dict:
    """``{px_gap, rows_off, rows}`` of one decoded image (``rows``: the
    reference's)."""
    gray, extra = as_gray(img)
    dev = ref.u8.device
    prog = torch.from_numpy(np.ascontiguousarray(gray)).to(dev)
    h, r = prog.shape[0], ref.u8.shape[0]
    if h == 0 or r == 0:
        return {"px_gap": 0 if h == r else 255, "rows_off": abs(h - r), "rows": r}
    cache: dict = {}

    def gaps_at(off: int) -> np.ndarray:
        """Gap of each program row i to reference row i + off (256 where
        there is none)."""
        if off not in cache:
            g = torch.full((h,), 256, dtype=torch.int16, device=dev)
            i0, i1 = max(0, -off), min(h, r - off)
            if i1 > i0:
                g[i0:i1] = _row_gaps(prog[i0:i1], ref.u8[i0 + off : i1 + off])
            cache[off] = g.cpu().numpy()
        return cache[off]

    pos = ref.peaks
    rows_pos = [p for p in pos[:-1] if p + ref.spr < ref.work_len]
    off, worst, resynced = 0, 0, 0
    for i in range(h):
        g = int(gaps_at(off)[i])
        if g <= MATCH:
            worst = max(worst, g)
            continue
        best, best_off = g, off
        for s in SHIFTS:
            gs = int(gaps_at(off + s)[i])
            if gs < best:
                best, best_off = gs, off + s
        if best <= MATCH:
            off = best_off
        else:
            j = min(max(i + off, 0), len(rows_pos) - 1)
            best = min(best, _search(prog[i], ref, rows_pos[j]))
        resynced += 1
        worst = max(worst, best)
    return {"px_gap": max(worst, extra), "rows_off": resynced + abs(h - r), "rows": r}
