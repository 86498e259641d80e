"""Greedy sync-peak selection: kernel K3 and its twin.

Behavioral contract: reference ``src/decode.rs:236-254``, as selected
peak-for-peak identically by ``noaa_apt_tpu/ops/sync.py:find_sync_peaks``
and ``noaa_apt_tpu/ops/pallas_select.py:select_peaks(_batch)``:

- the seed is ``(p, v) = (0, max(corr[0], 0))`` with one peak at 0;
- replacement: while the first-occurrence argmax ``q`` of
  ``corr(p, p+md]`` beats ``v`` strictly, move the last peak to ``q``;
- otherwise force-append ``i0 = max(p+md+1, spr*(k+1))`` exactly
  ``i0//spr - k`` times, continuing from ``(i0, corr[i0])``; stop once
  ``i0 >= n_valid``.

Positions at or past ``n_valid`` never take part.  Returns int32
``peaks[B, max_peaks]`` (zero past ``k``) and ``k[B]``; a selection that
would pass ``max_peaks`` raises.

On the card K3 runs in two kernels (``csrc/select.cu``): a parallel
summary of every aligned block of :data:`SUMMARY_BLOCK` positions (max
and first index of the max), then a one-warp walk per row whose windows
read partial blocks raw and whole blocks from their summaries, and
which decides a replacement's next window in the same step.  The walk
reports its step count beside k and the overflow flag.
:func:`block_summary_plain` and :func:`walk_summaries_plain` are that
decomposition in plain torch/numpy: the tests hold them against
:func:`select_peaks_plain` and the JAX package, and ``chip_smoke.py``
holds the summary kernel against its plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build


def _check(corr, n_valid: np.ndarray, spr: int, md: int, max_peaks: int):
    if corr.dim() != 2 or corr.dtype != torch.float32:
        raise ValueError(f"corr must be a 2-D float32 tensor [B, L], got {corr.dtype}{tuple(corr.shape)}")
    if n_valid.shape != (corr.shape[0],):
        raise ValueError(f"n_valid must hold one length per row ({corr.shape[0]})")
    if (n_valid < 0).any() or (n_valid > corr.shape[1]).any():
        raise ValueError(f"n_valid must lie in [0, {corr.shape[1]}]")
    if spr <= 0 or md <= 0 or max_peaks < 1:
        raise ValueError(f"bad selector parameters spr={spr} md={md} max_peaks={max_peaks}")


def _overflow(b: int, max_peaks: int) -> RuntimeError:
    return RuntimeError(f"sync selection of row {b} exceeds max_peaks={max_peaks}")


def select_peaks_plain(corr: torch.Tensor, n_valid, spr: int, md: int, max_peaks: int):
    """The plain twin of kernel K3: the jump loop of
    ``noaa_apt_tpu/ops/sync.py:98-124`` over torch tensors, one row at a
    time (``torch.argmax`` returns the first occurrence)."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    B = corr.shape[0]
    peaks = torch.zeros((B, max_peaks), dtype=torch.int32)
    ks = torch.zeros(B, dtype=torch.int32)
    for b in range(B):
        row = corr[b]
        n = int(n_valid[b])
        out = [0]
        p, v = 0, (max(float(row[0]), 0.0) if n > 0 else 0.0)
        while True:
            while True:
                lo, hi = p + 1, min(p + md + 1, n)
                if lo >= hi:
                    break
                w = row[lo:hi]
                q = int(torch.argmax(w))
                m = float(w[q])
                if not m > v:
                    break
                p, v = lo + q, m
                out[-1] = p
            k = len(out)
            i0 = max(p + md + 1, spr * (k + 1))
            if i0 >= n:
                break
            appended = i0 // spr - k
            if k + appended > max_peaks:
                raise _overflow(b, max_peaks)
            out.extend([i0] * appended)
            p, v = i0, float(row[i0])
        peaks[b, : len(out)] = torch.tensor(out, dtype=torch.int32)
        ks[b] = len(out)
    return peaks.to(corr.device), ks.to(corr.device)


SUMMARY_BLOCK = 32  # positions per summary block (kS in csrc/select.cu)
CHUNK_BLOCKS = 64  # summary blocks per ring chunk (kBlocksPerChunk in csrc/select.cu)
RESULT_HEAD = 3  # (k, overflow, walk steps) before each row's peaks (kResHead in csrc/select.cu)


def _n_blocks(length: int) -> int:
    return -(-length // SUMMARY_BLOCK)


def block_summary_plain(corr: torch.Tensor, n_valid):
    """``(smax f32[B, nb], sidx i32[B, nb])``, ``nb = ceil(L / 32)``: for
    every aligned block of :data:`SUMMARY_BLOCK` positions of each row,
    the max and the first index of the max over the part of the block
    below ``n_valid[b]``; a block with no such part gives ``(-inf, -1)``.
    The plain version of K3's summary kernel."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    B, L = corr.shape
    nb = _n_blocks(L)
    dev = corr.device
    pos = torch.arange(nb * SUMMARY_BLOCK, device=dev)
    n = torch.from_numpy(n_valid).to(dev)
    x = torch.full((B, nb * SUMMARY_BLOCK), -float("inf"), dtype=torch.float32, device=dev)
    x[:, :L] = corr
    x = torch.where(pos[None, :] < n[:, None], x, torch.full_like(x, -float("inf")))
    blocks = x.view(B, nb, SUMMARY_BLOCK)
    arg = torch.argmax(blocks, dim=2)  # first occurrence
    smax = torch.gather(blocks, 2, arg[..., None])[..., 0]
    start = torch.arange(nb, device=dev) * SUMMARY_BLOCK
    empty = start[None, :] >= n[:, None]
    smax = torch.where(empty, torch.full_like(smax, -float("inf")), smax)
    sidx = torch.where(empty, torch.full_like(arg, -1), start[None, :] + arg)
    return smax, sidx.to(torch.int32)


def _window_argmax(row: np.ndarray, smax: np.ndarray, sidx: np.ndarray, lo: int, hi: int):
    """First argmax of ``row[lo:hi]`` as the walk kernel forms it: the
    left and right partial blocks raw, the whole blocks from summaries."""
    S = SUMMARY_BLOCK
    wb0, wb1 = -(-lo // S), hi // S
    left = np.arange(lo, min(hi, wb0 * S))
    right = np.arange(max(lo, wb1 * S), hi)
    vals = np.concatenate([row[left], smax[wb0:wb1], row[right]])
    idxs = np.concatenate([left, sidx[wb0:wb1], right])
    m = vals.max()
    return float(m), int(idxs[vals == m].min())


def walk_summaries_plain(corr: torch.Tensor, smax: torch.Tensor, sidx: torch.Tensor, n_valid,
                         spr: int, md: int, max_peaks: int):
    """The greedy walk of the module contract as K3's walk kernel runs it:
    every window's argmax from block summaries (:func:`block_summary_plain`)
    and raw partial blocks, and after a replacement at ``q1`` the next
    window decided in the same step from its new part only,
    ``[p+md+1, q1+md+1)``: the rest of ``(q1, q1+md]`` lies in the old
    window, after its first argmax, so it cannot beat ``corr[q1]``.  The
    plain version of the walk kernel; returns ``(peaks i32[B, max_peaks],
    k i32[B], steps i32[B])`` on the CPU, ``steps`` counting the windows
    ``(p, p+md]`` that a step opens, as the kernel counts them."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    rows = corr.cpu().numpy()
    smax, sidx = smax.cpu().numpy(), sidx.cpu().numpy()
    B = rows.shape[0]
    peaks = np.zeros((B, max_peaks), np.int32)
    ks = np.zeros(B, np.int32)
    steps = np.zeros(B, np.int32)
    for b in range(B):
        row, n = rows[b], int(n_valid[b])
        out = [0]
        p, v = 0, (max(float(row[0]), 0.0) if n > 0 else 0.0)
        while True:
            lo, hi = p + 1, min(p + md + 1, n)
            if lo < hi:
                steps[b] += 1
                m1, q1 = _window_argmax(row, smax[b], sidx[b], lo, hi)
                if m1 > v:
                    lo2, hi2 = p + md + 1, min(q1 + md + 1, n)
                    m2, q2 = _window_argmax(row, smax[b], sidx[b], lo2, hi2) if lo2 < hi2 else (m1, q1)
                    p, v = (q2, m2) if m2 > m1 else (q1, m1)
                    out[-1] = p
                    if m2 > m1:
                        continue
            k = len(out)
            i0 = max(p + md + 1, spr * (k + 1))
            if i0 >= n:
                break
            appended = i0 // spr - k
            if k + appended > max_peaks:
                raise _overflow(b, max_peaks)
            out.extend([i0] * appended)
            p, v = i0, float(row[i0])
        peaks[b, : len(out)] = out
        ks[b] = len(out)
    return torch.from_numpy(peaks), torch.from_numpy(ks), torch.from_numpy(steps)


_fns: dict = {}


def _kernel(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(_build.library("select"), name)
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = {
            # corr, ld, batch, n_valid (host), summ, sld, nb, stream
            "select_summary": [P, LL, I, P, P, LL, I, P],
            # corr, ld, batch, n_valid (host), summ, sld, spr, md, max_peaks, out, stream
            "select_walk": [P, LL, I, P, P, LL, I, I, I, P, P],
            "select_walk_md_limit": [],
        }[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _host_lengths(n_valid: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(n_valid, dtype=np.int32)


def _summary_ld(length: int) -> int:
    """Summary pairs per row: whole ring chunks of
    :data:`CHUNK_BLOCKS`, as the walk's bulk copies need."""
    return -(-max(_n_blocks(length), 1) // CHUNK_BLOCKS) * CHUNK_BLOCKS


def _summary_launch(corr: torch.Tensor, nv: np.ndarray, summ: torch.Tensor | None = None):
    """Launch the summary kernel into a padded int32 ``[B, sld, 2]``
    buffer of (float bits of the max, index) pairs (``summ``, or a new
    one).  -> (buffer, nb)."""
    B, L = corr.shape
    nb = _n_blocks(L)
    sld = _summary_ld(L)
    if summ is None:
        summ = torch.empty((B, sld, 2), dtype=torch.int32, device=corr.device)
    rc = _kernel("select_summary")(
        corr.data_ptr(), corr.stride(0), B, nv.ctypes.data, summ.data_ptr(), sld, nb,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "select_summary")
    return summ, nb


def _walk_launch(corr, nv: np.ndarray, summ, spr: int, md: int, max_peaks: int, out) -> None:
    """Launch the walk kernel over ``_summary_launch``'s buffer into
    ``out`` (int32 ``[B, RESULT_HEAD + max_peaks]``: k, the overflow
    flag, the walk's step count, then the peaks)."""
    rc = _kernel("select_walk")(
        corr.data_ptr(), corr.stride(0), corr.shape[0], nv.ctypes.data, summ.data_ptr(),
        summ.shape[1], spr, md, max_peaks, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "select_walk")


def _cuda_input(corr: torch.Tensor) -> torch.Tensor:
    return corr if corr.stride(1) == 1 else corr.contiguous()


def block_summary(corr: torch.Tensor, n_valid):
    """``corr f32[B, L]`` -> ``(smax f32[B, nb], sidx i32[B, nb])`` (see
    :func:`block_summary_plain`).  A CUDA tensor launches K3's summary
    kernel alone (a check of that intermediate: it counts no launch of
    :func:`select_peaks`); a CPU tensor runs the plain version."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    _check(corr, n_valid, 1, 1, 1)
    if corr.device.type == "cpu":
        return block_summary_plain(corr, n_valid)
    corr = _cuda_input(corr)
    with torch.cuda.device(corr.device):
        summ, nb = _summary_launch(corr, _host_lengths(n_valid))
    return summ[:, :nb, 0].view(torch.float32), summ[:, :nb, 1]


def _select_cuda(corr: torch.Tensor, n_valid: np.ndarray, spr: int, md: int, max_peaks: int):
    """Both K3 kernels and the one fetch: -> (device ``[B, RESULT_HEAD +
    max_peaks]`` buffer of (k, overflow, steps, peaks...), its host copy)."""
    md_limit = _kernel("select_walk_md_limit")()
    if md >= md_limit or corr.shape[1] + 2 * (md + spr) >= 2**31:
        raise ValueError(f"K3 takes md < {md_limit} and rows shorter than 2^31 - 2 * (md + spr)")
    corr = _cuda_input(corr)
    B, L = corr.shape
    nv = _host_lengths(n_valid)
    # One device allocation for the summary pairs and the result.
    n_summ = B * _summary_ld(L) * 2
    buf = torch.empty(n_summ + B * (RESULT_HEAD + max_peaks), dtype=torch.int32, device=corr.device)
    out = buf[n_summ:].view(B, RESULT_HEAD + max_peaks)
    if B == 0:
        return out, np.zeros((0, RESULT_HEAD + max_peaks), np.int32)
    with torch.cuda.device(corr.device):
        summ, _ = _summary_launch(corr, nv, buf[:n_summ].view(B, -1, 2))
        _walk_launch(corr, nv, summ, spr, md, max_peaks, out)
    select_peaks.launches += 1
    host = out.cpu().numpy()  # k, the overflow flag and the peaks: one fetch
    bad = np.flatnonzero(host[:, 1])
    if bad.size:
        raise _overflow(int(bad[0]), max_peaks)
    return out, host


def select_peaks(corr: torch.Tensor, n_valid, spr: int, md: int, max_peaks: int,
                 to_host: bool = False):
    """``corr f32[B, L]`` + host lengths ``n_valid[B]`` ->
    ``(peaks i32[B, max_peaks], k i32[B])`` on ``corr``'s device, or with
    ``to_host`` ``(peaks, [each row's peak list on the host])``: the
    decoder's sync step.

    A CUDA tensor launches kernel K3 (``csrc/select.cu``: the summary
    kernel, then one walking warp per row); a CPU tensor runs the plain
    twin.  The wrapper's one fetch brings back k, the overflow flag and
    the peaks together, and the host lists come from it."""
    n_valid = np.asarray(n_valid, np.int64).reshape(-1)
    _check(corr, n_valid, spr, md, max_peaks)
    if corr.device.type == "cpu":
        peaks, k = select_peaks_plain(corr, n_valid, spr, md, max_peaks)
        host_peaks, host_k = peaks.numpy(), k.numpy()
    else:
        out, host = _select_cuda(corr, n_valid, spr, md, max_peaks)
        peaks, k = out[:, RESULT_HEAD:], out[:, 0]
        host_peaks, host_k = host[:, RESULT_HEAD:], host[:, 0]
    if to_host:
        return peaks, [host_peaks[b, : host_k[b]].tolist() for b in range(len(host_k))]
    return peaks, k


select_peaks.launches = 0
