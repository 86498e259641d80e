"""L/M polyphase resampling: the plan, the tap bank, kernel K1 and its twin.

Behavioral contract: reference ``src/dsp.rs:186-289``
(``fast_resampling``) as ported by ``noaa_apt_tpu/ops/resample.py``.
Output ``k`` sits at interpolated position ``t = offset + k*m`` and is a
polyphase filter-bank sum

    y[k] = sum_i bank[p_k, i] * x[x0_k + i]
    p_k = (-k*m) mod l,  x0_k = s_c[k mod l] + (k div l)*m

with ``x`` read as 0 past its end (the reference's out-of-range skip).

The JAX package picks among four TPU/CPU mappings (conv, block matmul,
packed matmul, gather); the port has one kernel, K1 (``csrc/resample.cu``),
in three variants that :func:`_k1_variant` picks by shape, sample size
and the card's opt-in shared memory: "block" (a thread owns the ``l``
outputs of one block, over the tap table of :func:`k1_block_table`; for
``l <= 8`` the launch folds up to ``16 // l`` blocks into one,
:func:`k1_block_fold`) for ``l <= 32``, "class" (a thread owns one
output class ``c`` and walks blocks, over the class-major tap table of
:func:`k1_class_table`) for ``l > 32``, and "phase" (a thread per
output) for a shape whose CTA fits neither and for the float32 shapes
where "phase" measured faster (see :func:`_k1_variant`).  All sum each
output's taps in one fixed order, so chunked evaluation is bit-stable in
every regime, and all are bit-equal to the plain twin,
:func:`polyphase_resample_plain`, which sums the same products in the
same order, for any float32 input (inf, NaN, -0.0 and subnormals too).
"""

from __future__ import annotations

import ctypes
import weakref
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..spans import span
from . import _build


@dataclass(frozen=True, eq=False)
class ResamplePlan:
    """Host-side description of one L/M resample of ``n_in`` samples."""

    n_in: int
    l: int
    m: int
    out_len: int
    coeff: np.ndarray  # f32 filter taps at the interpolated rate


def out_len_for(n_in: int, l: int, m: int, offset: int) -> int:
    """Output count of the reference loop ``t = offset, offset+m, ...
    while t < n_in*l`` (``dsp.rs:203-234``); ``offset`` is the filter's
    ``(n_taps - 1) // 2``."""
    interp = n_in * l
    return max(0, -(-(interp - offset) // m)) if interp > offset else 0


def resample_plan(n_in: int, l: int, m: int, coeff: np.ndarray, out_len: int | None = None) -> ResamplePlan:
    coeff = np.asarray(coeff, np.float32)
    if out_len is None:
        out_len = out_len_for(n_in, l, m, (coeff.shape[0] - 1) // 2)
    return ResamplePlan(n_in, l, m, out_len, coeff)


def phase_tables(plan: ResamplePlan):
    """``(p_c, s_c, bank, t_taps, offset)``: the phase and first input
    offset of each output class ``c = k mod l``, and the tap bank
    ``bank[p, i] = coeff[p + i*l]`` (zero past the last tap) — the same
    tables as ``noaa_apt_tpu/ops/resample.py:_phase_tables``."""
    coeff = np.asarray(plan.coeff, np.float32)
    K = coeff.shape[0]
    l, m = plan.l, plan.m
    offset = (K - 1) // 2
    jmax = 2 * offset  # last usable tap index (dsp.rs:254 `n <= t + offset`)
    t_taps = jmax // l + 1
    c = np.arange(l, dtype=np.int64)
    p_c = (-(c * m)) % l
    s_c = (c * m + p_c) // l
    flat = np.zeros(l * t_taps, dtype=np.float32)
    flat[: jmax + 1] = coeff[: jmax + 1]
    bank = np.ascontiguousarray(flat.reshape(t_taps, l).T)
    return p_c, s_c, bank, t_taps, offset


def causal_tables(coeff: np.ndarray):
    """``(p_c, s_c, bank)`` that make K1 the l == 1 path of
    ``noaa_apt_tpu/graph/decode.py:82-88``: the reference's streaming FIR
    (``dsp::filter``, ``dsp.rs:386-410``, with its strict ``i > j``
    guard) decimated by m,

        y[n] = sum_{j < min(K, n*m)} coeff[j] * x[n*m - j],

    is K1 with ``l = 1``, ``p_c = s_c = [0]`` and ``bank[0, t] =
    coeff[K-1-t]`` over :func:`causal_input` (K zeros, then ``x[1:]``:
    the guard drops ``x[0]`` and every sample before it).  K1 sums the
    taps from the oldest sample to the newest (descending j), where the
    reference sums from the newest: the float results agree to rounding,
    not bit for bit."""
    coeff = np.asarray(coeff, np.float32)
    zero = np.zeros(1, np.int32)
    return zero, zero.copy(), coeff[::-1].copy()[None, :]  # a copy: one tap has a negative stride


def causal_input(x: torch.Tensor, n_taps: int) -> torch.Tensor:
    """K1's input for :func:`causal_tables`: ``n_taps`` zeros, then
    ``x[1:]``, in ``x``'s dtype and on its device."""
    return torch.cat([torch.zeros(n_taps, dtype=x.dtype, device=x.device), x[1:]])


def _check(x, bank, p_c, s_c, m, out_len, k0):
    if x.dim() != 1 or x.dtype not in (torch.int16, torch.float32):
        raise ValueError(f"x must be a 1-D int16 or float32 tensor, got {x.dtype}{tuple(x.shape)}")
    if bank.dim() != 2 or bank.dtype != torch.float32:
        raise ValueError("bank must be a 2-D float32 tensor [l, T]")
    l = bank.shape[0]
    for name, t in (("p_c", p_c), ("s_c", s_c)):
        if t.dtype != torch.int32 or tuple(t.shape) != (l,):
            raise ValueError(f"{name} must be int32[{l}]")
    for t in (bank, p_c, s_c):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}")
    if m <= 0 or out_len < 0 or k0 < 0:
        raise ValueError(f"bad resample geometry m={m} out_len={out_len} k0={k0}")


def polyphase_resample_plain(x, bank, p_c, s_c, m: int, out_len: int, k0: int = 0,
                             chunk: int = 1 << 20) -> torch.Tensor:
    """The plain twin of kernel K1: per output, ``acc = acc + bank*x``
    over the taps in ascending order from +0, one op per step; outputs
    are evaluated ``chunk`` at a time to bound the index tensors."""
    l, T = bank.shape
    n = x.shape[0]
    dev = x.device
    xp = torch.cat([x.to(torch.float32), torch.zeros(1, dtype=torch.float32, device=dev)])
    pc = p_c.to(torch.int64)
    sc = s_c.to(torch.int64)
    y = torch.empty(out_len, dtype=torch.float32, device=dev)
    for a in range(0, out_len, chunk):
        k = torch.arange(k0 + a, k0 + min(out_len, a + chunk), dtype=torch.int64, device=dev)
        c = k % l
        p = pc[c]
        x0 = sc[c] + (k // l) * m
        acc = torch.zeros(k.shape[0], dtype=torch.float32, device=dev)
        for t in range(T):
            xv = xp[torch.clamp(x0 + t, max=n)]
            acc = acc + bank[:, t][p] * xv
        y[a : a + k.shape[0]] = acc
    return y


# -- the block-major variant's tables and dispatch ---------------------------
K1_CTA_BLOCKS = 256  # blocks of l outputs a block-major CTA owns (kCtaBlocks)
K1_BLOCK_MAX_L = 32  # G = 8 groups of 4 accumulators a block
K1_FOLD_LANES = 16  # accumulators a thread holds per block at G = 4


def k1_bank_ways(stride: int, x_bytes: int) -> int:
    """Shared-memory bank conflict of a warp's read of the staged span
    when lane ``i`` reads sample ``i * stride`` of ``x_bytes`` bytes: the
    most distinct 4-byte words that fall on one of the 32 banks."""
    words = np.arange(32) * stride * x_bytes // 4
    return max(np.unique(words[words % 32 == k]).size for k in np.unique(words % 32))


def k1_fold_blocks(l: int, m: int, x_bytes: int = 2) -> int:
    """The blocks ``b`` that :func:`k1_block_fold` joins into one: 1 for
    ``l > 8``; else the ``b <= 16 // l`` whose warp reads of the staged
    span cost the least per block of output: the bank conflict of the
    stride ``b*m`` (:func:`k1_bank_ways`) over ``b``, the largest such
    ``b`` on a tie.  At l == 1, m == 2, ``b = 16`` would put all 32 lanes
    on one bank with float32 samples (16 ways with int16); ``b = 15``
    gives 2 ways (float32) and none (int16)."""
    if l > K1_FOLD_LANES // 2:
        return 1
    return min(range(K1_FOLD_LANES // l, 0, -1), key=lambda b: Fraction(k1_bank_ways(b * m, x_bytes), b))


def k1_block_fold(p_c, s_c, m: int, x_bytes: int = 2) -> tuple[np.ndarray, np.ndarray, int]:
    """``(p_c, s_c, m)`` of the block-major launch for ``x_bytes``-byte
    samples.  For ``l <= 8``, ``b`` consecutive blocks of ``l`` outputs
    (:func:`k1_fold_blocks`, at most ``16 // l``) form one block of
    ``b*l``: output ``k = i*b*l + j*l + c`` has its first input at
    ``s_c[c] + j*m + i*(b*m)``, so the folded classes are ``p_c`` tiled
    ``b`` times, ``s_c[c] + j*m``, and the stride is ``b*m``.  Each
    output keeps its taps and their order, so the sums are unchanged;
    the small l (1 on the l == 1 path) then fills most of a thread's 16
    accumulators, where it would leave ``16 - l`` of them dead, and a CTA
    owns ``b`` times the outputs.  Other l pass through."""
    p_c, s_c = np.asarray(p_c, np.int64), np.asarray(s_c, np.int64)
    b = k1_fold_blocks(p_c.shape[0], m, x_bytes)
    j = np.arange(b, dtype=np.int64)[:, None]
    return np.tile(p_c, b), (s_c[None, :] + j * m).reshape(-1), b * m


def k1_block_table(bank, p_c, s_c) -> tuple[np.ndarray, np.ndarray, int]:
    """``(w f32[R, 4G], live u8[R], G)`` of the block-major variant, for
    ``l = len(p_c)`` output classes (the bank may have fewer rows: see
    :func:`k1_block_fold`).

    ``w[r, c] = bank[p_c[c], r - s_c[c]]`` inside output class ``c``'s
    window (``s_c[c] <= r < s_c[c] + T``) and 0 outside it, over the
    relative input position ``r < R = max(s_c) + T``; columns ``c >= l``
    are 0.  ``live[r]`` has bit ``g`` set when any of ``w[r, 4g:4g+4]``
    is nonzero.  ``G`` is 4 for ``l <= 16`` and 8 for ``l <= 32``."""
    bank = np.asarray(bank, np.float32)
    p_c, s_c = np.asarray(p_c, np.int64), np.asarray(s_c, np.int64)
    l, taps = p_c.shape[0], bank.shape[1]
    if l > K1_BLOCK_MAX_L:
        raise ValueError(f"the block-major variant takes l <= {K1_BLOCK_MAX_L}, got l={l}")
    g = 4 if l <= 16 else 8
    r_len = int(s_c.max()) + taps
    w = np.zeros((r_len, 4 * g), np.float32)
    for c in range(l):
        w[s_c[c] : s_c[c] + taps, c] = bank[p_c[c]]
    nz = (w != 0).reshape(r_len, g, 4).any(axis=2)
    live = (nz.astype(np.uint32) << np.arange(g, dtype=np.uint32)).sum(axis=1).astype(np.uint8)
    return w, live, g


def k1_block_smem(l: int, m: int, r_len: int, g: int, x_bytes: int = 2) -> int:
    """Dynamic shared memory of one block-major CTA, in bytes: the W
    table, the input span of ``x_bytes``-byte samples (2 for int16, 4
    for float32) from the 16-byte boundary at or below its start (then
    the y tile over it) and the live mask.  Mirrors ``block_smem`` in
    ``csrc/resample.cu``."""
    span = (K1_CTA_BLOCKS - 1) * m + r_len + 16 // x_bytes - 1
    tile = max(x_bytes * span, 4 * K1_CTA_BLOCKS * l)
    return 16 * r_len * g + (tile + 15) // 16 * 16 + r_len


# -- the class-major variant's tables -----------------------------------------
K1_CLASS_TILE = 128  # output classes a class-major CTA owns (kClassThreads)
K1_CLASS_BLOCKS = 32  # blocks of l outputs a class-major CTA owns (kClassBlocks)
# Row strides of the staged segments (K1_CLASS_STRIDES in csrc/resample.cu).
K1_CLASS_STRIDES = (32, 64, 96, 128, 160, 192, 256, 320, 384, 448, 512, 576, 640, 768, 1024, 1280, 1816)


def k1_class_table(bank, p_c, s_c) -> tuple[np.ndarray, int]:
    """``(wc f32[T, l], seg)`` of the class-major variant.

    ``wc[t, c] = bank[p_c[c], t]``: lane ``c`` of a warp reads column
    ``c``, so a warp's tap load is one coalesced row.  ``seg`` is the x
    segment a CTA stages per block: the widest ``s_c[last] - s_c[first]``
    over the tiles of ``K1_CLASS_TILE`` classes, plus ``T``."""
    bank = np.asarray(bank, np.float32)
    p_c, s_c = np.asarray(p_c, np.int64), np.asarray(s_c, np.int64)
    l, taps = bank.shape
    first = np.arange(0, l, K1_CLASS_TILE)
    last = np.minimum(first + K1_CLASS_TILE - 1, l - 1)
    return np.ascontiguousarray(bank[p_c].T), int((s_c[last] - s_c[first]).max()) + taps


def k1_class_smem(seg: int) -> int:
    """Dynamic shared memory of one class-major CTA, in bytes: one f32 row
    per block, at the least stride of ``K1_CLASS_STRIDES`` that holds
    ``seg`` (``seg`` itself past the largest, which no CTA fits).
    Mirrors ``class_smem`` in ``csrc/resample.cu``."""
    return 4 * K1_CLASS_BLOCKS * next((s for s in K1_CLASS_STRIDES if s >= seg), seg)


def k1_phase_smem(l: int, taps: int) -> int:
    """Shared memory of a "phase" CTA that stages the tap bank and the
    phase tables, in bytes; a larger bank is read from global memory.
    Mirrors ``polyphase_resample`` in ``csrc/resample.cu``."""
    return 4 * l * taps + 8 * l


def _k1_variant(l: int, m: int, taps: int, x_bytes: int, smem_bytes: int, optin: int) -> str:
    """K1's variant for ``l`` output classes, input stride ``m``, ``taps``
    taps and ``x_bytes``-byte samples: ``"block"`` for ``l <= 32`` and
    ``"class"`` for ``l > 32``, where that variant's CTA (``smem_bytes``,
    which depends on the sample size) fits ``optin`` bytes of shared
    memory; else ``"phase"``.  Float32 input also takes ``"phase"`` where
    it ran faster on an H100 (``tools/kernel_ab.py``, PERF.md section 6):
    at ``l <= 32`` where a block-major CTA takes over a third of the
    opt-in (at most two CTAs an SM: the 4-byte span) and ``taps <= 2 m``
    (48000 and 96000 Hz fast and standard, 192000 Hz fast); at ``l > 32``
    with ``m > 4 l`` where the bank fits in shared memory (the resample
    tool's 48000 -> 11025 Hz; 50000, 88200, 100000, 176400 Hz), as before
    this variant took float32; with the bank in global memory "phase" ran
    ten times slower than "class" (62500 Hz standard).  Int16 input runs
    "block" and "class" wherever they fit."""
    if smem_bytes > optin:
        return "phase"
    if x_bytes == 4:
        if l <= K1_BLOCK_MAX_L and 3 * smem_bytes > optin and taps <= 2 * m:
            return "phase"
        if l > K1_BLOCK_MAX_L and m > 4 * l and k1_phase_smem(l, taps) <= optin:
            return "phase"
    return "block" if l <= K1_BLOCK_MAX_L else "class"


@dataclass(frozen=True)
class _BlockTable:
    w: torch.Tensor  # f32[R, 4G] on the bank's device
    live: torch.Tensor  # u8[R]
    s_f: torch.Tensor  # i32[l]: the launch's first input offsets (k1_block_fold)
    g: int
    r_len: int
    l: int  # output classes and input stride of the launch (k1_block_fold)
    m: int


@dataclass(frozen=True)
class _ClassTable:
    wc: torch.Tensor  # f32[T, l] on the bank's device
    seg: int


def _build_block(bank: np.ndarray, p_c: np.ndarray, s_c: np.ndarray, dev, m: int,
                 x_bytes: int) -> _BlockTable:
    p_c, s_c, m = k1_block_fold(p_c, s_c, m, x_bytes)
    w, live, g = k1_block_table(bank, p_c, s_c)
    return _BlockTable(torch.from_numpy(w).to(dev), torch.from_numpy(live).to(dev),
                       torch.from_numpy(s_c.astype(np.int32)).to(dev), g, w.shape[0], p_c.shape[0], m)


def _build_class(bank: np.ndarray, p_c: np.ndarray, s_c: np.ndarray, dev) -> _ClassTable:
    wc, seg = k1_class_table(bank, p_c, s_c)
    return _ClassTable(torch.from_numpy(wc).to(dev), seg)


_BUILDERS = {"block": _build_block, "class": _build_class}

# (variant, id(bank), *extra) -> (weak refs to bank, p_c, s_c; their versions; the table)
_tables: dict[tuple, tuple] = {}


def _table(variant: str, bank: torch.Tensor, p_c: torch.Tensor, s_c: torch.Tensor, *extra):
    """The ``variant`` table of ``(bank, p_c, s_c)`` on their device
    (``extra``: the block variant's stride ``m``, which its fold needs),
    built on the host once and kept while ``bank`` lives and none of the
    three is replaced or written (``_version``): later calls need no host
    sync.  A build (the fetch of the three to the host, the table, its
    upload) is the span ``apt.k1.table``."""
    key = (variant, id(bank), *extra)
    versions = (bank._version, p_c._version, s_c._version)
    hit = _tables.get(key)
    if (hit is not None and hit[1] == versions
            and all(r() is t for r, t in zip(hit[0], (bank, p_c, s_c)))):
        return hit[2]
    with span("apt.k1.table"):
        tab = _BUILDERS[variant](bank.cpu().numpy(), p_c.cpu().numpy(), s_c.cpu().numpy(), bank.device, *extra)
    refs = (weakref.ref(bank, lambda _, k=key: _tables.pop(k, None)),
            weakref.ref(p_c), weakref.ref(s_c))
    _tables[key] = (refs, versions, tab)
    return tab


_fns: dict = {}
_optin: dict[int, int] = {}


def _kernel(name: str):
    """The C entry ``name`` of ``csrc/resample.cu``, typed."""
    if name not in _fns:
        f = getattr(_build.library("resample"), name)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = {
            "polyphase_resample": [p, i, ll, p, p, p, i, i, ll, ll, ll, p, p],
            "polyphase_resample_block": [p, i, ll, p, p, p, i, i, i, i, ll, ll, ll, p, p],
            "polyphase_resample_class": [p, i, ll, p, p, i, i, ll, i, ll, ll, p, p],
            "resample_smem_optin": [ctypes.POINTER(ctypes.c_int)],
        }[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return _fns[name]


def _smem_optin(device: torch.device) -> int:
    """The shared memory a block of ``device`` may opt in to, in bytes."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _optin:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            _build.check(_kernel("resample_smem_optin")(ctypes.byref(out)), "resample_smem_optin")
        _optin[idx] = out.value
    return _optin[idx]


def polyphase_resample(x: torch.Tensor, bank: torch.Tensor, p_c: torch.Tensor,
                       s_c: torch.Tensor, m: int, out_len: int, k0: int = 0) -> torch.Tensor:
    """Outputs ``k0 .. k0+out_len`` of the polyphase resample of ``x``
    (int16 or float32) -> float32[out_len].

    A CUDA tensor launches kernel K1 (``csrc/resample.cu``) in the
    variant :func:`_k1_variant` picks, recorded in ``.last_variant``; a
    CPU tensor runs the plain twin (``.last_variant`` is ``"plain"``)."""
    _check(x, bank, p_c, s_c, m, out_len, k0)
    if x.device.type == "cpu":
        polyphase_resample.last_variant = "plain"
        return polyphase_resample_plain(x, bank, p_c, s_c, m, out_len, k0)
    l = bank.shape[0]
    if l <= K1_BLOCK_MAX_L:
        tab = _table("block", bank, p_c, s_c, m, x.element_size())
        smem = k1_block_smem(tab.l, tab.m, tab.r_len, tab.g, x.element_size())
    else:
        tab = _table("class", bank, p_c, s_c)
        smem = k1_class_smem(tab.seg)
    variant = _k1_variant(l, m, bank.shape[1], x.element_size(), smem, _smem_optin(x.device))
    x, bank, p_c, s_c = (t.contiguous() for t in (x, bank, p_c, s_c))
    y = torch.empty(out_len, dtype=torch.float32, device=x.device)
    if out_len == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    i16 = int(x.dtype == torch.int16)
    with torch.cuda.device(x.device):
        if variant == "block":
            rc = _kernel("polyphase_resample_block")(
                x.data_ptr(), i16, x.shape[0], tab.w.data_ptr(), tab.live.data_ptr(), tab.s_f.data_ptr(),
                bank.shape[1], tab.g, tab.r_len, tab.l, tab.m, k0, out_len, y.data_ptr(), stream)
        elif variant == "class":
            rc = _kernel("polyphase_resample_class")(
                x.data_ptr(), i16, x.shape[0], tab.wc.data_ptr(), s_c.data_ptr(), l, bank.shape[1], m,
                tab.seg, k0, out_len, y.data_ptr(), stream)
        else:
            rc = _kernel("polyphase_resample")(
                x.data_ptr(), i16, x.shape[0], bank.data_ptr(), p_c.data_ptr(), s_c.data_ptr(), l,
                bank.shape[1], m, k0, out_len, y.data_ptr(), stream)
    polyphase_resample.launches += 1
    polyphase_resample.last_variant = variant
    _build.check(rc, f"polyphase_resample ({variant})")
    return y


polyphase_resample.launches = 0
polyphase_resample.last_variant = None


def fast_resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """Resample ``x`` by ``plan.l / plan.m`` with the planned filter
    (tables built on the host, uploaded to ``x``'s device)."""
    p_c, s_c, bank, _, _ = phase_tables(plan)
    dev = x.device
    return polyphase_resample(
        x, torch.from_numpy(bank).to(dev), torch.from_numpy(p_c.astype(np.int32)).to(dev),
        torch.from_numpy(s_c.astype(np.int32)).to(dev), plan.m, plan.out_len,
    )


def expanded_filtered(x: torch.Tensor, l: int, coeff: np.ndarray) -> torch.Tensor:
    """The zero-stuffed, filtered signal at the interpolated rate, what
    ``--export-resample-filtered`` dumps (``dsp.rs:265-273``;
    ``noaa_apt_tpu/ops/resample.py:expanded_filtered``):

        ef[i] = sum_j coeff[j] * up[i + j]    for i < n*l - offset,

    i.e. the resampler's windows at ``t = offset + i`` with stride 1.  That
    is K1 at ``m = 1`` over the same polyphase tables: ``l`` times as many
    outputs as ``x`` has samples (374 M at 48 kHz standard for a
    10-minute pass)."""
    return fast_resample(x, resample_plan(int(x.shape[0]), l, 1, coeff))
