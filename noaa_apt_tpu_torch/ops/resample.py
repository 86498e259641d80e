"""L/M polyphase resampling: the plan, the tap bank, kernel K1 and its twin.

Behavioral contract: reference ``src/dsp.rs:186-289``
(``fast_resampling``) as ported by ``noaa_apt_tpu/ops/resample.py``.
Output ``k`` sits at interpolated position ``t = offset + k*m`` and is a
polyphase filter-bank sum

    y[k] = sum_i bank[p_k, i] * x[x0_k + i]
    p_k = (-k*m) mod l,  x0_k = s_c[k mod l] + (k div l)*m

with ``x`` read as 0 past its end (the reference's out-of-range skip).

The JAX package picks among four TPU/CPU mappings (conv, block matmul,
packed matmul, gather); the port has one: the direct per-output kernel
(``csrc/resample.cu``), which does exactly the live multiply-adds in a
fixed per-output order, so chunked evaluation is bit-stable in every
regime.  Its plain twin, :func:`polyphase_resample_plain`, sums the same
products in the same order.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

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


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library("resample").polyphase_resample
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def polyphase_resample(x: torch.Tensor, bank: torch.Tensor, p_c: torch.Tensor,
                       s_c: torch.Tensor, m: int, out_len: int, k0: int = 0) -> torch.Tensor:
    """Outputs ``k0 .. k0+out_len`` of the polyphase resample of ``x``
    (int16 or float32) -> float32[out_len].

    A CUDA tensor launches kernel K1 (``csrc/resample.cu``); a CPU
    tensor runs the plain twin."""
    _check(x, bank, p_c, s_c, m, out_len, k0)
    if x.device.type == "cpu":
        return polyphase_resample_plain(x, bank, p_c, s_c, m, out_len, k0)
    x, bank, p_c, s_c = (t.contiguous() for t in (x, bank, p_c, s_c))
    y = torch.empty(out_len, dtype=torch.float32, device=x.device)
    if out_len == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), int(x.dtype == torch.int16), x.shape[0], bank.data_ptr(),
                p_c.data_ptr(), s_c.data_ptr(), bank.shape[0], bank.shape[1], m, k0, out_len,
                y.data_ptr(), torch.cuda.current_stream().cuda_stream)
    polyphase_resample.launches += 1
    _build.check(rc, "polyphase_resample")
    return y


polyphase_resample.launches = 0


def fast_resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """Resample ``x`` by ``plan.l / plan.m`` with the planned filter
    (tables built on the host, uploaded to ``x``'s device)."""
    p_c, s_c, bank, _, _ = phase_tables(plan)
    dev = x.device
    return polyphase_resample(
        x, torch.from_numpy(bank).to(dev), torch.from_numpy(p_c.astype(np.int32)).to(dev),
        torch.from_numpy(s_c.astype(np.int32)).to(dev), plan.m, plan.out_len,
    )
