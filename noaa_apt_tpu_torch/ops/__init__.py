"""Compute primitives: the four CUDA kernel wrappers and their plain twins.

Each wrapper (``polyphase_resample``, ``demod_fir_corr``,
``select_peaks``, ``unpack_sealed``) launches its kernel for CUDA tensors, runs its plain
PyTorch twin for CPU tensors, and counts its launches in a plain integer
attribute ``.launches``.
"""

from __future__ import annotations


def kernel_wrappers() -> dict:
    """name -> wrapper, for every kernel of the decode path."""
    from .pack import unpack_sealed
    from .resample import polyphase_resample
    from .select import select_peaks
    from .stage import demod_fir_corr

    return {
        "polyphase_resample": polyphase_resample,
        "demod_fir_corr": demod_fir_corr,
        "select_peaks": select_peaks,
        "unpack_sealed": unpack_sealed,
    }


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
