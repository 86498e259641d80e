"""Device choice for the port's entry points.

The entry points run on the card.  There is no silent fallback: asking
for CUDA on a machine without it raises, and the plain PyTorch path runs
only when the caller passes ``device="cpu"`` (as the CPU tests do).
"""

from __future__ import annotations

import torch


def _pin_fp32() -> None:
    """Full-f32 matmul and convolution everywhere: the reference runs
    ``Precision.HIGHEST`` (``noaa_apt_tpu/ops/resample.py:139-150``) and
    TF32 keeps only ~3 decimal digits.  The port's own path uses no
    library matmul or convolution, but anything that does (a yardstick
    in ``chip_smoke.py``) must not drift into TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    major, minor = (int(v) for v in torch.__version__.split(".")[:2])
    if (major, minor) >= (2, 9):
        torch.backends.cudnn.conv.fp32_precision = "ieee"


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises ``RuntimeError`` when CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    _pin_fp32()
    return dev
