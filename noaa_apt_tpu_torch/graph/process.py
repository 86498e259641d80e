"""Image finish of the ported slice: u8 rows -> RGBA, then rotate.

Behavioral contract: the tail of reference ``process()``
(``noaa_apt.rs:186-243``) as ``noaa_apt_tpu/graph/process.py:finish_image``
runs it.  False colour, histogram equalization and the map overlay wait
for a later slice and raise here.
"""

from __future__ import annotations

import numpy as np

from .. import PX_PER_ROW, err
from ..post import processing
from ..types import ContrastKind, Rotate


def finish_image(gray: np.ndarray, kind: ContrastKind, rotate: Rotate, color=None,
                 orbit=None) -> np.ndarray:
    """Contrast-mapped u8 rows [H, 2080] -> RGBA image [H, 2080, 4]."""
    if color is not None:
        raise err.InternalError("false colour is not ported yet")
    if kind == ContrastKind.HISTOGRAM:
        raise err.InternalError("histogram equalization is not ported yet")
    if orbit is not None:
        raise err.InternalError("orbit settings (map overlay) are not ported yet")
    if rotate == Rotate.ORBIT:
        raise err.InternalError("orbit-based rotation is not ported yet")
    height = gray.shape[0]
    img = np.empty((height, PX_PER_ROW, 4), dtype=np.uint8)
    img[..., 0] = gray
    img[..., 1] = gray
    img[..., 2] = gray
    img[..., 3] = 255
    if rotate == Rotate.YES:
        processing.rotate(img)
    return img
