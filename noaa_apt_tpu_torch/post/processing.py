"""Image post-processing of the ported slice: rotation.

Behavioral contract: reference ``src/processing.rs:21-37`` (a subset of
``noaa_apt_tpu/post/processing.py``; histogram equalization and false
colour wait for a later slice).  Images are RGBA uint8 arrays of shape
[H, 2080, 4].
"""

from __future__ import annotations

import logging

import numpy as np

from .. import PX_CHANNEL_IMAGE_DATA, PX_PER_CHANNEL, PX_SPACE_DATA, PX_SYNC_FRAME

log = logging.getLogger(__name__)

_X_OFFSET = PX_SYNC_FRAME + PX_SPACE_DATA  # 86: image data start per channel


def rotate(img: np.ndarray) -> None:
    """180-degree rotate the two channel image areas in place, leaving
    sync/space/telemetry columns untouched (processing.rs:21-37)."""
    log.info("Rotating image")
    for x0 in (_X_OFFSET, _X_OFFSET + PX_PER_CHANNEL):
        sub = img[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA]
        img[:, x0 : x0 + PX_CHANNEL_IMAGE_DATA] = sub[::-1, ::-1]
