"""noaa-apt-tpu-torch: the PyTorch/CUDA port of the NOAA APT decode engine.

A second package beside ``noaa_apt_tpu`` (the JAX reference, which it is
held against in ``tests/test_torch_*.py``).  It imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of ``noaa_apt_tpu``; the
JAX-free pieces it needs (filter design, WAV reader, contrast scan,
synthesizer) are its own copies.

The hot path (WAV -> percent-contrast PNG) runs on one NVIDIA Hopper card
through three hand-written CUDA kernels (``csrc/``): the polyphase
resample, the fused AM-demod/FIR/sync-correlation stage and the greedy
sync-peak selector.  Every kernel has a plain PyTorch twin in the same
module; a wrapper takes the twin only for tensors that lie on the CPU.

Layer map (mirrors ``noaa_apt_tpu``):

- :mod:`noaa_apt_tpu_torch.core`   units (Freq/Rate), filter design, profiles
- :mod:`noaa_apt_tpu_torch.ops`    kernel wrappers and their plain twins
- :mod:`noaa_apt_tpu_torch.graph`  the eager decode pipeline, image finish, the resample tool
- :mod:`noaa_apt_tpu_torch.post`   host contrast oracle, rotate
- :mod:`noaa_apt_tpu_torch.geo`    SGP4 orbits, TLEs, shapefiles, the map overlay (host)
- :mod:`noaa_apt_tpu_torch.io`     WAV, PNG, settings, filename time/satellite inference
- :mod:`noaa_apt_tpu_torch.cli`    the command line (``python -m noaa_apt_tpu_torch``)
"""

__version__ = "0.1.0"

FINAL_RATE = 4160
PX_SYNC_FRAME = 39
PX_SPACE_DATA = 47
PX_CHANNEL_IMAGE_DATA = 909
PX_PER_CHANNEL = 1040
PX_PER_ROW = 2080
CARRIER_FREQ = 2400
