"""Multi-device and multi-process decode (``noaa_apt_tpu/parallel/``):
sequence sharding (:class:`ShardedDecoder`), data-parallel batches
(:func:`batch_decode`), and the process layer on ``torch.distributed``
with the gloo backend (:func:`init_distributed`, :func:`topology_mesh`,
:func:`fleet_shard`, :func:`global_batch`)."""

from .dist import Mesh, fleet_shard, global_batch, init_distributed, topology_mesh
from .shard import ShardedDecoder, batch_decode
