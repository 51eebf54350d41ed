"""Multi-device / multi-host SPMD execution.

The reference's only OSS "distributed" layer is a websocket client/server
(SURVEY §2.3.5); multi-node sharding is enterprise-only.  Here distribution is
first-class: a pass runs under ``shard_map`` over a ``jax.sharding.Mesh`` —
rows sharded across devices, grid accumulators merged with XLA collectives
(psum/pmin/pmax) across devices.  ``jax.distributed`` multi-controller extends the
same mesh across hosts.
"""

from .mesh import data_mesh, distributed_executor  # noqa: F401
