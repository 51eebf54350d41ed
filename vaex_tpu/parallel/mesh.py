"""Mesh construction + distributed executor factory."""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def data_mesh(n_devices=None, axis_name="d") -> Mesh:
    """A 1-d data mesh over the first n devices (row-shard axis)."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_rows(mesh, values, fill=0):
    """Place ``values`` with its rows split evenly over the mesh's first
    axis: each device receives only its own rows (nothing is staged on one
    device first).  Rows are padded with ``fill`` up to a multiple of the
    device count."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    axis = mesh.axis_names[0]
    pad = (-values.shape[0]) % mesh.shape[axis]
    if pad:
        xp = jax.numpy if isinstance(values, jax.Array) else np
        values = xp.concatenate([values, xp.full((pad,) + values.shape[1:], fill,
                                                 values.dtype)])
    return jax.device_put(values, NamedSharding(mesh, P(axis)))


def distributed_executor(n_devices=None):
    """An ExecutorLocal that runs every pass SPMD over a device mesh."""
    from ..execution import ExecutorLocal
    mesh = data_mesh(n_devices)
    if mesh.size == 1:
        return ExecutorLocal()
    return ExecutorLocal(mesh=mesh)


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed init for pod-slice execution (multi-controller)."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
