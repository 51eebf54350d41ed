"""The cell's table, made on the device from the seed.

A configuration file lists its columns with their distributions; every
column is drawn in one jitted call, placed on one device or with its rows
split evenly over a mesh, so nothing of the table passes through the host.
"""

from __future__ import annotations

import numpy as np

DTYPES = {"int64": np.int64, "float64": np.float64}


def itemsize(config, column):
    return np.dtype(DTYPES[config["columns"][column]["dtype"]]).itemsize


def make_table(config, seed, rows, sharding):
    """{column: jax.Array} of ``rows`` rows drawn from the configuration's
    distributions with ``jax.random`` keyed by ``seed``."""
    import jax
    columns = config["columns"]

    def draw(key):
        out = {}
        for k, (name, spec) in zip(jax.random.split(key, len(columns)), columns.items()):
            dtype = DTYPES[spec["dtype"]]
            if spec["dist"] == "uniform_int":  # low..high, both ends included
                out[name] = jax.random.randint(k, (rows,), spec["low"], spec["high"] + 1,
                                               dtype=dtype)
            elif spec["dist"] == "uniform_float":  # [low, high)
                out[name] = jax.random.uniform(k, (rows,), dtype=dtype,
                                               minval=spec["low"], maxval=spec["high"])
            else:
                raise ValueError(f"column {name}: unknown distribution {spec['dist']!r}")
        return out

    table = jax.jit(draw, out_shardings=sharding)(jax.random.PRNGKey(seed))
    return jax.block_until_ready(table)
