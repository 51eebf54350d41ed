"""``df.<stat>(column, binby=by, shape=shape, limits=limits)``: one
statistic of a column over a regular grid of bins of another."""

from __future__ import annotations

import numpy as np

from qbench.table import itemsize


def program(vt, df, q):
    stat = getattr(df, q["stat"])
    return {q["stat"]: np.asarray(stat(q["column"], binby=q["by"], shape=q["shape"],
                                       limits=q["limits"]))}


def kinds(q, config):
    """Empty bins hold NaN: where they lie is compared like keys."""
    return {q["stat"]: "float_nan"}


def reference(table, q, config, float_dtype):
    import jax
    import jax.numpy as jnp
    if q["stat"] != "mean":
        raise ValueError(f"{q['name']}: no reference for {q['stat']!r}")
    lo, hi = (float_dtype(x) for x in q["limits"])
    shape = q["shape"]

    def grids(table):
        x = table[q["by"]].astype(float_dtype)
        b = jnp.floor((x - lo) * (float_dtype(shape) / (hi - lo))).astype(jnp.int64)
        inside = (b >= 0) & (b < shape)
        b = jnp.where(inside, b, 0)
        v = jnp.where(inside, table[q["column"]].astype(float_dtype), 0)
        return (jax.ops.segment_sum(v, b, shape),
                jax.ops.segment_sum(inside.astype(jnp.int32), b, shape))

    s, c = jax.device_get(jax.jit(grids)(table))
    with np.errstate(invalid="ignore", divide="ignore"):
        return {q["stat"]: np.where(c > 0, s / c.astype(float_dtype), np.nan)}


def hbm_bytes(q, config, rows, answer):
    return (rows * (itemsize(config, q["by"]) + itemsize(config, q["column"]))
            + sum(np.asarray(a).nbytes for a in answer.values()))
