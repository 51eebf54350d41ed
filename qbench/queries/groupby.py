"""``df.groupby(by, agg=..., sort=True)`` on integer keys.

The reference bins every row by its key code (the keys' value ranges are
the configuration's) with plain ``jax.numpy`` segment reductions and keeps
the groups that hold rows, in ascending key order."""

from __future__ import annotations

import numpy as np

from qbench.table import itemsize


def program(vt, df, q):
    agg = {out: getattr(vt.agg, fn)(col) for out, (fn, col) in q["aggs"].items()}
    res = df.groupby(list(q["by"]), agg=agg, sort=True)
    return {c: np.asarray(res[c].to_numpy()) for c in list(q["by"]) + list(q["aggs"])}


def kinds(q, config):
    """Each answer column: "key", "exact" (integer sums, extremes) or "float"."""
    out = {k: "key" for k in q["by"]}
    for name, (fn, col) in q["aggs"].items():
        is_int = config["columns"][col]["dtype"].startswith("int")
        out[name] = "exact" if fn in ("min", "max", "count") or (fn == "sum" and is_int) \
            else "float"
    return out


def reference(table, q, config, float_dtype):
    """The answer computed from the table, with float arithmetic in
    ``float_dtype`` (float64 as the configuration states; float32 for the
    control)."""
    import jax
    import jax.numpy as jnp
    spans = [(config["columns"][k]["low"], config["columns"][k]["high"]) for k in q["by"]]
    sizes = [hi - lo + 1 for lo, hi in spans]
    G = int(np.prod(sizes))

    def grids(table):
        code = jnp.zeros(table[q["by"][0]].shape, jnp.int64)
        for k, (lo, _), size in zip(q["by"], spans, sizes):
            code = code * size + (table[k] - lo)
        out = {"__count": jax.ops.segment_sum(jnp.ones_like(code, jnp.int32), code, G)}
        for name, (fn, col) in q["aggs"].items():
            v = table[col]
            if v.dtype.kind == "f":
                v = v.astype(float_dtype)
            if fn in ("sum", "mean"):
                out[name] = jax.ops.segment_sum(v, code, G)
            elif fn == "min":
                out[name] = jax.ops.segment_min(v, code, G)
            elif fn == "max":
                out[name] = jax.ops.segment_max(v, code, G)
            elif fn == "count":
                out[name] = out["__count"]
            else:
                raise ValueError(f"{q['name']}: no reference for {fn!r}")
        return out

    g = jax.device_get(jax.jit(grids)(table))
    present = g.pop("__count")
    rows = np.flatnonzero(present > 0)
    count = present[rows].astype(float_dtype)
    out = {}
    rest = rows
    for k, (lo, _), size in reversed(list(zip(q["by"], spans, sizes))):
        out[k] = (rest % size + lo).astype(np.int64)
        rest = rest // size
    for name, (fn, _) in q["aggs"].items():
        v = g[name][rows]
        out[name] = (v.astype(float_dtype) / count) if fn == "mean" else v
    return {c: out[c] for c in list(q["by"]) + list(q["aggs"])}


def hbm_bytes(q, config, rows, answer):
    """Every column the query reads, once, plus the answer it writes."""
    cols = set(q["by"]) | {col for _, col in q["aggs"].values()}
    return (rows * sum(itemsize(config, c) for c in cols)
            + sum(np.asarray(a).nbytes for a in answer.values()))
