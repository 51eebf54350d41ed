"""Fused ONE-sort groupby for integer keys (the q10-class fast path).

``df.groupby(by, agg=...)`` normally runs two device sorts over the key
data: the grouper's set build (pass 1: sort + boundary compaction, the device
replacement of the reference's ordered_set, hash_primitives.hpp:418-621)
and the dense-rank aggregation sort (pass 3).  When the agg spec is known
up front, ONE carried sort can do everything: the sorted key's segment
boundaries yield the observed keys (the set), the segment lengths yield
counts, carried channels yield sums/moments, and an associative scan
yields min/max — no set build, no ordinal probe, no second sort.

Scope (bails to the classic path otherwise): integer key columns with a
memoized minmax and no nulls (the `_dense_candidates` pre-pass proves
both), aggs in {count, sum, mean, min, max, std, var}, no selections, no
filter, whole table in one sort (<= DENSE_RANK_MAX_ROWS).  On a device
mesh the same plan runs distributed (_run_mesh_compute): shard-local
carried sort -> ONE all-to-all by key range -> local merge + segment
reduce — zero set-build passes, one exchange.
Multi-key groupbys pack the keys by their RANGE spans into one int64,
and the observed fused keys decode back by div/mod — only observed
combinations appear, matching the reference's empty-cell drops
(groupby.py:488-529).  When the span product overflows int64 (q10 at
1e8 rows: 1e20) the sort instead carries the RAW key columns as its
keys (``lax.sort num_keys=k``) — a shape the reference cannot run at
all (its GrouperCombined packs into one int64 and overflows).

Exactness: integer sums ride 22-bit limb channels (exact mod 2^64, like
OpSum.additive_columns_exact); float sums are f64 cumsum differences
(same contract as the dense-rank path); variance moments ride exact
per-segment scatter sums; min/max are exact.
"""

from __future__ import annotations

import functools

import numpy as np

from .datatype import DataType
from .utils import trace

LIMB_BITS = 22
_FUSED_CACHE = {}


def _agg_plan(df, parsed):
    """(channel specs, finishers) or None when a descriptor can't ride.

    Channel kinds: 'ones' (free: counts come from segment lengths),
    'valid' (f64 0/1), 'sumf' (f64), 'sumi' (3 limb channels),
    'moment' (precise f64 x, x^2), 'min'/'max' (carried extreme).
    """
    plan = []
    for name, desc in parsed:
        if desc.selection is not None:
            return None
        e = desc.expression
        kind = desc.name
        if kind == "count" and e in (None, "*"):
            plan.append((name, "count_star", None))
            continue
        if kind not in ("count", "sum", "mean", "min", "max", "std", "var",
                        "median", "percentile"):
            return None
        try:
            dt = DataType(df.data_type(e))
        except Exception:
            return None
        if not dt.is_primitive or str(e) not in df.dataset:
            return None
        if kind in ("min", "max") and dt.numpy.kind not in "iuf" and dt.numpy.kind != "b":
            return None
        if kind in ("median", "percentile"):
            # exact per-group percentile: the value column rides the carried
            # sort as a SECOND sort key, so each segment's values come out
            # sorted and the bracketing order statistics are direct gathers.
            # One distinct value expression (one secondary key); exact=False
            # means the caller wants the binned approximation -> classic path.
            if getattr(desc, "exact", None) is False:
                return None
            pct = getattr(desc, "percentage", 50.0)
            if isinstance(pct, (list, tuple, np.ndarray)):
                return None  # multi-percentage descriptors: classic path
            plan.append((name, "pct", (str(e), dt, float(pct))))
            continue
        if kind in ("std", "var"):
            # honor the descriptor's ddof (pandas convention is 1; advisor r3
            # medium: the fused path silently computed ddof=0) — threaded into
            # fin_var and the cache key below
            plan.append((name, kind, (str(e), dt, int(getattr(desc, "ddof", 0) or 0))))
        else:
            plan.append((name, kind, (str(e), dt)))
    return plan


def try_fused_sort_groupby(df, by, actions, sort=False, ascending=True,
                           row_limit=None, delay=False):
    """The one-sort plan, or None when the query shape doesn't qualify."""
    import os
    if os.environ.get("VAEX_TPU_FUSED_GROUPBY", "1") != "1":
        return None
    if row_limit is not None or df.filtered:
        return None
    mesh = getattr(df.executor, "mesh", None)
    if mesh is not None and mesh.size <= 1:
        mesh = None
    by = by if isinstance(by, (list, tuple)) else [by]
    if not by:
        return None
    key_names = []
    for b in by:
        from .expression import Expression
        name = b.expression if isinstance(b, Expression) else b
        if not isinstance(name, str) or name not in df.dataset or df.is_category(name):
            return None
        key_names.append(name)
    ascending_list = (ascending if isinstance(ascending, (list, tuple))
                      else [ascending] * len(key_names))
    if any(a is not True for a in ascending_list) and len(key_names) > 1:
        return None  # per-key descending on packed keys: classic path
    n = len(df)
    from .groupby import DENSE_RANGE_MAX, GroupByBase, _dense_candidates
    from .tasks import TaskAggregations
    if n > TaskAggregations.DENSE_RANK_MAX_ROWS or n == 0:
        return None
    with trace("fused-groupby candidates pre-pass"):
        info = _dense_candidates(key_names, df, row_limit)
    if any(k not in info for k in key_names):
        return None  # non-integer / nullable keys: classic path
    spans = []
    for k in key_names:
        lo, hi, n_valid = info[k]
        if n_valid != n:
            return None  # nulls present
        spans.append((lo, hi - lo + 1))
    packed = True
    if len(key_names) > 1:
        product = 1.0
        for _, span in spans:
            product *= span
        if product >= 2 ** 62:
            # span product overflows int64 packing (q10 at 1e8: 1e20) —
            # sort by the RAW key columns instead (lax.sort num_keys=k).
            # The reference CANNOT run this shape at all: its combined
            # grouper packs observed cardinalities into one int64 and
            # overflows the same way (groupby.py:171 GrouperCombined)
            packed = False
    for _, span in spans:
        if not (0 < span < 2 ** 62):
            return None  # range does not fit int64 arithmetic
    parsed = GroupByBase._parse_actions(_ParseShim(df, key_names), actions)
    plan = _agg_plan(df, parsed)
    if plan is None:
        return None
    has_pct = any(kind == "pct" for _, kind, _ in plan)
    # only engage where the CLASSIC path needs a set build (its extra sort):
    # single dense-range keys ride the partition kernels with no set build
    # (q3-class: 253 ms there vs ~1 s here), and small cartesian products
    # grid directly; the win cases are sparse single keys and multi-key
    # combines (q2/q9/q10-class: set-build sort + dense-rank sort -> ONE sort).
    # Exception: a MESH query with an exact percentile always engages — the
    # replicated-grid path cannot do exact medians across row shards, the
    # fused exchange can
    if not (mesh is not None and has_pct):
        if len(key_names) == 1:
            if spans[0][1] <= DENSE_RANGE_MAX:
                return None
        else:
            product = 1
            for _, span in spans:
                product *= span
            if product <= 1_000_000:  # classic _should_combine threshold
                return None
    asc = ascending_list[0] if len(key_names) == 1 else True
    from . import cache
    from .utils import fingerprint
    cache_key = fingerprint(
        "fused-groupby", df.fingerprint(), tuple(key_names), tuple(spans), asc,
        packed,
        tuple((name, kind, payload if payload is None
               else (payload[0],) + tuple(payload[2:]))
              for name, kind, payload in plan))
    hit = cache.lookup(cache_key)
    if hit is not None:
        from . import from_dict
        result = from_dict(dict(hit))
    else:
        with trace("fused one-sort groupby"):
            result = _run(df, key_names, spans, plan, asc, mesh=mesh,
                          packed=packed)
        if result is None:
            return None
        cols = {name: result.dataset[name][:]
                for name in result.get_column_names()}
        if sum(getattr(c, "nbytes", 64) for c in cols.values()) <= (32 << 20):
            # small results cache as host numpy; big ones are not worth the
            # D2H (and would pin HBM in the default unbounded backend)
            cache.store(cache_key, {k: np.asarray(v) for k, v in cols.items()})
    from .groupby import GroupBy
    return GroupBy._maybe_delay(result, delay)


class _ParseShim:
    """Just enough of GroupByBase for the unbound _parse_actions call."""

    def __init__(self, df, key_names):
        self.df = df
        self.groupby_expression = list(key_names)


def _column_device(df, name):
    """jnp array (+mask flag) for a physical column; None on masked data."""
    import jax.numpy as jnp
    from . import array_types
    dev = df.dataset_for_execution().device_columns([name])
    if dev is not None:
        return dev[name]
    values = df.dataset[name][:]
    data, mask = array_types.data_and_mask(values)
    if mask is not None and mask.any():
        return None
    if data.dtype.kind in "Mm":
        data = data.view(np.int64)
    if data.dtype == object:
        return None
    return jnp.asarray(data)


def _run(df, key_names, spans, plan, ascending, mesh=None, packed=True):
    import jax
    import jax.numpy as jnp

    keys = []
    for name in key_names:
        col = _column_device(df, name)
        if col is None:
            return None
        keys.append(col.astype(jnp.int64))
    if packed:
        # fused int64 key from range spans (no per-key set builds)
        mult = 1
        fused = None
        mults = []
        for (lo, span), col in zip(reversed(spans), reversed(keys)):
            part = (col - lo) * mult
            fused = part if fused is None else fused + part
            mults.append((mult, span, lo))
            mult *= span
        mults = list(reversed(mults))  # per key, leading first
        key_ops = (fused,)
    else:
        # span product exceeds int64: the sort carries every raw key column
        # as its own sort key (num_keys=k) — no packing, no overflow.  Keys
        # with a PROVEN i32 range narrow losslessly (sort operand bytes are
        # the HBM bound at 1e8 rows x 6 keys); i32 max stays reserved as
        # the mesh sentinel
        mults = None

        def _narrow(col, lo_span):
            lo, span = lo_span
            hi = lo + span - 1
            if -(2 ** 31) <= lo and hi < 2 ** 31 - 1:
                return col.astype(jnp.int32)
            return col
        key_ops = tuple(_narrow(c, s) for c, s in zip(keys, spans))

    # channels
    add_cols = []       # f64 columns summed by cumsum-diff
    precise_cols = []   # f64 columns summed by exact per-segment scatter
    ext_cols = []       # (col f64, mode)
    builders = []       # (out_name, fn(env) -> column) applied after compute
    pct_expr = [None]   # the ONE value expression riding as second sort key
    pct_col = [None]
    pct_valid = [None]  # add-channel slot counting non-NaN rows, or "counts"
    pct_list = []       # requested percentages

    def valid_of(col):
        if col.dtype.kind == "f":
            return ~jnp.isnan(col)
        return None

    def add(col, precise=False):
        (precise_cols if precise else add_cols).append(col)
        return (precise, len(precise_cols) - 1 if precise else len(add_cols) - 1)

    def add_sum(col, dt):
        """Channel(s) for an exact sum; returns finisher(env)->grid."""
        import jax
        if dt.numpy.kind in "iub":
            u = jax.lax.bitcast_convert_type(col.astype(jnp.int64), jnp.uint64)
            mask = jnp.uint64((1 << LIMB_BITS) - 1)
            slots = [add(((u >> jnp.uint64(LIMB_BITS * k)) & mask).astype(jnp.float64))
                     for k in range(3)]
            out_dt = dt.upcast().numpy

            def fin(env, slots=slots, out_dt=out_dt):
                u = env(slots[0]).astype(jnp.uint64)
                for k in (1, 2):
                    u = u + (env(slots[k]).astype(jnp.uint64) << jnp.uint64(LIMB_BITS * k))
                if np.dtype(out_dt) == np.uint64:
                    return u
                return jax.lax.bitcast_convert_type(u, jnp.int64).astype(out_dt)
            return fin
        v = valid_of(col)
        c = col.astype(jnp.float64)
        if v is not None:
            c = jnp.where(v, c, 0.0)
        slot = add(c)
        return lambda env, slot=slot: env(slot)

    for name, kind, payload in plan:
        if kind == "count_star":
            builders.append((name, lambda env: env("counts")))
            continue
        expr, dt = payload[0], payload[1]
        col = _column_device(df, expr)
        if col is None:
            return None
        v = valid_of(col)
        if kind == "count":
            if v is None:
                builders.append((name, lambda env: env("counts")))
            else:
                slot = add(v.astype(jnp.float64))
                builders.append((name, lambda env, slot=slot: env(slot).astype(jnp.int64)))
        elif kind == "sum":
            builders.append((name, add_sum(col, dt)))
        elif kind == "mean":
            c = col.astype(jnp.float64)
            c = jnp.where(v, c, 0.0) if v is not None else c
            s = add(c)
            cnt = add(v.astype(jnp.float64)) if v is not None else "counts"

            def fin_mean(env, s=s, cnt=cnt):
                d = env(cnt).astype(jnp.float64)
                return jnp.where(d > 0, env(s) / d, jnp.nan)
            builders.append((name, fin_mean))
        elif kind in ("min", "max"):
            from .ops import gridagg
            c = col.astype(jnp.float64) if dt.numpy.kind == "f" else col
            fill = gridagg.min_identity(c.dtype) if kind == "min" else gridagg.max_identity(c.dtype)
            if v is not None:
                c = jnp.where(v, c, jnp.asarray(fill, c.dtype))
            ext_cols.append((c, kind))
            e = len(ext_cols) - 1
            out_dt = dt.numpy if dt.numpy.kind != "f" else None

            def fin_ext(env, e=e, out_dt=out_dt):
                g = env(("ext", e))
                return g if out_dt is None else g.astype(out_dt)
            builders.append((name, fin_ext))
        elif kind in ("std", "var"):
            c = col.astype(jnp.float64)
            c = jnp.where(v, c, 0.0) if v is not None else c
            i = add(c, precise=True)
            j = add(c * c, precise=True)
            cnt = add(v.astype(jnp.float64)) if v is not None else "counts"
            ddof = payload[2]
            is_std = kind == "std"

            def fin_var(env, i=i, j=j, cnt=cnt, ddof=ddof, is_std=is_std):
                d = env(cnt).astype(jnp.float64)
                mean = env(i) / d
                var = jnp.maximum(env(j) / d - mean ** 2, 0.0)
                if ddof:
                    var = jnp.where(d > ddof, var * d / (d - ddof), jnp.nan)
                var = jnp.where(d > 0, var, jnp.nan)
                return jnp.sqrt(var) if is_std else var
            builders.append((name, fin_var))
        elif kind == "pct":
            if pct_expr[0] is None:
                pct_expr[0] = expr
                c = col.astype(jnp.float64)
                # NaN -> +inf: sorts past every real value, and the valid
                # count keeps ranks from ever reaching the mapped tail
                pct_col[0] = jnp.where(v, c, jnp.inf) if v is not None else c
                pct_valid[0] = (add(v.astype(jnp.float64))
                                if v is not None else "counts")
            elif pct_expr[0] != expr:
                return None  # one secondary sort key only: classic path
            j = len(pct_list)
            pct_list.append(float(payload[2]))
            builders.append((name, lambda env, j=j: env(("pct", j))))

    pct_spec = None
    if pct_list:
        valid_idx = (None if pct_valid[0] == "counts" else pct_valid[0][1])
        pct_spec = (tuple(pct_list), valid_idx)
    if mesh is not None:
        out = _run_mesh_compute(df, mesh, key_ops, add_cols, precise_cols,
                                [c for c, _ in ext_cols],
                                tuple(m for _, m in ext_cols),
                                pct_spec=pct_spec, pct_col=pct_col[0])
        if out is None:
            return None
        ukeys, counts, sums, psums, exts, pvals, G = out
    else:
        n_rows = key_ops[0].shape[0]
        # device-memory accounting: the carried compaction roughly
        # quintuples the sorted-operand bytes (sort in+out, cumsums, comp
        # in+out); shapes past 60% of the device budget take the lean
        # (gather-boundary) variant
        from .utils import device_memory_budget
        op_bytes = sum(np.dtype(k.dtype).itemsize for k in key_ops)
        op_bytes += sum(np.dtype(c.dtype).itemsize
                        for c in list(add_cols) + list(precise_cols)
                        + [c for c, _ in ext_cols])
        lean = (n_rows * op_bytes * 5 > 0.6 * device_memory_budget()
                and n_rows < (1 << 30))  # bit 30 carries the end flag
        compute = _get_compiled(n_rows, len(add_cols),
                                len(precise_cols),
                                tuple(m for _, m in ext_cols),
                                pct_spec=pct_spec, n_keys=len(key_ops),
                                lean=lean)
        args = [key_ops, add_cols, precise_cols, [c for c, _ in ext_cols]]
        if pct_spec is not None:
            args.append(pct_col[0])
        ukeys, counts, sums, psums, exts, pvals, G = compute(*args)
        G = int(G)

    env_values = {"counts": counts[:G].astype(jnp.int64)}

    def env(slot):
        if slot == "counts":
            return env_values["counts"]
        if isinstance(slot, tuple) and slot[0] == "ext":
            return exts[slot[1]][:G]
        if isinstance(slot, tuple) and slot[0] == "pct":
            return pvals[slot[1]][:G]
        precise, idx = slot
        return (psums[idx][:G] if precise else sums[idx][:G])

    columns = {}
    if packed:
        uk = ukeys[0][:G]
        for name, (m, span, lo) in zip(key_names, mults):
            ordin = (uk // m) % span + lo
            columns[name] = ordin.astype(jnp.int64)
    else:
        # unpacked: the raw key columns rode both sorts — no decode, only
        # a widen back to the logical dtype where the sort ran narrowed
        for name, uk, orig in zip(key_names, ukeys, keys):
            columns[name] = uk[:G].astype(orig.dtype)
    for name, fin in builders:
        columns[name] = fin(env)
    if not ascending:
        columns = {k: v[::-1] for k, v in columns.items()}
    # results STAY device-resident: a 1e7-group q10 result is ~0.6 GB
    # across key+value columns — the D2H only happens if the user
    # materializes
    from . import from_dict
    return from_dict(columns)


def _run_mesh_compute(df, mesh, key_ops, add_cols, precise_cols, ext_vals,
                      ext_modes, pct_spec=None, pct_col=None,
                      slack=2, max_retries=4):
    """Distributed one-sort groupby: shard-local carried sort
    -> ONE all-to-all by key range -> local merge + segment reduce.  No set
    build: the reference's partitioned hashmaps
    (hash_primitives.hpp:96-281) exchange rows into per-worker maps; here the
    exchange carries the already-sorted runs and each device owns the key
    range [d*ceil(S/D), (d+1)*ceil(S/D)), so concatenating per-device
    results in device order yields the globally sorted groups directly.

    Returns (ukeys, counts, sums, psums, exts, G) with arrays of exact
    length G (device-resident), or None when slack retries are exhausted
    (pathological key skew -> classic path)."""
    for attempt in range(max_retries + 1):
        out = _mesh_attempt(df, mesh, key_ops, add_cols, precise_cols, ext_vals,
                            ext_modes, pct_spec, pct_col, slack)
        if out is not None:
            return out
        slack *= 2
    return None


def _mesh_attempt(df, mesh, key_ops, add_cols, precise_cols, ext_vals,
                  ext_modes, pct_spec, pct_col, slack):
    import jax
    import jax.numpy as jnp
    from .ops import gridagg

    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    N = key_ops[0].shape[0]
    pad = (-N) % D
    n_pad_total = N + pad
    n_local = n_pad_total // D
    cap = max(64, (slack * n_local) // D)

    if pad:
        key_ops = tuple(jnp.concatenate(
            [k, jnp.full((pad,), jnp.iinfo(k.dtype).max, k.dtype)])
            for k in key_ops)
        add_cols = [jnp.concatenate([c, jnp.zeros(pad, c.dtype)]) for c in add_cols]
        precise_cols = [jnp.concatenate([c, jnp.zeros(pad, c.dtype)])
                        for c in precise_cols]
        ext_vals = [jnp.concatenate(
            [c, jnp.full(pad, gridagg.min_identity(c.dtype) if m == "min"
                         else gridagg.max_identity(c.dtype), c.dtype)])
            for c, m in zip(ext_vals, ext_modes)]
        if pct_col is not None:
            pct_col = jnp.concatenate([pct_col, jnp.full(pad, jnp.inf)])

    compute = _get_compiled_mesh(mesh, n_pad_total, len(add_cols),
                                 len(precise_cols), ext_modes, cap,
                                 pct_spec=pct_spec, n_keys=len(key_ops))
    ukeys_g, counts_g, sums_g, psums_g, exts_g, pvals_g, G_dev, dropped = \
        compute(key_ops, add_cols, precise_cols, ext_vals, pct_col)
    if int(np.asarray(dropped).ravel()[0]):
        return None
    Gs = np.asarray(G_dev)                       # [D] host sync (one scalar/dev)
    G = int(Gs.sum())
    capt = D * cap

    def gather(arr):
        parts = [arr[d * capt: d * capt + int(Gs[d])] for d in range(D)
                 if int(Gs[d])]
        if not parts:
            return arr[:0]
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    ukeys = tuple(gather(k) for k in ukeys_g)
    counts = gather(counts_g)
    sums = [gather(s) for s in sums_g]
    psums = [gather(s) for s in psums_g]
    exts = [gather(s) for s in exts_g]
    pvals = [gather(s) for s in pvals_g]
    log = getattr(df.executor, "trace_log", None)
    if log is not None:
        row_bytes = 8 + 8 * (len(add_cols) + len(precise_cols)) + sum(
            int(np.dtype(c.dtype).itemsize) for c in ext_vals)
        log.append({"fused_mesh_groupby": True, "devices": int(D),
                    "rows": int(N), "groups": G, "exchanges": 1,
                    "set_build_passes": 0, "slack": slack,
                    "rows_per_device": int(n_pad_total // D),
                    "capacity_rows_per_device": int(capt),
                    "row_bytes": int(row_bytes),
                    "alltoall_bytes_per_device": int(capt * row_bytes)})
    return ukeys, counts, sums, psums, exts, pvals, G


_MESH_CACHE = {}


def _get_compiled_mesh(mesh, n, n_add, n_precise, ext_modes, cap,
                       pct_spec=None, n_keys=1):
    key = (mesh, n, n_add, n_precise, ext_modes, cap, pct_spec, n_keys)
    if key in _MESH_CACHE:
        return _MESH_CACHE[key]
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from .ops import gridagg

    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    nl = n // D

    n_pct_chan = 1 if pct_spec is not None else 0

    def local(*args):
        keys_l = args[:n_keys]
        chans = args[n_keys:]   # [pct_col?] + add + precise + ext
        # key-range ownership from the GLOBAL extent of the LEADING key
        # (psum'd min/max): groups share all keys, so partitioning on the
        # first alone never splits a group across devices.  The per-dtype
        # max is the sentinel (sorts after every real key; the unpacked
        # narrowing reserves it)
        k0 = keys_l[0]
        SENT = jnp.iinfo(k0.dtype).max
        real = k0 < SENT
        kmin = jax.lax.pmin(jnp.min(jnp.where(real, k0, SENT)), axis)
        kmax = jax.lax.pmax(jnp.max(jnp.where(
            real, k0, jnp.iinfo(k0.dtype).min)), axis)
        rng_sz = jnp.maximum((kmax.astype(jnp.int64)
                              - kmin.astype(jnp.int64)) // D + 1, 1)

        # ONE carried sort by the key columns: owner order == key order
        sorted_out = jax.lax.sort(tuple(keys_l) + tuple(chans), num_keys=n_keys)
        skeys = sorted_out[:n_keys]
        scarry = sorted_out[n_keys:]
        sk0 = skeys[0]
        sowner = jnp.where(sk0 >= SENT, D,
                           jnp.clip((sk0.astype(jnp.int64) - kmin) // rng_sz,
                                    0, D - 1)).astype(jnp.int32)
        idx = jax.lax.broadcasted_iota(jnp.int32, (nl, 1), 0).squeeze(-1)
        bounds = kmin.astype(jnp.int64) + jnp.arange(D + 1, dtype=jnp.int64) * rng_sz
        start = jnp.searchsorted(sk0.astype(jnp.int64), bounds)
        rank = idx - start[jnp.clip(sowner, 0, D - 1)].astype(jnp.int32)
        overflow = jnp.sum((rank >= cap) & (sowner < D))
        dest = jnp.where((sowner < D) & (rank < cap),
                         sowner * cap + rank, D * cap)

        def pack(vals, fill):
            buf = jnp.full((D * cap,), fill, vals.dtype)
            return buf.at[dest].set(vals, mode="drop").reshape(D, cap)

        send_keys = [pack(k, jnp.iinfo(k.dtype).max) for k in skeys]
        send_carry = []
        for c, col in enumerate(scarry):
            if c < n_pct_chan:
                fill = jnp.asarray(jnp.inf, col.dtype)
            elif c >= n_pct_chan + n_add + n_precise:
                mode = ext_modes[c - n_pct_chan - n_add - n_precise]
                fill = (gridagg.min_identity(col.dtype) if mode == "min"
                        else gridagg.max_identity(col.dtype))
            else:
                fill = jnp.zeros((), col.dtype)
            send_carry.append(pack(col, fill))

        recv_keys = [jax.lax.all_to_all(b, axis, 0, 0, tiled=False)
                     for b in send_keys]
        recv_carry = [jax.lax.all_to_all(b, axis, 0, 0, tiled=False)
                      for b in send_carry]

        # local merge of the D sorted runs + the single-device fused plan;
        # the pct column is an EXTRA sort key so segment values come out
        # sorted (exact per-group percentile)
        m = D * cap
        out = jax.lax.sort(tuple(b.reshape(-1) for b in recv_keys)
                           + tuple(b.reshape(-1) for b in recv_carry),
                           num_keys=n_keys + n_pct_chan)
        k2s = out[:n_keys]
        s_pct = out[n_keys] if n_pct_chan else None
        base = n_keys + n_pct_chan
        s_add = out[base:base + n_add]
        s_prec = out[base + n_add:base + n_add + n_precise]
        s_ext = out[base + n_add + n_precise:]
        valid = k2s[0] < SENT
        end_any = _seg_ends(k2s)
        end_flag = end_any & valid
        G_l = jnp.sum(end_flag.astype(jnp.int32))
        rows = jnp.arange(m, dtype=jnp.int32)

        csums = [jnp.cumsum(c) for c in s_add]
        scanned_ext = [_scan_extreme(k2s, col, mode)
                       for col, mode in zip(s_ext, ext_modes)]

        comp_ops = ((1 - end_flag.astype(jnp.int32),) + tuple(k2s)
                    + (rows,) + tuple(csums) + tuple(scanned_ext))
        comp = jax.lax.sort(comp_ops, num_keys=1, is_stable=True)
        ukeys = comp[1:1 + n_keys]
        ends = comp[1 + n_keys]
        base2 = 2 + n_keys
        prev_ends = jnp.concatenate([jnp.full(1, -1, jnp.int32), ends[:-1]])
        counts = jnp.where(rows < G_l, ends - prev_ends, 0)
        sums = []
        for a in range(n_add):
            ce = comp[base2 + a]
            prev = jnp.concatenate([jnp.zeros(1, ce.dtype), ce[:-1]])
            sums.append(jnp.where(rows < G_l, ce - prev, 0))
        exts = [comp[base2 + n_add + e] for e in range(len(ext_modes))]
        psums = []
        if n_precise:
            seg = jnp.cumsum(end_any.astype(jnp.int32)) - end_any.astype(jnp.int32)
            pcols = jnp.stack(s_prec, axis=1)
            ps = jax.ops.segment_sum(pcols, seg, num_segments=m,
                                     indices_are_sorted=True)
            psums = [ps[:, a] for a in range(n_precise)]
        pvals = _segment_percentiles(pct_spec, s_pct, ends, counts, sums)
        return (*ukeys, counts, *sums, *psums, *exts, *pvals,
                G_l.reshape(1), jax.lax.psum(overflow, axis).reshape(1))

    n_pvals = len(pct_spec[0]) if pct_spec is not None else 0
    n_out_arrays = 1 + n_keys + n_add + n_precise + len(ext_modes) + n_pvals
    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(axis),) * (n_keys + n_pct_chan + n_add + n_precise
                                              + len(ext_modes)),
                       out_specs=(P(axis),) * (n_out_arrays + 1) + (P(),),
                       check_vma=False)
    jitted = jax.jit(lambda ks, pc, a, p, e: fn(*ks, *pc, *a, *p, *e))

    def compute(key_ops, add_cols, precise_cols, ext_vals, pct_col=None):
        pc = (pct_col,) if n_pct_chan else ()
        out = jitted(tuple(key_ops), pc, tuple(add_cols), tuple(precise_cols),
                     tuple(ext_vals))
        ukeys = tuple(out[:n_keys])
        counts = out[n_keys]
        o = n_keys + 1
        sums = list(out[o:o + n_add])
        psums = list(out[o + n_add:o + n_add + n_precise])
        exts = list(out[o + n_add + n_precise:
                        o + n_add + n_precise + len(ext_modes)])
        pvals = list(out[o + n_add + n_precise + len(ext_modes):n_out_arrays])
        G_dev, dropped = out[n_out_arrays], out[n_out_arrays + 1]
        return ukeys, counts, sums, psums, exts, pvals, G_dev, dropped

    _MESH_CACHE[key] = compute
    return compute


def _seg_ends(skeys):
    """end-of-segment flags from one or several sorted key columns
    (multi-key: a segment ends where ANY key changes)."""
    import jax.numpy as jnp
    end = skeys[0][1:] != skeys[0][:-1]
    for k in skeys[1:]:
        end = end | (k[1:] != k[:-1])
    return jnp.concatenate([end, jnp.ones(1, bool)])


def _scan_extreme(skeys, col, mode):
    """Segmented forward scan: the full-segment extreme lands at the
    segment's last row; segment identity = equality of ALL key columns."""
    import jax
    import jax.numpy as jnp
    cmb = jnp.minimum if mode == "min" else jnp.maximum

    def combine(a, b):
        a_keys, a_v = a[:-1], a[-1]
        b_keys, b_v = b[:-1], b[-1]
        same = a_keys[0] == b_keys[0]
        for ak, bk in zip(a_keys[1:], b_keys[1:]):
            same = same & (ak == bk)
        return (*b_keys, jnp.where(same, cmb(a_v, b_v), b_v))
    out = jax.lax.associative_scan(combine, (*skeys, col))
    return out[-1]


def _get_compiled(n, n_add, n_precise, ext_modes, pct_spec=None, n_keys=1,
                  lean=False):
    """One jitted program: carried sort + boundary compaction + segment
    reduces, returning fixed-capacity [n] outputs plus the observed count G
    (the only host-synced scalar).  With pct_spec=(pcts, valid_add_idx) the
    value column rides as an EXTRA sort key, so per-segment order
    statistics are direct gathers (exact percentile).
    n_keys > 1: the sort carries the raw key columns as its keys — the
    unpacked multi-key mode for span products past int64.

    ``lean``: the memory-bounded variant for shapes whose carried
    compaction would not fit the device budget.  The compaction sort
    shrinks to ONE i32 operand (end-flag folded into the row id's bit 30 —
    ends sort first, ordered by row, no stability needed) and
    keys/cumsums/extremes are recovered by boundary GATHERS at the
    compacted end rows — one extra random-access read per column, so only
    the over-memory shapes take this route."""
    key = (n, n_add, n_precise, ext_modes, pct_spec, n_keys, lean)
    if key in _FUSED_CACHE:
        return _FUSED_CACHE[key]
    import jax
    import jax.numpy as jnp
    from .ops import gridagg

    def run(key_ops, add_cols, precise_cols, ext_vals, *maybe_pct):
        carry = list(add_cols) + list(precise_cols) + list(ext_vals)
        nk = n_keys + (1 if pct_spec is not None else 0)
        head = tuple(key_ops) + tuple(maybe_pct)
        out = jax.lax.sort(head + tuple(carry), num_keys=nk)
        skeys = out[:n_keys]
        s_pct = out[n_keys] if pct_spec is not None else None
        base = len(head)
        s_add = out[base:base + n_add]
        s_prec = out[base + n_add:base + n_add + n_precise]
        s_ext = out[base + n_add + n_precise:]

        end_flag = _seg_ends(skeys)
        G = jnp.sum(end_flag.astype(jnp.int32))
        rows = jnp.arange(n, dtype=jnp.int32)

        # per-channel inclusive cumsums: the value AT a segment's last row is
        # the prefix total, so adjacent diffs of the COMPACTED end rows give
        # segment sums (same cumsum-difference contract as the sort paths)
        csums = [jnp.cumsum(c) for c in s_add]
        # extremes: a segmented forward scan leaves the full-segment extreme
        # at the segment's last row
        scanned_ext = [_scan_extreme(skeys, col, mode)
                       for col, mode in zip(s_ext, ext_modes)]

        if lean:
            # ends first (bit 30 clear), ordered by row; everything else
            # recovered by gathers at the compacted boundary rows
            packed = jnp.where(end_flag, rows, rows | jnp.int32(1 << 30))
            ends = jax.lax.sort(packed) & jnp.int32((1 << 30) - 1)
            safe = jnp.clip(ends, 0, n - 1)
            ukeys = [sk[safe] for sk in skeys]
            prev_ends = jnp.concatenate([jnp.full(1, -1, jnp.int32), ends[:-1]])
            counts = jnp.where(rows < G, ends - prev_ends, 0)
            prev_safe = jnp.clip(prev_ends, 0, n - 1)
            sums = []
            for ce_full in csums:
                upper = ce_full[safe]
                lower = jnp.where(prev_ends >= 0, ce_full[prev_safe],
                                  jnp.zeros((), ce_full.dtype))
                sums.append(jnp.where(rows < G, upper - lower, 0))
            exts = [se[safe] for se in scanned_ext]
        else:
            # compaction: ONE stable sort moves segment-end rows to the
            # front in order (measured 76 ms vs 477 ms for the scatter +
            # blocked-prefix + gather formulation it replaces) carrying
            # keys, row ids, csums and scanned extremes together
            comp_ops = ((1 - end_flag.astype(jnp.int32),) + tuple(skeys)
                        + (rows,) + tuple(csums) + tuple(scanned_ext))
            comp = jax.lax.sort(comp_ops, num_keys=1, is_stable=True)
            ukeys = comp[1:1 + n_keys]
            ends = comp[1 + n_keys]
            base2 = 2 + n_keys
            prev_ends = jnp.concatenate([jnp.full(1, -1, jnp.int32), ends[:-1]])
            counts = jnp.where(rows < G, ends - prev_ends, 0)
            sums = []
            for a in range(n_add):
                ce = comp[base2 + a]
                prev = jnp.concatenate([jnp.zeros(1, ce.dtype), ce[:-1]])
                sums.append(jnp.where(rows < G, ce - prev, 0))
            exts = [comp[base2 + n_add + e] for e in range(len(ext_modes))]
        psums = []
        if n_precise:
            seg = jnp.cumsum(end_flag.astype(jnp.int32)) - end_flag.astype(jnp.int32)
            pcols = jnp.stack(s_prec, axis=1)
            ps = jax.ops.segment_sum(pcols, seg, num_segments=n,
                                     indices_are_sorted=True)
            psums = [ps[:, a] for a in range(n_precise)]
        pvals = _segment_percentiles(pct_spec, s_pct, ends, counts, sums)
        return ukeys, counts, sums, psums, exts, pvals, G

    _FUSED_CACHE[key] = jax.jit(run)
    return _FUSED_CACHE[key]


def _segment_percentiles(pct_spec, s_pct, ends, counts, sums):
    """Per-segment exact percentiles from the (key, value)-sorted column.

    ends: compacted segment-end row indices; segment i occupies
    [prev_end+1, ends[i]] of the sorted arrays with its values SORTED (the
    value column was the second sort key).  NaNs were mapped to +inf by the
    caller, and nv (the non-NaN count) keeps ranks below the mapped tail."""
    import jax.numpy as jnp
    from .ops import gridagg
    if pct_spec is None:
        return []
    pcts, valid_idx = pct_spec
    prev_ends = jnp.concatenate([jnp.full(1, -1, ends.dtype), ends[:-1]])
    starts = (prev_ends + 1).astype(jnp.int32)
    nv = (counts.astype(jnp.float64) if valid_idx is None else sums[valid_idx])
    return [gridagg.interp_order_stats(s_pct, starts, nv, pct) for pct in pcts]
