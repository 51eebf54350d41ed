"""Aggregator descriptors: ``vaex_tpu.agg.count/sum/mean/min/max/...``.

Re-design of the reference's ``vaex/agg.py`` (304 LoC).  A descriptor is a
small declarative object; ``add_tasks`` binds it to a DataFrame + binner stack
by registering an :class:`AggOperation` on the pass's shared
:class:`~vaex_tpu.tasks.TaskAggregations`.  Operations own their accumulator
grids (device arrays in the pass state) and the traced ``update`` that
scatters a tile into them (:mod:`vaex_tpu.ops.gridagg`).

Dtype contract (reference agg.py:90-100 _prepare_types, superagg.cpp):
count -> int64; sum/_sum_moment upcast int->int64, uint->uint64, f32->f64;
min/max keep the input dtype; mean/var/std are float64 finishers over
sum/count/moment grids.
"""

from __future__ import annotations

import builtins

import numpy as np

from .datatype import DataType
from .delayed import delayed
from .ops import gridagg
from .utils import fingerprint


def extract_central(grid, ndim):
    """Strip the +3 edges from the leading ndim axes (reference agg.py:116-120)."""
    index = tuple(slice(2, -1) for _ in range(ndim))
    return grid[index]


class AggOperation:
    """One (aggregator, selection) pair bound into a pass."""

    name = "op"

    def __init__(self, expressions, selection=None, dtype_in=None, dtype_out=None):
        self.expressions = [str(e) for e in expressions if e is not None]
        self.selection = selection
        self.dtype_in = dtype_in
        self.dtype_out = dtype_out

    def selection_expressions(self):
        sel = self.selection
        if sel is None or sel is False or sel is True:
            return []
        return [str(sel)]

    def fingerprint(self):
        return fingerprint(type(self).__name__, self.name, self.expressions,
                           str(self.selection), str(self.dtype_in), str(self.dtype_out))

    def _valid(self, ctx):
        return ctx.selection_valid(self.selection)

    def _input(self, ctx, i=0):
        """The i-th input value with datetime NaT folded into the null mask.

        Datetimes ride the device as an int64 view, so NaT arrives as
        int64-min and would otherwise look like a real (extreme) value to
        min/max/count/nunique — pandas and the reference both skip it
        (advisor r3 low)."""
        import jax.numpy as jnp
        x = ctx.expr(self.expressions[i])
        dt = DataType(self.dtype_in) if self.dtype_in is not None else None
        if (dt is not None and (dt.is_datetime or dt.is_timedelta)
                and jnp.issubdtype(x.data.dtype, jnp.integer)):
            from .ops.nullable import NA
            nat = x.data == jnp.asarray(np.iinfo(np.int64).min, x.data.dtype)
            x = NA(x.data, nat if x.mask is None else (x.mask | nat))
        return x

    def initial_state(self, G):
        raise NotImplementedError

    def update(self, state, flat_idx, ctx):
        raise NotImplementedError

    def get_result(self, state):
        raise NotImplementedError

    def merge(self, state, delta, axis_name):
        """Fold one tile's per-device delta into the replicated state across
        a mesh axis (the SPMD replacement of the reference's per-thread
        task-part tree reduce, execution.py:276-287).  Default: additive."""
        import jax
        return tuple(s + jax.lax.psum(d, axis_name) for s, d in zip(state, delta))


def _bounded_bits_of(value_bound):
    """Bit bound b with every |value| < 2^b, or None without a bound."""
    if value_bound is None:
        return None
    lo, hi = value_bound
    return builtins.max(int(abs(int(lo))).bit_length(),
                        int(abs(int(hi))).bit_length()) + 1


class OpCount(AggOperation):
    name = "count"

    def initial_state(self, G):
        import jax.numpy as jnp
        return (jnp.zeros(G, jnp.int64),)

    def update(self, state, flat_idx, ctx):
        valid = self._valid(ctx)
        if self.expressions:  # count(expr): skip NaN/null values
            x = self._input(ctx)
            valid = gridagg.value_valid(x, valid)
        return (gridagg.grid_count(state[0], flat_idx, valid),)

    def get_result(self, state):
        return state[0]

    def additive_column(self, ctx):
        import jax.numpy as jnp
        valid = self._valid(ctx)
        if self.expressions:
            x = self._input(ctx)
            valid = gridagg.value_valid(x, valid)
        return valid.astype(jnp.int64)

    def apply_additive(self, state, grid_col):
        return (state[0] + grid_col.astype(state[0].dtype),)


class OpSum(AggOperation):
    name = "sum"

    # 22-bit limbs: 3 cover 64 bits + sign; per-tile limb segment sums stay
    # <= 2^22 * 2^24 rows = 2^46 — exactly representable through the f64
    # cumsum of the sort path, so integer sums are EXACT (wraparound mod
    # 2^64, like the reference's C++ int64 accumulation, superagg.cpp:350)
    LIMB_BITS = 22
    LIMB_COUNT = 3

    # optional (lo, hi) value range from a minmax pre-pass: values proven
    # small need fewer limb channels — still EXACT, the dropped high limbs
    # are identically zero (the sort cost scales with channel count)
    value_bound = None

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.value_bound)

    def _bounded_bits(self):
        return _bounded_bits_of(self.value_bound)

    def initial_state(self, G):
        import jax.numpy as jnp
        return (jnp.zeros(G, DataType(self.dtype_in).upcast().numpy),)

    def update(self, state, flat_idx, ctx):
        x = self._input(ctx)
        return (gridagg.grid_sum(state[0], flat_idx, x, self._valid(ctx)),)

    def get_result(self, state):
        return state[0]

    def additive_column(self, ctx):
        """Masked values: int64 for integer inputs (uint64 keeps its bits,
        so int64 sums wrap mod 2^64 like the state), float64 otherwise."""
        import jax
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        d = x.data
        if self._limb_exact():
            if d.dtype == jnp.uint64:
                d = jax.lax.bitcast_convert_type(d, jnp.int64)
            return jnp.where(valid, d.astype(jnp.int64), jnp.int64(0))
        return jnp.where(valid, d, jnp.zeros((), d.dtype)).astype(jnp.float64)

    def apply_additive(self, state, grid_col):
        import jax
        import jax.numpy as jnp
        if grid_col.dtype == jnp.int64 and state[0].dtype == jnp.uint64:
            grid_col = jax.lax.bitcast_convert_type(grid_col, jnp.uint64)
        return (state[0] + grid_col.astype(state[0].dtype),)

    def _limb_exact(self):
        dt = DataType(self.dtype_in)
        return dt.upcast().numpy.kind in "iu" and dt.device.kind in "iub"

    def additive_columns_exact(self, ctx):
        """Integer inputs -> two's-complement limb columns (None for floats).

        Used by the sort paths, whose float64 cumsums stay exact on limbs.
        """
        if not self._limb_exact():
            return None
        import jax
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        d = x.data
        if d.dtype == jnp.uint64:
            u = d
        else:
            # smaller ints sign-extend, smaller uints zero-extend; the final
            # bitcast preserves two's-complement bits for int64
            u = jax.lax.bitcast_convert_type(d.astype(jnp.int64), jnp.uint64)
        u = jnp.where(valid, u, jnp.uint64(0))
        n_limbs = self.LIMB_COUNT
        bits = self._bounded_bits()
        if bits is not None and self.value_bound[0] >= 0:
            # nonnegative bounded values: high two's-complement limbs are
            # identically zero, dropping them keeps the sum exact
            n_limbs = builtins.min(n_limbs, -(-bits // self.LIMB_BITS))
        mask = jnp.uint64((1 << self.LIMB_BITS) - 1)
        return [((u >> jnp.uint64(self.LIMB_BITS * k)) & mask).astype(jnp.float64)
                for k in range(n_limbs)]

    def apply_additive_exact(self, state, grid_slab):
        """grid_slab [G, LIMB_COUNT] f64 limb sums -> exact mod-2^64 delta."""
        import jax
        import jax.numpy as jnp
        u = grid_slab[:, 0].astype(jnp.uint64)
        for k in range(1, grid_slab.shape[1]):
            u = u + (grid_slab[:, k].astype(jnp.uint64) << jnp.uint64(self.LIMB_BITS * k))
        if state[0].dtype == jnp.uint64:
            delta = u
        else:
            delta = jax.lax.bitcast_convert_type(u, jnp.int64).astype(state[0].dtype)
        return (state[0] + delta,)


class OpSumMoment(AggOperation):
    name = "summoment"
    # var/std subtract mean^2 from these sums: cumsum-difference residue
    # would turn the std of a constant cell into sqrt(noise), so sort-path
    # segment sums use exact per-segment scatter-adds for moments
    precise_additive = True

    def __init__(self, expressions, moment, **kwargs):
        super().__init__(expressions, **kwargs)
        self.moment = moment

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.moment)

    def initial_state(self, G):
        import jax.numpy as jnp
        return (jnp.zeros(G, jnp.float64),)

    def update(self, state, flat_idx, ctx):
        x = self._input(ctx)
        return (gridagg.grid_sum_moment(state[0], flat_idx, x, self._valid(ctx), self.moment),)

    def get_result(self, state):
        return state[0]

    def additive_column(self, ctx):
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        v = x.data.astype(jnp.float64)
        return jnp.where(valid, v ** self.moment, jnp.zeros((), jnp.float64))

    def apply_additive(self, state, grid_col):
        return (state[0] + grid_col.astype(state[0].dtype),)


def _narrow_extreme_dtype(op):
    """int32 when a wide-int extreme column's PROVEN bounds fit strictly
    inside int32 (the narrow identity then never collides with data) —
    the packed single-key extreme sort (gridagg.extreme_packed) needs a
    32-bit order map, and H2O's v1/v2 are int64 with tiny values."""
    import numpy as np
    dt = DataType(op.dtype_in).device
    vb = op.value_bound
    if (np.dtype(dt).kind in "iu" and np.dtype(dt).itemsize == 8
            and vb is not None
            and -(2 ** 31) < int(vb[0]) and int(vb[1]) < 2 ** 31 - 1):
        return np.dtype("int32")
    return None


def _apply_extreme_narrowed(state, grid_col, mode):
    """Merge a possibly-narrowed extreme grid into the wide state: the
    narrow identity (int32 min/max fill of empty cells) maps back to the
    wide identity — data can never equal it (strict value_bound)."""
    import jax.numpy as jnp
    g = grid_col.astype(state[0].dtype)
    if grid_col.dtype != state[0].dtype and \
            jnp.issubdtype(grid_col.dtype, jnp.integer):
        ident_n = (gridagg.min_identity(grid_col.dtype) if mode == "min"
                   else gridagg.max_identity(grid_col.dtype))
        ident_w = (gridagg.min_identity(state[0].dtype) if mode == "min"
                   else gridagg.max_identity(state[0].dtype))
        g = jnp.where(grid_col == jnp.asarray(ident_n, grid_col.dtype),
                      jnp.asarray(ident_w, state[0].dtype), g)
    cmb = jnp.minimum if mode == "min" else jnp.maximum
    return (cmb(state[0], g),)


class OpMin(AggOperation):
    name = "min"
    value_bound = None  # optional minmax pre-pass range (like OpSum)

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.value_bound)

    def initial_state(self, G):
        import jax.numpy as jnp
        dt = DataType(self.dtype_in).device  # datetimes ride as int64
        return (jnp.full(G, gridagg.min_identity(dt), dt),)

    def update(self, state, flat_idx, ctx):
        x = self._input(ctx)
        return (gridagg.grid_min(state[0], flat_idx, x, self._valid(ctx)),)

    def get_result(self, state):
        return _view_logical(state[0], self.dtype_in)

    def merge(self, state, delta, axis_name):
        import jax
        import jax.numpy as jnp
        return (jnp.minimum(state[0], jax.lax.pmin(delta[0], axis_name)),)

    extreme_mode = "min"

    def extreme_column(self, ctx):
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        dt = _narrow_extreme_dtype(self) or DataType(self.dtype_in).device
        fill = jnp.asarray(gridagg.min_identity(dt), dt)
        return jnp.where(valid, x.data.astype(dt), fill)

    def apply_extreme(self, state, grid_col):
        return _apply_extreme_narrowed(state, grid_col, "min")


class OpMax(AggOperation):
    name = "max"
    value_bound = None

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.value_bound)

    def initial_state(self, G):
        import jax.numpy as jnp
        dt = DataType(self.dtype_in).device
        return (jnp.full(G, gridagg.max_identity(dt), dt),)

    def update(self, state, flat_idx, ctx):
        x = self._input(ctx)
        return (gridagg.grid_max(state[0], flat_idx, x, self._valid(ctx)),)

    def get_result(self, state):
        return _view_logical(state[0], self.dtype_in)

    def merge(self, state, delta, axis_name):
        import jax
        import jax.numpy as jnp
        return (jnp.maximum(state[0], jax.lax.pmax(delta[0], axis_name)),)

    extreme_mode = "max"

    def extreme_column(self, ctx):
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        dt = _narrow_extreme_dtype(self) or DataType(self.dtype_in).device
        fill = jnp.asarray(gridagg.max_identity(dt), dt)
        return jnp.where(valid, x.data.astype(dt), fill)

    def apply_extreme(self, state, grid_col):
        return _apply_extreme_narrowed(state, grid_col, "max")


def _view_logical(grid, dtype_in):
    """View int64 grids back as the logical datetime/timedelta dtype
    (reference: datetime mean via uint64 view cast back, agg.py:176-186)."""
    dt = DataType(dtype_in)
    if dt.is_datetime or dt.is_timedelta:
        return np.asarray(grid).view(dt.numpy)  # jnp has no datetime view
    return grid


class OpFirst(AggOperation):
    name = "first"

    def initial_state(self, G):
        import jax.numpy as jnp
        dt = DataType(self.dtype_in).numpy
        if dt.kind in "Mm":
            dt = np.dtype("i8")
        return (jnp.zeros(G, dt), jnp.full(G, np.inf, jnp.float64))

    def update(self, state, flat_idx, ctx):
        x = self._input(ctx)
        order = ctx.expr(self.expressions[1])
        vg, og = gridagg.grid_first(state[0], state[1], flat_idx, x, order,
                                    self._valid(ctx), ctx.i1, ctx.row_ids)
        return (vg, og)

    def get_result(self, state):
        return _view_logical(state[0], self.dtype_in)

    def merge(self, state, delta, axis_name):
        """Order-aware: the device holding the globally-minimal order wins;
        ties resolve to the lowest device index."""
        import jax
        import jax.numpy as jnp
        value, order = state
        dvalue, dorder = delta
        global_order = jax.lax.pmin(dorder, axis_name)
        my_idx = jax.lax.axis_index(axis_name)
        big = jnp.int32(2 ** 30)
        winner_idx = jax.lax.pmin(jnp.where(dorder == global_order, my_idx.astype(jnp.int32), big),
                                  axis_name)
        is_winner = (dorder == global_order) & (winner_idx == my_idx)
        contribution = jax.lax.psum(jnp.where(is_winner, dvalue, jnp.zeros((), dvalue.dtype)),
                                    axis_name)
        take_new = global_order < order
        return (jnp.where(take_new, contribution, value),
                jnp.minimum(order, global_order))


class OpNUniquePresence(AggOperation):
    host_finalize = True
    """nunique via a presence grid over (cell, value-ordinal): count nonzero
    per cell.  The device replacement of the per-cell hashmaps in
    agg_hash_primitive.cpp:7-62; requires a prior set-build pass that exposes
    ``_ordinal_values`` for the expression (set in ``ordinal_expression``)."""

    name = "nunique"

    def __init__(self, expressions, ordinal_expression, n_values, dropna=False,
                 dropnan=False, dropmissing=False, **kwargs):
        super().__init__(expressions, **kwargs)
        self.ordinal_expression = str(ordinal_expression)
        self.n_values = int(n_values)
        self.dropnan = dropnan or dropna
        self.dropmissing = dropmissing or dropna
        if self.ordinal_expression not in self.expressions:
            self.expressions.append(self.ordinal_expression)

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.ordinal_expression, self.n_values,
                           self.dropnan, self.dropmissing)

    def initial_state(self, G):
        import jax.numpy as jnp
        n = self.n_values if self.n_values > 1 else 1
        return (jnp.zeros(G * n, bool), jnp.zeros(G, jnp.int64))

    def update(self, state, flat_idx, ctx):
        import jax.numpy as jnp
        presence, _counts = state
        codes = ctx.expr(self.ordinal_expression)
        valid = self._valid(ctx)
        if codes.mask is not None:
            valid = valid & ~codes.mask
        code = codes.data.astype(jnp.int32)
        valid = valid & (code >= 0) & (code < self.n_values)
        G = _counts.shape[0]
        flat = flat_idx * self.n_values + code
        flat = jnp.where(valid, flat, G * self.n_values)
        presence = presence.at[flat].set(True, mode="drop")
        return (presence, _counts)

    def merge(self, state, delta, axis_name):
        import jax
        import jax.numpy as jnp
        presence, counts = state
        dpresence, _ = delta
        merged = jax.lax.psum(dpresence.astype(jnp.int32), axis_name) > 0
        return (presence | merged, counts)

    def get_result(self, state):
        presence = state[0].reshape(-1, self.n_values)
        counts = presence.sum(axis=1).astype(np.int64)
        if self.dropnan and getattr(self, "_nan_ordinal", -1) >= 0:
            counts -= presence[:, self._nan_ordinal].astype(np.int64)
        if self.dropmissing and getattr(self, "_null_ordinal", -1) >= 0:
            counts -= presence[:, self._null_ordinal].astype(np.int64)
        return counts


class OpTopK(AggOperation):
    """Per-cell K largest (or smallest) values (H2O q8 'largest two v3 by
    id6'; no reference machinery exists — vaex's own q8 is commented out,
    reference benchmarks/groupbyh2o.py:80-84).

    One (cell, value) lexicographic sort per tile orders every
    cell's values contiguously; each cell's top K sit at its segment start
    (descending via negation).  State is a [G, K] grid that merges with a
    tile's/device's top-K by row-wise sort of the concatenation — associative
    and commutative, so tiles and devices combine freely.
    """

    name = "topk"
    host_finalize = True  # fill-value masking in get_result is numpy

    def __init__(self, expressions, k, largest=True, **kwargs):
        super().__init__(expressions, **kwargs)
        self.k = int(k)
        self.largest = largest

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.k, self.largest)

    def _fill(self):
        dt = DataType(self.dtype_in).device
        return gridagg.max_identity(dt) if self.largest else gridagg.min_identity(dt)

    def initial_state(self, G):
        import jax.numpy as jnp
        dt = DataType(self.dtype_in).device
        return (jnp.full((G, self.k), self._fill(), dt),)

    def _tile_topk(self, flat_idx, ctx):
        import jax
        import jax.numpy as jnp
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        dt = DataType(self.dtype_in).device
        fill = jnp.asarray(self._fill(), dt)
        col = jnp.where(valid, x.data.astype(dt), fill)
        G = None  # set by caller
        return col, fill

    def update(self, state, flat_idx, ctx):
        import jax
        import jax.numpy as jnp
        (grid,) = state
        G = grid.shape[0]
        col, fill = self._tile_topk(flat_idx, ctx)
        # sort (cell, value) so each cell's best K values lead its segment;
        # invalid rows carry the identity and sort to the harmless end
        key = col if not self.largest else _neg_order(col)
        sidx, skey = jax.lax.sort((flat_idx, key), num_keys=2)
        svals = _neg_order(skey) if self.largest else skey
        bins = jnp.arange(G, dtype=sidx.dtype)
        starts = jnp.searchsorted(sidx, bins, side="left")
        ends = jnp.searchsorted(sidx, bins, side="right")
        N = sidx.shape[0]
        cols = []
        for j in range(self.k):
            pos = jnp.clip(starts + j, 0, N - 1)
            v = svals[pos]
            cols.append(jnp.where(starts + j < ends, v, fill))
        tile = jnp.stack(cols, axis=1)                     # [G, K]
        return (self._combine(grid, tile),)

    def _combine(self, a, b):
        import jax.numpy as jnp
        both = jnp.concatenate([a, b], axis=1)
        both = jnp.sort(both, axis=1)
        return both[:, -self.k:][:, ::-1] if self.largest else both[:, :self.k]

    def merge(self, state, delta, axis_name):
        import jax
        import jax.numpy as jnp
        (grid,) = state
        (dgrid,) = delta
        gathered = jax.lax.all_gather(dgrid, axis_name, axis=1)  # [G, D, K]
        gathered = gathered.reshape(grid.shape[0], -1)
        return (self._combine(grid, gathered),)

    def get_result(self, state):
        grid = _view_logical(state[0], self.dtype_in)
        fill = self._fill()
        if np.dtype(grid.dtype).kind == "f":
            grid = np.where(grid == fill, np.nan, grid)
        return grid


def _neg_order(col):
    """Order-reversing transform that is its own inverse (floats negate;
    ints flip around -1 to avoid int-min overflow)."""
    import jax.numpy as jnp
    if jnp.issubdtype(col.dtype, jnp.floating):
        return -col
    return ~col  # two's complement: x -> -x-1, strictly order-reversing


class OpPercentile(AggOperation):
    """Per-cell approximate percentile via a [G, B] binned count grid +
    histogram interpolation (reference: percentile_approx builds the same
    cumulative binned-count grid, dataframe.py:1419-1524 +
    vaexfast.cpp:1574 grid_find_edges; here the per-cell histogram IS the
    aggregation state, so it works under groupby, and the interpolation
    happens on the host at finalize)."""

    name = "percentile"

    def __init__(self, expressions, percentages, vmin, vmax, bins, **kwargs):
        super().__init__(expressions, **kwargs)
        self.percentages = [float(p) for p in (percentages if isinstance(percentages, (list, tuple)) else [percentages])]
        self.vmin = float(vmin)
        self.vmax = float(vmax)
        self.bins = int(bins)

    def fingerprint(self):
        return fingerprint(super().fingerprint(), tuple(self.percentages),
                           self.vmin, self.vmax, self.bins)

    def initial_state(self, G):
        import jax.numpy as jnp
        return (jnp.zeros(G * self.bins, jnp.int32),)

    def update(self, state, flat_idx, ctx):
        import jax.numpy as jnp
        (hist,) = state
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        B = self.bins
        G = hist.shape[0] // B
        v = x.data.astype(jnp.float64)
        width = (self.vmax - self.vmin) or 1.0
        b = jnp.clip(((v - self.vmin) / width * B).astype(jnp.int32), 0, B - 1)
        flat2 = flat_idx * B + b
        flat2 = jnp.where(valid & (flat_idx < G), flat2, G * B)
        return (hist.at[flat2].add(jnp.ones(flat2.shape, hist.dtype), mode="drop"),)

    def get_result(self, state):
        # interpolate ON DEVICE: only the [G(, P)] results cross to the
        # host, never the [G, B] histogram
        import jax.numpy as jnp
        counts = jnp.reshape(state[0], (-1, self.bins)).astype(jnp.float64)
        cum = jnp.cumsum(counts, axis=1)
        n = cum[:, -1]
        width = (self.vmax - self.vmin) or 1.0
        w = width / self.bins
        rows = jnp.arange(counts.shape[0])

        def value_at_rank(r):
            """Approximate the 0-based r-th smallest value per cell: locate
            its bin in the cumulative counts, place it at the bin midpoint of
            its within-bin position."""
            k = jnp.sum(cum <= r[:, None], axis=1)
            k = jnp.clip(k, 0, self.bins - 1)
            before = jnp.where(k > 0, cum[rows, jnp.maximum(k - 1, 0)], 0)
            inbin = counts[rows, k]
            frac = jnp.where(inbin > 0, (r - before + 0.5) / inbin, 0.5)
            return self.vmin + (k + jnp.clip(frac, 0.0, 1.0)) * w

        outs = []
        for pct in self.percentages:
            # linear-interpolation rank (numpy/pandas default): the value
            # interpolates BETWEEN the bracketing integer ranks — two
            # far-apart values in a 2-row group still give their midpoint
            p = jnp.clip(pct / 100.0 * (n - 1), 0, jnp.maximum(n - 1, 0))
            lo_r = jnp.floor(p)
            v_lo = value_at_rank(lo_r)
            v_hi = value_at_rank(jnp.ceil(p))
            value = v_lo + (p - lo_r) * (v_hi - v_lo)
            outs.append(jnp.where(n > 0, value, jnp.nan))
        if len(outs) == 1:
            return outs[0]
        return jnp.stack(outs, axis=1)


class OpPercentileExact(AggOperation):
    """EXACT per-cell percentiles: tiles COLLECT their (cell, value) pairs
    into a pass-sized device buffer (exact percentile is incompressible —
    every order statistic can matter), then finalize runs ONE (cell, value)
    lex sort + bracketing-order-statistic gathers — within the carried sort
    each cell's values are contiguous and sorted, so the percentile is a
    linear interpolation of the two bracketing order statistics
    (numpy/pandas semantics, exact where they are).

    Streams: multi-tile passes (1e8-row HDF5-backed frames) collect tile by
    tile; device-resident passes present one tile.  Beats
    the reference, whose median is approx-only (dataframe.py:1419-1524
    binned interpolation).  Mesh row-sharding still refuses (merge below);
    groupby medians on a mesh ride the fused one-sort exchange instead
    (fused_groupby.py)."""

    name = "percentile_exact"
    whole_tile = True   # device-resident data: prefer one tile (no copies)
    needs_pass_geometry = True  # state sized from the pass tiling

    def __init__(self, expressions, percentages, **kwargs):
        super().__init__(expressions, **kwargs)
        self.percentages = [float(p) for p in
                            (percentages if isinstance(percentages, (list, tuple))
                             else [percentages])]

    def fingerprint(self):
        return fingerprint(super().fingerprint(), tuple(self.percentages))

    def initial_state(self, G, n_slots=None):
        import jax.numpy as jnp
        if n_slots is None:
            raise RuntimeError("exact percentile needs the pass tiling "
                               "(executor did not stamp _pass_tile_rows)")
        self._G = int(G)
        # +inf values / G cells: collected padding sorts to the end of the
        # drop cell and never brackets a real order statistic
        return (jnp.full(n_slots, jnp.inf, jnp.float64),
                jnp.full(n_slots, G, jnp.int32),
                jnp.zeros((), jnp.int32))

    def update(self, state, flat_idx, ctx):
        import jax.numpy as jnp
        vals, idxs, n_tiles = state
        G = self._G
        x = self._input(ctx)
        valid = gridagg.value_valid(x, self._valid(ctx))
        v = jnp.where(valid, x.data.astype(jnp.float64), jnp.inf)
        idx = jnp.where(valid & (flat_idx < G), flat_idx,
                        jnp.int32(G)).astype(jnp.int32)
        import jax.lax as lax
        T = idx.shape[0]
        # contiguous tile writes: state is sized ceil(n/T)*T so the slice is
        # always in bounds (dynamic_update_slice, not a row scatter)
        start = (n_tiles * jnp.int32(T),)
        return (lax.dynamic_update_slice(vals, v, start),
                lax.dynamic_update_slice(idxs, idx, start),
                n_tiles + jnp.int32(1))

    def get_result(self, state):
        import jax
        import jax.numpy as jnp
        vals, idxs, _ = state
        G = self._G
        sidx, sval = jax.lax.sort((idxs, vals), num_keys=2)
        bins = jnp.arange(G, dtype=sidx.dtype)
        starts = jnp.searchsorted(sidx, bins, side="left").astype(jnp.int32)
        ends = jnp.searchsorted(sidx, bins, side="right")
        n = (ends - starts).astype(jnp.float64)
        outs = [gridagg.interp_order_stats(sval, starts, n, pct)
                for pct in self.percentages]
        if len(outs) == 1:
            return outs[0]
        return jnp.stack(outs, axis=1)

    def merge(self, state, delta, axis_name):
        raise NotImplementedError("exact percentile cannot merge row shards; "
                                  "the descriptor must route to the approx op "
                                  "under a mesh (groupby medians ride the "
                                  "fused one-sort exchange instead)")


_PAIR_SENTINEL = np.int64(2**63 - 1)

# presence grids above this byte count switch nunique to the sorted-pair op
NUNIQUE_PRESENCE_MAX = 1 << 26


class OpNUniqueSorted(AggOperation):
    host_finalize = True
    """nunique for large (cells x values) products: carry the set of distinct
    (cell, value-ordinal) pairs as one sorted int64 array of static capacity
    min(row_count, cells*values) — each tile's pairs are merged by
    sort + adjacent-dedup, so memory is O(distinct pairs), not O(cells*values)
    like :class:`OpNUniquePresence`.  The device replacement of the per-cell
    hashmaps in the reference's agg_hash_primitive.cpp:7-62 when the presence
    grid would not fit."""

    name = "nunique"

    def __init__(self, expressions, ordinal_expression, n_values, row_bound,
                 dropna=False, dropnan=False, dropmissing=False, **kwargs):
        super().__init__(expressions, **kwargs)
        self.ordinal_expression = str(ordinal_expression)
        self.n_values = int(n_values)
        self.row_bound = int(row_bound)
        self.dropnan = dropnan or dropna
        self.dropmissing = dropmissing or dropna
        if self.ordinal_expression not in self.expressions:
            self.expressions.append(self.ordinal_expression)

    def fingerprint(self):
        return fingerprint(super().fingerprint(), self.ordinal_expression,
                           self.n_values, self.row_bound, self.dropnan,
                           self.dropmissing)

    def initial_state(self, G):
        import jax.numpy as jnp
        self._G = int(G)
        cap = builtins.max(builtins.min(self.row_bound, G * self.n_values), 1)
        return (jnp.full(cap, _PAIR_SENTINEL, jnp.int64),)

    @staticmethod
    def _dedup_sorted(pairs):
        import jax.numpy as jnp
        dup = jnp.concatenate([jnp.zeros(1, bool), pairs[1:] == pairs[:-1]])
        return jnp.sort(jnp.where(dup, jnp.int64(_PAIR_SENTINEL), pairs))

    def update(self, state, flat_idx, ctx):
        import jax.numpy as jnp
        (pairs,) = state
        codes = ctx.expr(self.ordinal_expression)
        valid = self._valid(ctx)
        if codes.mask is not None:
            valid = valid & ~codes.mask
        code = codes.data.astype(jnp.int64)
        valid = valid & (code >= 0) & (code < self.n_values)
        new = jnp.where(valid, flat_idx.astype(jnp.int64) * self.n_values + code,
                        jnp.int64(_PAIR_SENTINEL))
        merged = self._dedup_sorted(jnp.sort(jnp.concatenate([pairs, new])))
        return (merged[: pairs.shape[0]],)

    def merge(self, state, delta, axis_name):
        import jax
        import jax.numpy as jnp
        (pairs,) = state
        (dpairs,) = delta
        gathered = jax.lax.all_gather(dpairs, axis_name).reshape(-1)
        merged = self._dedup_sorted(jnp.sort(jnp.concatenate([pairs, gathered])))
        return (merged[: pairs.shape[0]],)

    def get_result(self, state):
        pairs = np.asarray(state[0])
        pairs = pairs[pairs != _PAIR_SENTINEL]
        cells = (pairs // self.n_values).astype(np.int64)
        counts = np.bincount(cells, minlength=self._G).astype(np.int64)
        drop_ordinals = []
        if self.dropnan and getattr(self, "_nan_ordinal", -1) >= 0:
            drop_ordinals.append(self._nan_ordinal)
        if self.dropmissing and getattr(self, "_null_ordinal", -1) >= 0:
            drop_ordinals.append(self._null_ordinal)
        for o in drop_ordinals:
            hit = cells[pairs % self.n_values == o]
            counts -= np.bincount(hit, minlength=self._G).astype(np.int64)
        return counts


# ---------------------------------------------------------------------------
# descriptors (user facing, reference agg.py:231-288 registry)


class AggregatorDescriptor:
    def __init__(self, name, expression=None, selection=None, edges=False):
        self.name = name
        self.expression = str(expression) if expression is not None else None
        self.selection = selection
        self.edges = edges

    @property
    def expressions(self):
        return [self.expression] if self.expression and self.expression != "*" else []

    def __repr__(self):
        return f"vaex_tpu.agg.{self.name}({self.expression!r})"

    def fingerprint(self):
        return fingerprint("agg-desc", self.name, self.expression, str(self.selection))

    def pretty_name(self, name=None, df=None):
        name = name or self.expression
        from .utils import find_valid_name
        return find_valid_name(f"{name}_{self.name}")

    def add_tasks(self, df, binners, progress=None):
        """Schedule on the shared TaskAggregations; returns [promise]."""
        raise NotImplementedError

    def prepare(self, df, binners):
        """Queue any pre-pass statistics (minmax bounds/limits) as DELAYED
        tasks.  GroupBy/BinBy call this for every descriptor before
        ``add_tasks`` so all pre-passes fuse into ONE pass — a mid-queue
        synchronous minmax would split the aggregation pass in two and
        change its compile key between warm and steady-state runs."""
        return None

    def _input_dtype(self, df):
        if self.expression is None or self.expression == "*":
            return DataType(np.dtype("int64"))
        return DataType(df.data_type(self.expression))


class AggregatorDescriptorBasic(AggregatorDescriptor):
    def __init__(self, name, expression, op_class, selection=None, edges=False, op_kwargs=None):
        super().__init__(name, expression, selection, edges)
        self.op_class = op_class
        self.op_kwargs = op_kwargs or {}

    def add_tasks(self, df, binners, progress=None):
        dtype_in = self._input_dtype(df)
        exprs = [] if self.expression in (None, "*") else [self.expression]
        if (self.op_class is OpCount and exprs
                and not DataType(df.data_type(self.expression)).is_primitive):
            # count of a string/object column: only validity matters, so ship
            # sum(notna(x)) to the device instead of the strings themselves
            op = OpSum([f"astype(notna({self.expression}), 'int64')"],
                       selection=self.selection, dtype_in=DataType(np.dtype("int64")))
        else:
            op = self.op_class(exprs, selection=self.selection, dtype_in=dtype_in,
                               **self.op_kwargs)
        if (self.op_class in (OpSum, OpMin, OpMax) and exprs
                and dtype_in.numpy.kind in "iu"):
            # memo-read only: the pass itself was queued by prepare(); a
            # synchronous minmax here would split the aggregation pass
            op.value_bound = df._int_value_bound(self.expression, compute=False)
        task = df.executor.schedule_aggregation(df, binners, op)
        return [task]

    def prepare(self, df, binners):
        if (self.op_class in (OpSum, OpMin, OpMax)
                and self.expression not in (None, "*")):
            from .ops.binners import grid_size
            # big grids: sort cost scales with limb-channel count, and the
            # packed extreme sort needs a 32-bit value, so a (memoized)
            # minmax pre-pass that proves the values small pays for itself
            if (binners and grid_size(binners) > 4096
                    and self._input_dtype(df).numpy.kind in "iu"):
                df._int_value_bound(self.expression, delay=True)


class AggregatorDescriptorMean(AggregatorDescriptor):
    """mean = sum / count (reference agg.py:158-188)."""

    def __init__(self, expression, selection=None, edges=False):
        super().__init__("mean", expression, selection, edges)

    def add_tasks(self, df, binners, progress=None):
        expr = self.expression
        dtype = DataType(df.data_type(expr))
        sum_desc = AggregatorDescriptorBasic("sum", expr, OpSum, self.selection)
        count_desc = AggregatorDescriptorBasic("count", expr, OpCount, self.selection)
        [sum_task] = sum_desc.add_tasks(df, binners)
        [count_task] = count_desc.add_tasks(df, binners)

        @delayed
        def finish(s, c):
            with np.errstate(divide="ignore", invalid="ignore"):
                # empty cells are NaN, never residue/0 = +-inf: the sort
                # path's cumsum-difference sum of an empty segment can be a
                # tiny nonzero residue (pandas: mean of no values is NaN)
                if isinstance(c, np.ndarray) or np.isscalar(c):
                    return np.where(np.asarray(c) > 0, s / c, np.nan)
                import jax.numpy as jnp  # device-resident grids stay on device
                return jnp.where(c > 0, s / c, jnp.nan)
        return [finish(sum_task, count_task)]


class AggregatorDescriptorVar(AggregatorDescriptor):
    """var/std via raw moments E[x^2] - E[x]^2 (reference agg.py:191-229)."""

    def __init__(self, expression, std=False, ddof=0, selection=None, edges=False):
        super().__init__("std" if std else "var", expression, selection, edges)
        self.std = std
        self.ddof = ddof

    def add_tasks(self, df, binners, progress=None):
        expr = self.expression
        sum_desc = AggregatorDescriptorBasic("summoment1", expr, OpSumMoment, self.selection,
                                             op_kwargs={"moment": 1})
        mom_desc = AggregatorDescriptorBasic("summoment2", expr, OpSumMoment, self.selection,
                                             op_kwargs={"moment": 2})
        count_desc = AggregatorDescriptorBasic("count", expr, OpCount, self.selection)
        [s1] = sum_desc.add_tasks(df, binners)
        [s2] = mom_desc.add_tasks(df, binners)
        [c] = count_desc.add_tasks(df, binners)

        @delayed
        def finish(m1, m2, n):
            with np.errstate(divide="ignore", invalid="ignore"):
                mean = m1 / n
                # E[x^2] >= E[x]^2 mathematically: clamp rounding residue so
                # sqrt never manufactures NaN for near-constant cells
                var = np.maximum(m2 / n - mean ** 2, 0.0)
                if self.ddof:
                    # n <= ddof has no unbiased estimate (pandas: NaN); the
                    # raw-moment var may be a tiny rounding residue there, so
                    # mask instead of letting it blow up to inf
                    var = np.where(n > self.ddof, var * n / (n - self.ddof), np.nan)
                return np.sqrt(var) if self.std else var
        return [finish(s1, s2, c)]


class AggregatorDescriptorCovar(AggregatorDescriptor):
    """Per-cell covariance cov(x, y) = E[xy] - E[x]E[y] from additive moments
    (reference computes the same quantity globally via dataframe.py:1067
    ``covar``; here it is a grid aggregate composed from SumMoment ops)."""

    def __init__(self, x, y, selection=None, edges=False, ddof=0):
        super().__init__("covar", x, selection, edges)
        self.y = str(y)
        self.ddof = ddof

    def pretty_name(self, name=None, df=None):
        from .utils import find_valid_name
        return find_valid_name(name or f"{self.expression}_{self.y}_{self.name}")

    def _moment_tasks(self, df, binners):
        x, y = self.expression, self.y
        both = f"where(notna({x}) & notna({y}), 1, 0)"
        # masking each operand by the other's validity keeps the moments
        # consistent on rows where only one of x/y is NaN/null
        xv = f"where(notna({y}), {x}, {y}*0)"
        yv = f"where(notna({x}), {y}, {x}*0)"
        xy = f"({x}) * ({y})"
        sel = self.selection
        [sxy] = _sum_moment(xy, 1, selection=sel).add_tasks(df, binners)
        [sx] = _sum_moment(xv, 1, selection=sel).add_tasks(df, binners)
        [sy] = _sum_moment(yv, 1, selection=sel).add_tasks(df, binners)
        [n] = AggregatorDescriptorBasic("count", xy, OpCount, sel).add_tasks(df, binners)
        return sxy, sx, sy, n

    def add_tasks(self, df, binners, progress=None):
        sxy, sx, sy, n = self._moment_tasks(df, binners)
        ddof = self.ddof

        @delayed
        def finish(mxy, mx, my, c):
            with np.errstate(divide="ignore", invalid="ignore"):
                cov = mxy / c - (mx / c) * (my / c)
                if ddof:
                    cov = cov * c / (c - ddof)
                return cov
        return [finish(sxy, sx, sy, n)]


class AggregatorDescriptorCorr(AggregatorDescriptorCovar):
    """Per-cell Pearson correlation (H2O q9; reference computes the global
    analogue in dataframe.py:1121 ``correlation``)."""

    def __init__(self, x, y, selection=None, edges=False):
        super().__init__(x, y, selection, edges)
        self.name = "corr"

    def add_tasks(self, df, binners, progress=None):
        sxy, sx, sy, n = self._moment_tasks(df, binners)
        x, y = self.expression, self.y
        sel = self.selection
        xv = f"where(notna({y}), {x}, {y}*0)"
        yv = f"where(notna({x}), {y}, {x}*0)"
        [sxx] = _sum_moment(xv, 2, selection=sel).add_tasks(df, binners)
        [syy] = _sum_moment(yv, 2, selection=sel).add_tasks(df, binners)

        @delayed
        def finish(mxy, mx, my, mxx, myy, c):
            with np.errstate(divide="ignore", invalid="ignore"):
                ex, ey = mx / c, my / c
                cov = mxy / c - ex * ey
                vx = mxx / c - ex ** 2
                vy = myy / c - ey ** 2
                r = cov / np.sqrt(vx * vy)
                # a constant operand has zero variance: correlation is
                # undefined (pandas: NaN), not the ±inf of a 0-division
                return np.where(np.isfinite(r), r, np.nan)
        return [finish(sxy, sx, sy, sxx, syy, n)]


class AggregatorDescriptorPercentile(AggregatorDescriptor):
    """Per-cell approximate percentile/median (reference semantics:
    dataframe.py:1419 percentile_approx, binned-cumulative interpolation).

    Runs a fused minmax pre-pass over the value expression to fix the
    histogram limits, like the reference's ``limits`` pre-pass."""

    def __init__(self, expression, percentage=50.0, percentile_shape=1024,
                 selection=None, edges=False, exact=None):
        super().__init__("percentile", expression, selection, edges)
        self.percentage = percentage
        # percentile_shape=None = force exact (reference parity plus: the
        # reference is approx-only, dataframe.py:1419-1524)
        self.exact = (exact if exact is not None
                      else (True if percentile_shape is None else None))
        self.percentile_shape = int(percentile_shape or 1024)

    def prepare(self, df, binners):
        if self._exact_possible(df) and self.exact is not False:
            return  # exact path needs no limits pre-pass
        if self._limits_promise is None:
            self._limits_promise = df.minmax(self.expression, delay=True)

    _limits_promise = None

    # the collected (cell, value) pairs (12 B a row) may take a tenth of
    # the device budget per op — several exact-percentile descriptors in
    # ONE pass each allocate their own buffer
    EXACT_BUDGET_SHARE = 0.1

    def _exact_possible(self, df):
        """Tiles collect their (cell, value) pairs into a pass-sized device
        buffer and finalize runs ONE sort — so streamed (HDF5-backed) frames
        qualify too.  Only a row-sharding mesh refuses
        (partial sorts cannot merge; groupby medians on a mesh ride the
        fused one-sort exchange, fused_groupby.py)."""
        mesh = getattr(df.executor, "mesh", None)
        if mesh is not None and mesh.size > 1:
            return False
        if not DataType(df.data_type(self.expression)).is_primitive:
            return False
        from .utils import device_memory_budget
        max_rows = int(device_memory_budget() * self.EXACT_BUDGET_SHARE) // 12
        return df.dataset_for_execution().row_count <= max_rows

    def add_tasks(self, df, binners, progress=None):
        from .ops.binners import grid_size
        exact_ok = self.exact is not False and self._exact_possible(df)
        if self.exact is True and not exact_ok:
            raise ValueError("exact percentile needs single-host execution "
                             "with the whole pass in one tile; use the approx "
                             "aggregator (percentile_shape=1024) instead")
        if exact_ok:
            op = OpPercentileExact([self.expression], self.percentage,
                                   selection=self.selection,
                                   dtype_in=self._input_dtype(df))
            return [df.executor.schedule_aggregation(df, binners, op)]
        # limits pre-pass; normally resolved by the prepare() phase so it
        # fuses with the other descriptors' pre-passes
        if self._limits_promise is not None and getattr(self._limits_promise, "done", False):
            vmin, vmax = np.asarray(self._limits_promise.get())
        else:
            vmin, vmax = np.asarray(df.minmax(self.expression))
        G = grid_size(binners) if binners else 1
        bins = self.percentile_shape
        max_elems = 1 << 26
        while G * bins > max_elems and bins > 64:
            bins //= 2
        op = OpPercentile([self.expression], self.percentage,
                          float(vmin), float(vmax), bins,
                          selection=self.selection,
                          dtype_in=self._input_dtype(df))
        return [df.executor.schedule_aggregation(df, binners, op)]


class AggregatorDescriptorTopK(AggregatorDescriptor):
    """K largest/smallest values per cell -> a [..., K] grid."""

    def __init__(self, expression, k, largest=True, nth=None, selection=None, edges=False):
        super().__init__("max_n" if largest else "min_n", expression, selection, edges)
        self.k = int(k)
        self.largest = largest
        self.nth_index = nth

    def pretty_name(self, name=None, df=None):
        from .utils import find_valid_name
        base = name or self.expression
        suffix = self.name if self.nth_index is None else f"{self.name}_{self.nth_index}"
        return find_valid_name(f"{base}_{suffix}")

    def add_tasks(self, df, binners, progress=None):
        op = OpTopK([self.expression], self.k, largest=self.largest,
                    selection=self.selection, dtype_in=self._input_dtype(df))
        task = df.executor.schedule_aggregation(df, binners, op)
        if self.nth_index is None:
            return [task]
        i = self.nth_index

        @delayed
        def pick(grid):
            return grid[..., i]
        return [pick(task)]


def percentile_approx(expression, percentage=50.0, percentile_shape=1024,
                      selection=None, edges=False, exact=None):
    return AggregatorDescriptorPercentile(expression, percentage, percentile_shape,
                                          selection=selection, edges=edges,
                                          exact=exact)


def median_approx(expression, percentile_shape=1024, selection=None, edges=False,
                  exact=None):
    """Per-cell median: EXACT (one carried sort) whenever the pass fits one
    tile on one host — beating the reference's approx-only semantics
    (dataframe.py:1419-1524) — with the binned-histogram approximation as
    the fallback.  ``exact=True`` forces the sort path (raises if
    impossible), ``exact=False`` forces the approximation."""
    desc = AggregatorDescriptorPercentile(expression, 50.0, percentile_shape,
                                          selection=selection, edges=edges,
                                          exact=exact)
    desc.name = "median"
    return desc


median = median_approx  # exact-when-possible (the reference has no exact median)


def max_n(expression, k, selection=None, edges=False):
    """The K largest values per group as a [..., K] grid (H2O q8)."""
    return AggregatorDescriptorTopK(expression, k, largest=True,
                                    selection=selection, edges=edges)


def min_n(expression, k, selection=None, edges=False):
    return AggregatorDescriptorTopK(expression, k, largest=False,
                                    selection=selection, edges=edges)


def nth_largest(expression, n, selection=None, edges=False):
    """The (n+1)-th largest value per group (0-based n)."""
    return AggregatorDescriptorTopK(expression, n + 1, largest=True, nth=n,
                                    selection=selection, edges=edges)


def nth_smallest(expression, n, selection=None, edges=False):
    return AggregatorDescriptorTopK(expression, n + 1, largest=False, nth=n,
                                    selection=selection, edges=edges)


def covar(x, y, selection=None, edges=False, ddof=0):
    return AggregatorDescriptorCovar(x, y, selection=selection, edges=edges, ddof=ddof)


def corr(x, y, selection=None, edges=False):
    return AggregatorDescriptorCorr(x, y, selection=selection, edges=edges)


def count(expression="*", selection=None, edges=False):
    return AggregatorDescriptorBasic("count", expression, OpCount, selection, edges)


def sum(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("sum", expression, OpSum, selection, edges)


def mean(expression, selection=None, edges=False):
    return AggregatorDescriptorMean(expression, selection, edges)


def min(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("min", expression, OpMin, selection, edges)


def max(expression, selection=None, edges=False):  # noqa: A001
    return AggregatorDescriptorBasic("max", expression, OpMax, selection, edges)


def first(expression, order_expression=None, selection=None, edges=False):
    desc = AggregatorDescriptorBasic("first", expression, OpFirst, selection, edges)
    desc.order_expression = str(order_expression) if order_expression is not None else str(expression)

    # patch expressions to include the order expression
    class _FirstDesc(AggregatorDescriptorBasic):
        def add_tasks(self, df, binners, progress=None):
            dtype_in = DataType(df.data_type(self.expression))
            op = OpFirst([self.expression, desc.order_expression], selection=self.selection,
                         dtype_in=dtype_in)
            return [df.executor.schedule_aggregation(df, binners, op)]
    d = _FirstDesc("first", desc.expression, OpFirst, selection, edges)
    d.order_expression = desc.order_expression
    return d


def var(expression, ddof=0, selection=None, edges=False):
    return AggregatorDescriptorVar(expression, std=False, ddof=ddof, selection=selection, edges=edges)


def std(expression, ddof=0, selection=None, edges=False):
    return AggregatorDescriptorVar(expression, std=True, ddof=ddof, selection=selection, edges=edges)


def _sum_moment(expression, moment, selection=None, edges=False):
    return AggregatorDescriptorBasic(f"summoment{moment}", expression, OpSumMoment,
                                     selection, edges, op_kwargs={"moment": moment})


class AggregatorDescriptorNUnique(AggregatorDescriptor):
    """nunique (reference agg.py:123): needs a set-build pass first; the
    groupby/DataFrame layer wires ``_ordinal_values`` and the set size in."""

    def __init__(self, expression, dropna=False, dropnan=False, dropmissing=False,
                 selection=None, edges=False):
        super().__init__("nunique", expression, selection, edges)
        self.dropna = dropna
        self.dropnan = dropnan
        self.dropmissing = dropmissing

    def add_tasks(self, df, binners, progress=None):
        # pass 1: build the value set (synchronous here; executor caches it)
        from .ops.binners import grid_size
        oset = df._set(self.expression)
        var_name = df.add_variable("set_nunique", oset, unique=True)
        ordinal_expr = f"_ordinal_values({self.expression}, {var_name})"
        G = grid_size(binners) if binners else 1
        if G * oset.count <= NUNIQUE_PRESENCE_MAX:
            op = OpNUniquePresence([], ordinal_expr, oset.count,
                                   dropna=self.dropna, dropnan=self.dropnan,
                                   dropmissing=self.dropmissing, selection=self.selection,
                                   dtype_in=self._input_dtype(df))
        else:
            # presence grid would not fit: carry distinct (cell, value) pairs
            op = OpNUniqueSorted([], ordinal_expr, oset.count, len(df),
                                 dropna=self.dropna, dropnan=self.dropnan,
                                 dropmissing=self.dropmissing, selection=self.selection,
                                 dtype_in=self._input_dtype(df))
        op._nan_ordinal = oset.nan_ordinal
        op._null_ordinal = oset.null_ordinal
        task = df.executor.schedule_aggregation(df, binners, op)
        return [task]


def nunique(expression, dropna=False, dropnan=False, dropmissing=False, selection=None, edges=False):
    return AggregatorDescriptorNUnique(expression, dropna, dropnan, dropmissing, selection, edges)


aggregates = {
    "count": count, "sum": sum, "mean": mean, "min": min, "max": max,
    "first": first, "std": std, "var": var, "nunique": nunique,
    "_sum_moment": _sum_moment, "median": median_approx,
    "median_approx": median_approx, "percentile_approx": percentile_approx,
    "corr": corr, "covar": covar, "max_n": max_n, "min_n": min_n,
    "nth_largest": nth_largest, "nth_smallest": nth_smallest,
}
