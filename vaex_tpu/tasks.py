"""Tasks: units of work executed in one pass over the data.

Re-design of the reference's ``vaex/tasks.py`` + ``vaex/cpu.py`` task parts.
The reference encodes a task, decodes one *task part per CPU thread* and
tree-reduces; here a task contributes either to the single traced **device
step** of the pass (``device = True``: ``initial_state`` / ``update`` /
``finalize``) or to the **host stage** run per chunk on the CPU
(``device = False``: ``process`` / ``get_result``).  Per-thread state and
tree reduction disappear: SPMD accumulators live in HBM and are combined by
XLA collectives when the pass runs over a device mesh.
"""

from __future__ import annotations

import numpy as np

from .ops import setops
from .utils import fingerprint


from .delayed import Promise


class Task(Promise):
    device = True
    see_all = False
    # scan_safe: update() carries everything in `state` and returns no
    # per-tile output, so the executor may run the whole pass as one
    # compiled fori_loop over tiles (execution.py whole-pass fast path)
    scan_safe = False

    def __init__(self, df, expressions, name="task", pre_filter=False):
        super().__init__()
        self.df = df
        self.expressions = [str(e) for e in expressions]
        self.name = name
        self.pre_filter = pre_filter
        self.cancelled = False

    def fingerprint(self):
        return fingerprint(type(self).__name__, self.expressions, self.name,
                           self.pre_filter, self._fingerprint_extra())

    def _fingerprint_extra(self):
        return None

    # -- device protocol ----------------------------------------------------
    def preferred_tile_rows(self, n_total):
        """Optional tile-size preference; the executor honors it only when
        every task in the pass agrees and the data is device-resident."""
        return None

    def initial_state(self):
        raise NotImplementedError

    def update(self, state, ctx):
        """Traced. Returns (new_state, per_tile_output_or_None)."""
        raise NotImplementedError

    def finalize(self, state, outputs):
        raise NotImplementedError

    # -- host protocol ------------------------------------------------------
    def process(self, i1, i2, scope, row_valid=None):
        raise NotImplementedError

    def get_result(self):
        raise NotImplementedError


class TaskAggregations(Task):
    """All aggregations of one pass that share a binner stack
    (reference: tasks.py:332-391 + cpu.py:450-605 TaskPartAggregation).

    ``subtasks`` is a list of (aggregator-operation, selection) pairs created
    by the agg descriptors in :mod:`vaex_tpu.agg`.
    """

    scan_safe = True

    def __init__(self, df, binners):
        exprs = [b.expression for b in binners]
        super().__init__(df, exprs, name="aggregations")
        self.binners = tuple(binners)
        self.subtasks = []  # AggOperation instances
        self.subtask_promises = []

    def add_subtask(self, operation):
        self.subtasks.append(operation)
        sub = Task(self.df, operation.expressions, name=f"agg-{operation.name}")
        self.subtask_promises.append(sub)
        for e in operation.expressions:
            if e not in self.expressions:
                self.expressions.append(e)
        for e in operation.selection_expressions():
            if e not in self.expressions:
                self.expressions.append(e)
        return sub

    def _fingerprint_extra(self):
        return ([b.fingerprint() for b in self.binners],
                [op.fingerprint() for op in self.subtasks])

    def reject(self, exception):
        super().reject(exception)
        for sub in self.subtask_promises:
            if not sub.done:
                sub.reject(exception)
        return self

    def initial_state(self):
        from .ops.binners import grid_size
        G = grid_size(self.binners)
        # collect-style ops (exact percentile) size their state from the
        # pass tiling the executor stamped on the task
        T = getattr(self, "_pass_tile_rows", None)
        n_total = getattr(self, "_pass_n_total", None)
        n_slots = None
        if T and n_total is not None:
            n_slots = -(-max(n_total, 1) // T) * T
        states = []
        for op in self.subtasks:
            if getattr(op, "needs_pass_geometry", False):
                states.append(op.initial_state(G, n_slots=n_slots))
            else:
                states.append(op.initial_state(G))
        return states

    # strategy thresholds (see ops/gridagg.py): batched small-grid sums and
    # masked-reduce extremes for small grids, then device sort + segment
    # reduce, scatter only as the last resort for astronomical grids
    FUSED_ADDITIVE_MAX_G = 2048
    FUSED_EXTREME_MAX_G = 512
    SORT_MAX_G = 1 << 24
    # grids past this always ride the sort path, where one whole-table tile
    # beats any tiling (per-tile cost is O(G), not O(tile))
    WHOLE_TILE_MIN_G = 1 << 21
    # the carried-sort program compiles fine at 1e7+ rows now that the
    # full-N associative scan is a two-level blocked cumsum
    # (gridagg.prefix_at); the cap only guards truly pathological sizes
    DENSE_RANK_MAX_ROWS = 1 << 27

    def preferred_tile_rows(self, n_total):
        from .ops.binners import grid_size
        if any(getattr(op, "whole_tile", False) for op in self.subtasks):
            return n_total  # exact percentiles need every row in one sort
        if grid_size(self.binners) > self.WHOLE_TILE_MIN_G:
            return n_total
        return None

    def _sort_columns(self, ctx, additive):
        """float64 columns for the sort strategies: integer sums ride exact
        limb columns (OpSum.additive_columns_exact).  Returns (col_specs,
        cols [N, A], precise column positions)."""
        import jax.numpy as jnp
        col_specs, col_list, precise = [], [], []
        for i in additive:
            op = self.subtasks[i]
            exact_cols = (op.additive_columns_exact(ctx)
                          if hasattr(op, "additive_columns_exact") else None)
            if exact_cols is not None:
                col_specs.append((i, len(exact_cols), True))
                col_list.extend(exact_cols)
            else:
                col_specs.append((i, 1, False))
                if getattr(op, "precise_additive", False):
                    precise.append(len(col_list))
                col_list.append(op.additive_column(ctx).astype(jnp.float64))
        return col_specs, jnp.stack(col_list, axis=1), tuple(precise)

    def _apply_sorted(self, state, new_state, done, col_specs, grids):
        pos = 0
        for i, ncols, exact in col_specs:
            if exact:
                new_state[i] = self.subtasks[i].apply_additive_exact(
                    state[i], grids[:, pos:pos + ncols])
            else:
                new_state[i] = self.subtasks[i].apply_additive(state[i], grids[:, pos])
            pos += ncols
            done[i] = True

    def update(self, state, ctx):
        import jax.numpy as jnp
        from .ops import gridagg
        from .ops.binners import grid_size
        G = grid_size(self.binners)
        new_state = list(state)
        done = [False] * len(self.subtasks)

        # the ordinal probe (searchsorted of every row's key in the set) is
        # skipped entirely by the dense-rank strategy below — compute lazily
        _flat = [None]

        def flat_of():
            if _flat[0] is None:
                _flat[0] = self._flat_indices(ctx)
            return _flat[0]

        use_sort_additive = self.FUSED_ADDITIVE_MAX_G < G <= self.SORT_MAX_G
        use_sort_extreme = self.FUSED_EXTREME_MAX_G < G <= self.SORT_MAX_G

        additive = [i for i, op in enumerate(self.subtasks) if hasattr(op, "additive_column")]

        # dense-rank sort strategy (set-based groupers, mid/high G): ONE
        # carried sort of the RAW key replaces the ordinal probe AND the
        # per-bin boundary searches (ops/gridagg.py dense_rank_additive)
        binner = self.binners[0] if len(self.binners) == 1 else None
        if (binner is not None and getattr(binner, "dense_rank", False)
                and (use_sort_additive or use_sort_extreme)
                and not getattr(ctx, "spmd_shard", False)
                # every bin observed holds for the WHOLE pass, not per tile
                and ctx.n_rows >= self.df.dataset_for_execution().row_count
                and ctx.n_rows <= self.DENSE_RANK_MAX_ROWS):
            key_na = ctx.expr(binner.raw_expression)
            if (key_na.mask is None
                    and jnp.issubdtype(key_na.data.dtype, jnp.integer)):
                kd = key_na.data
                key = jnp.where(ctx.row_valid, kd,
                                jnp.asarray(jnp.iinfo(kd.dtype).max, kd.dtype))
                nb = binner.count
                ends = None
                if additive and use_sort_additive:
                    col_specs, cols, precise = self._sort_columns(ctx, additive)
                    sums, ends = gridagg.dense_rank_additive(key, cols, nb,
                                                             precise=precise)
                    # +3 edge layout: data bins start at 2, edges stay 0
                    grids = jnp.pad(sums, ((2, 1), (0, 0)))
                    self._apply_sorted(state, new_state, done, col_specs, grids)
                    additive = []
                if use_sort_extreme:
                    for mode in ("min", "max"):
                        for i, op in enumerate(self.subtasks):
                            if getattr(op, "extreme_mode", None) != mode or done[i]:
                                continue
                            col = op.extreme_column(ctx)
                            vals, ends = gridagg.dense_rank_extreme(
                                key, col, nb, mode, ends=ends)
                            fill = (gridagg.min_identity(col.dtype) if mode == "min"
                                    else gridagg.max_identity(col.dtype))
                            grid_col = jnp.pad(vals, (2, 1),
                                               constant_values=jnp.asarray(fill, col.dtype))
                            new_state[i] = op.apply_extreme(state[i], grid_col)
                            done[i] = True

        if additive and G <= self.FUSED_ADDITIVE_MAX_G:
            # one batched call feeds every additive aggregator: integer
            # columns sum in int64, float columns in float64
            int_cols, float_cols, slots = [], [], []
            for i in additive:
                col = self.subtasks[i].additive_column(ctx)
                if jnp.issubdtype(col.dtype, jnp.integer):
                    slots.append((i, 0, len(int_cols)))
                    int_cols.append(col.astype(jnp.int64))
                else:
                    slots.append((i, 1, len(float_cols)))
                    float_cols.append(col.astype(jnp.float64))
            n = ctx.n_rows
            grids = gridagg.small_g_sums(
                flat_of(),
                jnp.stack(int_cols, axis=1) if int_cols else jnp.zeros((n, 0), jnp.int64),
                jnp.stack(float_cols, axis=1) if float_cols else jnp.zeros((n, 0), jnp.float64),
                G)
            for i, kind, pos in slots:
                new_state[i] = self.subtasks[i].apply_additive(state[i], grids[kind][:, pos])
                done[i] = True
        elif additive and use_sort_additive:
            col_specs, cols, precise = self._sort_columns(ctx, additive)
            sorted_idx, sorted_cols = gridagg.sort_carry(flat_of(), cols)
            grids = gridagg.sorted_additive(sorted_idx, sorted_cols, G,
                                            precise=precise)
            self._apply_sorted(state, new_state, done, col_specs, grids)

        for mode in ("min", "max"):
            group = [i for i, op in enumerate(self.subtasks)
                     if getattr(op, "extreme_mode", None) == mode and not done[i]]
            if not group or (G > self.FUSED_EXTREME_MAX_G and not use_sort_extreme):
                continue
            if G <= self.FUSED_EXTREME_MAX_G:
                by_dtype = {}
                for i in group:
                    col = self.subtasks[i].extreme_column(ctx)
                    by_dtype.setdefault(col.dtype, []).append((i, col))
                for dtype, items in by_dtype.items():
                    cols = jnp.stack([c for _, c in items], axis=1)
                    grids = gridagg.fused_extreme(flat_of(), cols, G, mode)
                    for k, (i, _) in enumerate(items):
                        new_state[i] = self.subtasks[i].apply_extreme(state[i], grids[:, k])
                        done[i] = True
            else:
                # one packed single-key sort per column (2-key lex for wide
                # values), compaction-sort boundary extraction
                for i in group:
                    col = self.subtasks[i].extreme_column(ctx)
                    grid_col = gridagg.extreme_fast(flat_of(), col, G, mode)
                    new_state[i] = self.subtasks[i].apply_extreme(state[i], grid_col)
                    done[i] = True

        for i, op in enumerate(self.subtasks):
            if not done[i]:
                new_state[i] = op.update(state[i], flat_of(), ctx)
        return new_state, None

    def update_spmd(self, state, ctx, axis_name):
        """Per-device: aggregate the local row shard into a zero grid (with
        the same batched small-grid/sort strategies as the single-device
        path), then merge into the replicated state with each op's
        collective (psum/pmin/pmax) — replaces the reference's per-thread
        parts + tree reduce."""
        import jax.numpy as jnp
        from .ops.binners import grid_size
        G = grid_size(self.binners)
        zeros = [tuple(jnp.asarray(z) for z in op.initial_state(G)) for op in self.subtasks]
        # each device sees only its row shard: the dense-rank strategy's
        # every-bin-observed invariant does not hold per shard
        ctx.spmd_shard = True
        deltas, _ = self.update(zeros, ctx)
        return [tuple(op.merge(tuple(s), tuple(d), axis_name))
                for op, s, d in zip(self.subtasks, state, deltas)], None

    def _flat_indices(self, ctx):
        from .ops.binners import fuse_bins
        import jax.numpy as jnp
        if self.binners:
            indices = [b.to_bins(ctx.expr(b.expression)) for b in self.binners]
            return fuse_bins(self.binners, indices)
        return jnp.zeros(ctx.n_rows, jnp.int32)

    @property
    def host_finalize(self):
        """True when any op's get_result needs host numpy math; otherwise
        the accumulator grids stay device-resident all the way into the
        result DataFrame (the D2H copy happens only on materialization)."""
        return any(getattr(op, "host_finalize", False) for op in self.subtasks)

    def finalize(self, state, outputs):
        from .ops.binners import grid_shape
        shape = grid_shape(self.binners)
        results = []
        for op, s in zip(self.subtasks, state):
            if getattr(op, "host_finalize", False):
                s = [np.asarray(x) for x in s]
            grid = op.get_result(list(s))
            results.append(grid.reshape(shape + grid.shape[1:]) if self.binners else grid.reshape(shape))
        self.fulfill(results)
        for sub, r in zip(self.subtask_promises, results):
            sub.fulfill(r)
        return results


class TaskFilterFill(Task):
    """Materialize a boolean mask for all rows (reference: tasks.py:85).

    Device task producing a per-tile boolean output; the executor stitches the
    chunks into the DataFrame's row mask.
    """

    def __init__(self, df, expression):
        super().__init__(df, [str(expression)], name="filter-fill")
        self.see_all = True

    def initial_state(self):
        return ()

    def update(self, state, ctx):
        mask = ctx.bool_expr(self.expressions[0])
        return state, mask & ctx.padding_valid

    def finalize(self, state, outputs):
        mask = np.concatenate([np.asarray(o) for o in outputs]) if outputs else np.empty(0, bool)
        self.fulfill(mask)
        return mask

    def process(self, i1, i2, scope, row_valid=None):  # host fallback
        import numpy as np
        values = scope.evaluate_raw(self.expressions[0])
        data, mask = _as_bool_host(values)
        if not hasattr(self, "_host_parts"):
            self._host_parts = []
        self._host_parts.append(data if mask is None else (data & ~mask))

    def get_result(self):
        mask = np.concatenate(self._host_parts) if getattr(self, "_host_parts", None) else np.empty(0, bool)
        self.fulfill(mask)
        return mask


def _as_bool_host(values):
    from . import array_types
    data, mask = array_types.data_and_mask(values)
    return data.astype(bool), mask


class TaskEvaluate(Task):
    """Materialize expression values for all rows (df.evaluate parallel path,
    reference dataframe.py:6013-6128)."""

    def __init__(self, df, expression, pre_filter=False):
        super().__init__(df, [str(expression)], name="evaluate", pre_filter=pre_filter)
        self.see_all = True

    def initial_state(self):
        return ()

    def update(self, state, ctx):
        value = ctx.expr(self.expressions[0])
        valid = ctx.row_valid if self.pre_filter else ctx.padding_valid
        return state, (value.data, value.maskarray(), valid)

    def finalize(self, state, outputs):
        datas, masks = [], []
        for d, m, v in outputs:
            d, m = np.asarray(d), np.asarray(m)
            if self.pre_filter:
                v = np.asarray(v)
                datas.append(d[v])
                masks.append(m[v])
            else:
                # valid == the padding mask and the executor already trimmed
                # padding rows: a boolean gather here would copy for nothing
                datas.append(d)
                masks.append(m)
        data = np.concatenate(datas) if datas else np.empty(0)
        mask = np.concatenate(masks) if masks else np.empty(0, bool)
        result = np.ma.MaskedArray(data, mask) if mask.any() else data
        self.fulfill(result)
        return result


class TaskSetCreate(Task):
    """Build a SortedSet of an expression's values (reference: tasks.py:99 +
    cpu.py:118-232 TaskPartSetCreate).  Host task: chunk uniques are merged
    into one sorted key array (device build path: ops/setops docstring)."""

    device = False

    def __init__(self, df, expression, keep_counts=False, limit=None, pre_filter=True):
        super().__init__(df, [str(expression)], name="set-create", pre_filter=pre_filter)
        self.keep_counts = keep_counts
        self.limit = limit
        self.set = None

    def _fingerprint_extra(self):
        return (self.keep_counts, self.limit)

    def process(self, i1, i2, scope, row_valid=None):
        values = scope.evaluate_raw(self.expressions[0])
        from . import array_types
        from .ops.setops import _as_dict_string_arrow, _as_string_arrow
        darr = _as_dict_string_arrow(values)
        if darr is not None:
            # dictionary-encoded strings: O(N) int bincount + cached O(U)
            # dictionary work per chunk — never decode N strings
            if row_valid is not None:
                import pyarrow as pa
                darr = darr.filter(pa.array(np.asarray(row_valid, bool)))
            if self.set is None:
                self.set = setops.SortedSet("string", keep_counts=self.keep_counts,
                                            limit=self.limit)
            self.set.update(darr)
            return
        arrow = _as_string_arrow(values)
        if arrow is not None:
            # arrow-string chunks feed the set natively (no to_pylist blowup)
            if row_valid is not None:
                import pyarrow as pa
                arrow = arrow.filter(pa.array(np.asarray(row_valid, bool)))
            if self.set is None:
                self.set = setops.SortedSet("string", keep_counts=self.keep_counts,
                                            limit=self.limit)
            self.set.update(arrow)
            return
        data, mask = array_types.data_and_mask(values)
        if row_valid is not None:
            data = data[row_valid]
            mask = mask[row_valid] if mask is not None else None
        if self.set is None:
            kind = data.dtype
            dtype = "string" if kind.kind in "OUS" else kind
            self.set = setops.SortedSet(dtype, keep_counts=self.keep_counts, limit=self.limit)
        self.set.update(np.ma.MaskedArray(data, mask) if mask is not None else data)

    def get_result(self):
        if self.set is None:
            self.set = setops.SortedSet(np.dtype("float64"), keep_counts=self.keep_counts)
        self.fulfill(self.set)
        return self.set


class TaskSetCreateDevice(Task):
    """Device-side set build: per tile, a static-size ``jnp.unique`` runs on
    the accelerator and only the (tiny) candidate key arrays cross back to
    the host, where they merge into the SortedSet.  This replaces the host
    path when the key expression is device-evaluable — crucial for
    device-resident tables, where the host path would fetch whole columns.

    Invalid rows (padding/filter/null/NaN) are replaced by the tile's first
    usable value — which adds no new keys — and the inflated count of that
    value is corrected on the host.  Overflow of the per-tile cap raises
    SetCapOverflow; the caller retries with the host path.
    """

    trim_outputs = False  # outputs are candidate sets, not row slices

    def __init__(self, df, expression, keep_counts=False, limit=None, pre_filter=True,
                 cap=65536):
        super().__init__(df, [str(expression)], name="set-create-device", pre_filter=pre_filter)
        self.keep_counts = keep_counts
        self.limit = limit
        self.cap = cap

    def _fingerprint_extra(self):
        return (self.keep_counts, self.limit, self.cap, "device")

    def initial_state(self):
        return ()

    def update(self, state, ctx):
        import jax.numpy as jnp
        x = ctx.expr(self.expressions[0])
        valid = ctx.row_valid if self.pre_filter else ctx.padding_valid
        data = x.data
        null_mask = x.mask if x.mask is not None else jnp.zeros(data.shape, bool)
        null_count = jnp.sum(valid & null_mask)
        if jnp.issubdtype(data.dtype, jnp.floating):
            nan_mask = jnp.isnan(data)
        else:
            nan_mask = jnp.zeros(data.shape, bool)
        nan_count = jnp.sum(valid & nan_mask & ~null_mask)
        usable = valid & ~null_mask & ~nan_mask
        n_usable = jnp.sum(usable)
        rep = data[jnp.argmax(usable)]
        clean = jnp.where(usable, data, rep)
        cap = min(self.cap, clean.shape[0])
        uniq, counts = jnp.unique(clean, return_counts=True, size=cap, fill_value=rep)
        n_invalid = clean.shape[0] - n_usable
        return state, (uniq, counts, rep, n_invalid, nan_count, null_count, n_usable)

    def finalize(self, state, outputs):
        from .ops.setops import SortedSet
        oset = None
        for uniq, counts, rep, n_invalid, nan_count, null_count, n_usable in outputs:
            uniq = np.asarray(uniq)
            counts = np.asarray(counts).astype(np.int64)
            if oset is None:
                oset = SortedSet(uniq.dtype, keep_counts=self.keep_counts, limit=self.limit)
            oset.nan_count += int(nan_count)
            oset.null_count += int(null_count)
            if int(n_usable) == 0:
                continue
            counts = counts.copy()
            counts[uniq == np.asarray(rep)] -= int(n_invalid)
            present = counts > 0
            n_uniq = int(present.sum())
            if n_uniq >= min(self.cap, len(uniq)):
                exc = SetCapOverflow(f"tile unique count reached cap {self.cap}")
                self.reject(exc)
                raise exc
            part = SortedSet(uniq.dtype, keep_counts=self.keep_counts)
            part.keys = uniq[present]
            if self.keep_counts:
                part.counts = counts[present]
            oset.merge(part)
        if oset is None:
            oset = SortedSet(np.dtype("float64"), keep_counts=self.keep_counts)
        if self.limit is not None and oset.count > self.limit:
            exc = setops.RowLimitException(
                f"set grew to {oset.count} unique values, which exceeds the limit of {self.limit}")
            self.reject(exc)
            raise exc
        self.fulfill(oset)
        return oset


class SetCapOverflow(Exception):
    pass


class TaskMapReduce(Task):
    """Generic host map over chunks + reduce (reference: tasks.py:121)."""

    device = False

    def __init__(self, df, expressions, map_fn, reduce_fn=None, name="map-reduce",
                 pre_filter=False, info=False):
        super().__init__(df, expressions, name=name, pre_filter=pre_filter)
        self.map_fn = map_fn
        self.reduce_fn = reduce_fn
        self.info = info
        self.parts = []

    def _fingerprint_extra(self):
        return (id(self.map_fn), id(self.reduce_fn))  # not cacheable across runs

    def process(self, i1, i2, scope, row_valid=None):
        values = [scope.evaluate_raw(e) for e in self.expressions]
        if row_valid is not None:
            values = [v[row_valid] for v in values]
        if self.info:
            self.parts.append(self.map_fn(i1, i2, *values))
        else:
            self.parts.append(self.map_fn(*values))

    def get_result(self):
        result = self.parts
        if self.reduce_fn is not None:
            import functools
            result = functools.reduce(self.reduce_fn, self.parts) if self.parts else None
        self.fulfill(result)
        return result
