"""GroupBy / BinBy.

Re-design of the reference's ``vaex/groupby.py`` (605 LoC).  The shape is the
same multi-pass plan:

* **pass 1** (per key): build a :class:`~vaex_tpu.ops.setops.SortedSet` of the
  key values (reference: TaskSetCreate -> sharded ordered_set); here the set
  is a sorted key array, so ``sort=True`` order (ascending, NaN group last,
  null last — the reference's only stable order contract) is the natural
  ordinal order and needs no re-sort pass.
* optional **pass 2**: multi-key sparse combine — compress several key
  ordinals into one int64 via cumulative multipliers and build a set over the
  fused key, keeping only observed combinations (reference GrouperCombined,
  groupby.py:171-213, 248-288).
* **pass 3**: the aggregation pass — ordinal binners over
  ``_ordinal_values(key, set)`` feed the fused device grid-aggregation step.
"""

from __future__ import annotations

import collections.abc

import numpy as np

from . import agg as agg_module
from .agg import AggregatorDescriptor
from .datatype import DataType
from .expression import Expression
from .ops.binners import BinnerOrdinal, BinnerScalar
from .ops.setops import RowLimitException  # noqa: F401  (re-export, reference parity)
from .utils import trace

_USE_DELAY = True


class Grouper:
    """One groupby key (reference groupby.py:97)."""

    def __init__(self, expression, df=None, sort=False, ascending=True, row_limit=None,
                 materialize_experimental=False):
        if isinstance(expression, Expression):
            df = df or expression.df
            expression = expression.expression
        self.df = df
        self.expression = str(expression)
        self.sort = sort
        self.ascending = ascending
        self.set = df._set(self.expression, limit=row_limit)
        self.bin_values = self.set.key_array(masked=True)
        self.N = self.set.count
        var = df.add_variable("grouper_set", self.set, unique=True)
        self.binby_expression = f"_ordinal_values({self.expression}, {var})"
        self.ordinal_expression = self.binby_expression
        # set bins == ranks of the observed keys: dense-rank strategy applies
        self.binner = BinnerOrdinal(self.binby_expression, 0, self.N,
                                    raw_expression=self.expression, dense_rank=True)
        self.sort_indices = None
        self.bin_values_raw = self.bin_values
        if sort and not ascending:
            self.sort_indices = np.arange(self.N)[::-1]
            self.bin_values = self.bin_values[::-1]


class GrouperDense:
    """Dense integer-range grouper: bins are the raw key values over
    [lo, hi] — needs only a minmax+count pre-pass instead of a set build
    (the device counterpart of the reference's 'just bin the ints' fast path in
    benchmarks; empty cells are dropped at assemble using the count grid).
    Only valid when the key has no nulls/NaN (checked by the caller)."""

    dense = True

    def __init__(self, expression, df, lo, hi, sort=False, ascending=True):
        self.df = df
        self.expression = str(expression)
        self.sort = sort
        self.ascending = ascending
        self.lo = int(lo)
        self.N = int(hi) - int(lo) + 1
        self.bin_values = np.arange(int(lo), int(hi) + 1, dtype=np.int64)
        self.binby_expression = self.expression
        self.ordinal_expression = (f"(astype({self.expression}, 'int64') - {self.lo})"
                                   if self.lo else f"astype({self.expression}, 'int64')")
        self.binner = BinnerOrdinal(self.expression, self.lo, self.N)
        self.sort_indices = None
        self.bin_values_raw = self.bin_values
        if sort and not ascending:
            self.sort_indices = np.arange(self.N)[::-1]
            self.bin_values = self.bin_values[::-1]


# dense grouping allowed while the (range+3) grid stays cheap
DENSE_RANGE_MAX = 1 << 22


class GrouperCategory:
    """Zero-pass grouper using category metadata (reference groupby.py:216)."""

    def __init__(self, expression, df=None, sort=False, ascending=True, row_limit=None):
        if isinstance(expression, Expression):
            df = df or expression.df
            expression = expression.expression
        self.df = df
        self.expression = str(expression)
        self.sort = sort
        self.ascending = ascending
        labels = df.category_labels(self.expression)
        self.N = df.category_count(self.expression)
        self.min_value = df.category_offset(self.expression)
        self.bin_values = np.asarray(labels)
        meta = df._categories.get(self.expression)
        binby_expression = self.expression
        # dictionary-encoded columns (to_device/ordinal_encode) bin on codes
        codes = (meta or {}).get("codes_column") or f"__{self.expression}_codes"
        if codes in df.virtual_columns or codes in df.dataset:
            binby_expression = codes
        self.binby_expression = binby_expression
        self.ordinal_expression = (f"(astype({binby_expression}, 'int64') - {self.min_value})"
                                   if self.min_value else f"astype({binby_expression}, 'int64')")
        self.binner = BinnerOrdinal(self.binby_expression, self.min_value, self.N)
        self.sort_indices = None
        self.bin_values_raw = self.bin_values
        if sort:
            bv = self.bin_values
            if bv.dtype == object:  # null labels sort last (arrow order)
                order = np.asarray(sorted(range(self.N),
                                          key=lambda i: (bv[i] is None, bv[i] or "")))
            else:
                order = np.argsort(bv, kind="stable")
            if not ascending:
                order = order[::-1]
            if not np.array_equal(order, np.arange(self.N)):
                self.sort_indices = order
                self.bin_values = self.bin_values[order]


class GrouperCombined:
    """Several groupers fused into one int64 key (reference groupby.py:171)."""

    def __init__(self, groupers, df, sort=False, ascending=True, row_limit=None):
        self.df = df
        self.groupers = groupers
        multipliers = np.ones(len(groupers), np.int64)
        for i in range(len(groupers) - 2, -1, -1):
            multipliers[i] = multipliers[i + 1] * groupers[i + 1].N
        if np.prod([g.N for g in groupers], dtype=np.float64) >= 2**62:
            raise ValueError("groupby key cardinality product overflows int64; "
                             "use fewer/lower-cardinality keys")
        parts = [f"astype({g.ordinal_expression}, 'int64') * {m}" if m != 1
                 else f"astype({g.ordinal_expression}, 'int64')"
                 for g, m in zip(groupers, multipliers)]
        self.expression = " + ".join(f"({p})" for p in parts)
        # the observed-combination count is bounded by both the cartesian
        # product and the row count; passing it skips useless probe rungs
        product = float(np.prod([max(g.N, 1) for g in groupers], dtype=np.float64))
        expected = int(min(product, len(df)))
        with trace("grouper-combined set build"):
            self.set = df._set(self.expression, limit=row_limit,
                               expected_cardinality=expected)
        self.N = self.set.n_keys
        var = df.add_variable("grouper_set", self.set, unique=True)
        self.binby_expression = f"_ordinal_values({self.expression}, {var})"
        self.ordinal_expression = self.binby_expression
        self.binner = BinnerOrdinal(self.binby_expression, 0, self.N,
                                    raw_expression=self.expression, dense_rank=True)
        self.sort_indices = None
        # decode fused keys back into per-key bin values (groupby.py:186-213)
        # progressively: one floor-divide per key (no mod), dense groupers
        # translate ordinals by an offset instead of gathering bin_values
        t_decode = trace("grouper-combined decode")
        t_decode.__enter__()
        ordinals_per_key, on_device = self._decode_ordinals(multipliers)
        self.bin_values_per_key = []
        for g, ordinals in zip(groupers, ordinals_per_key):
            if getattr(g, "dense", False):
                # device ordinals stay device-resident output columns
                self.bin_values_per_key.append(
                    (ordinals.astype("int64") + g.lo) if on_device
                    else ordinals.astype(np.int64) + g.lo)
                continue
            bv = getattr(g, "bin_values_raw", g.bin_values)
            labels = _string_labels(bv)
            if labels is not None:
                # string labels stay dictionary-encoded: no 1e7-element
                # object-array gather (reference materializes strings,
                # groupby.py:186-213); with device ordinals the codes never
                # leave HBM until the column is read (ColumnDeviceDictionary)
                from .column import ColumnDeviceDictionary
                self.bin_values_per_key.append(ColumnDeviceDictionary(ordinals, labels))
                continue
            host_ordinals = np.asarray(ordinals) if on_device else ordinals
            self.bin_values_per_key.append(_take_bin_values(bv, host_ordinals))
        self.bin_values = None
        t_decode.__exit__(None, None, None)

    def _decode_ordinals(self, multipliers):
        """Split the fused keys back into per-grouper ordinals — on device
        when the set keys already live on device (the split results stay
        device-resident; returns (ordinals_per_key, on_device))."""
        dev = getattr(self.set, "_device_keys", None)
        if dev is not None:
            import jax.numpy as jnp
            rem = dev.astype(jnp.int64)
            outs = []
            for g, m in zip(self.groupers, multipliers):
                ordinals = rem // int(m) if m != 1 else rem
                if m != 1:
                    rem = rem - ordinals * int(m)
                outs.append(ordinals.astype(jnp.int32))
            return outs, True
        rem = self.set.keys.astype(np.int64)
        outs = []
        for g, m in zip(self.groupers, multipliers):
            ordinals = rem // m if m != 1 else rem
            if m != 1:
                rem = rem - ordinals * m
            outs.append(ordinals)
        return outs, False


def _string_labels(bin_values):
    """The label list when every bin value is a string (or None), else None."""
    if isinstance(bin_values, np.ma.MaskedArray):
        return None
    arr = np.asarray(bin_values)
    if arr.dtype.kind == "U":
        return list(arr)
    if arr.dtype.kind == "O":
        vals = list(arr)
        if all(v is None or isinstance(v, str) for v in vals):
            return vals
    return None


def _take_bin_values(bin_values, ordinals):
    if isinstance(bin_values, np.ma.MaskedArray):
        return bin_values[ordinals]
    return bin_values[ordinals]


def _dense_candidates(names, df, row_limit):
    """One fused minmax+count pass over ALL integer keys -> {name: (lo, hi, n)}.

    Memoized on the executor per (df fingerprint, name): repeated groupbys
    over the same table skip the pre-pass entirely (it costs a dispatch +
    result round-trip per query)."""
    if row_limit is not None:  # row_limit needs the exact observed group count
        return {}
    from .datatype import DataType
    memo = getattr(df.executor, "_dense_candidate_memo", None)
    if memo is None:
        memo = df.executor._dense_candidate_memo = {}
    df_fp = df.fingerprint()
    out = {}
    pending = {}
    for name in names:
        key = (df_fp, name)
        if key in memo:
            if memo[key] is not None:
                out[name] = memo[key]
            continue
        try:
            if DataType(df.data_type(name)).is_integer:
                pending[name] = (df.minmax(name, delay=True), df.count(name, delay=True))
            else:
                memo[key] = None
        except Exception:
            memo[key] = None
            continue
    if not pending:
        return out
    df.execute()
    for name, (mm, cnt) in pending.items():
        lo, hi = np.asarray(mm.get())
        info = (int(lo), int(hi), int(np.asarray(cnt.get())))
        memo[(df_fp, name)] = info
        out[name] = info
    return out


def _make_grouper(by, df, sort, ascending, row_limit, dense_info=None):
    if isinstance(by, (Grouper, GrouperCategory, GrouperCombined, GrouperDense, BinnerTime)):
        return by
    name = str(by) if not isinstance(by, Expression) else by.expression
    if df.is_category(name):
        return GrouperCategory(name, df, sort=sort, ascending=ascending, row_limit=row_limit)
    # dense fast path: integer key, no nulls/NaN, narrow range -> bin directly
    info = (dense_info or {}).get(name)
    if info is not None:
        lo, hi, n_valid = info
        span = hi - lo + 1
        if span <= DENSE_RANGE_MAX and n_valid == len(df):
            return GrouperDense(name, df, lo, hi, sort=sort, ascending=ascending)
    return Grouper(name, df, sort=sort, ascending=ascending, row_limit=row_limit)


class BinnerTime:
    """Datetime resolution binning (reference groupby.py:30).

    Bins a datetime expression into fixed-width periods of ``resolution``
    ('W', 'D', 'h', 'm', 's', 'M', 'Y').
    """

    def __init__(self, expression, resolution="W", df=None, every=1):
        if isinstance(expression, Expression):
            df = df or expression.df
            expression = expression.expression
        self.df = df
        self.expression = str(expression)
        self.resolution = resolution
        self.every = every
        self.sort_indices = None
        # compute the period ordinal on host via datetime64 arithmetic
        values = df.evaluate(self.expression, array_type="numpy")
        from . import array_types
        data, mask = array_types.data_and_mask(values)
        t0 = data.min()
        if resolution == "W":
            # align to week start (numpy weeks epoch-aligned, like pandas resample-ish)
            start = t0.astype("M8[W]")
            codes = ((data.astype("M8[W]").view("i8") - start.view("i8")) // every).astype(np.int64)
            labels = start + np.arange(codes.max() + 1) * np.timedelta64(every, "W")
        else:
            unit = resolution
            start = t0.astype(f"M8[{unit}]")
            codes = ((data.astype(f"M8[{unit}]").view("i8") - start.view("i8")) // every).astype(np.int64)
            labels = start + np.arange(codes.max() + 1) * np.timedelta64(every, unit)
        self.N = int(codes.max()) + 1
        self.bin_values = labels
        # precomputed codes become a hidden materialized column; the name
        # must be stable ACROSS processes for state round-trips (Python's
        # str hash is process-seeded), so use the
        # repo's deterministic fingerprint
        from .utils import fingerprint
        col = f"__btime_{fingerprint(self.expression, resolution, every)[:16]}"
        df.add_column(col, codes)
        self.binby_expression = col
        self.ordinal_expression = col
        self.binner = BinnerOrdinal(col, 0, self.N)

    @classmethod
    def per_week(cls, expression, df=None):
        return cls(expression, "W", df)

    @classmethod
    def per_day(cls, expression, df=None):
        return cls(expression, "D", df)

    @classmethod
    def per_month(cls, expression, df=None):
        return cls(expression, "M", df)

    @classmethod
    def per_year(cls, expression, df=None):
        return cls(expression, "Y", df)


class GroupByBase:
    def __init__(self, df, by, sort=False, ascending=True, combine="auto", row_limit=None,
                 copy=True):
        self.df = df.copy() if copy else df
        self.sort = sort
        by = by if isinstance(by, (list, tuple)) else [by]
        ascending_list = ascending if isinstance(ascending, (list, tuple)) else [ascending] * len(by)
        self.by_names = []
        groupers = []
        plain_names = [str(b) if not isinstance(b, Expression) else b.expression
                       for b in by
                       if not isinstance(b, (Grouper, GrouperCategory, GrouperCombined,
                                             GrouperDense, BinnerTime))
                       and not self.df.is_category(str(b) if not isinstance(b, Expression)
                                                   else b.expression)]
        with trace("dense-candidates pre-pass"):
            dense_info = _dense_candidates(plain_names, self.df, row_limit)
        for b, asc in zip(by, ascending_list):
            with trace(f"grouper[{b}]"):
                g = _make_grouper(b, self.df, sort, asc, row_limit, dense_info=dense_info)
            groupers.append(g)
            self.by_names.append(_grouper_output_name(g))
        self.combined = None
        if len(groupers) > 1 and _should_combine(groupers, combine):
            self.combined = GrouperCombined(groupers, self.df, sort=sort, row_limit=row_limit)
            self.by = [self.combined]
        else:
            self.by = groupers
        self.groupers = groupers
        self.binners = tuple(g.binner for g in self.by)

    @property
    def groupby_expression(self):
        return [g.expression for g in self.groupers]

    def _parse_actions(self, actions):
        """Reference groupby.py:345-402 semantics."""
        out = []  # (output name or None, descriptor)
        if isinstance(actions, collections.abc.Mapping):
            items = list(actions.items())
        elif isinstance(actions, (list, tuple)):
            items = [(None, a) for a in actions]
        else:
            items = [(None, actions)]
        for name, spec in items:
            specs = spec if isinstance(spec, (list, tuple)) else [spec]
            multiple = isinstance(spec, (list, tuple))
            for s in specs:
                if isinstance(s, str) and s == "count":
                    out.append((name or "count", agg_module.count("*")))
                    continue
                if isinstance(s, str):
                    s = agg_module.aggregates[s]
                if callable(s) and not isinstance(s, AggregatorDescriptor):
                    if name is None:
                        for column_name in self.df.get_column_names():
                            if column_name in self.groupby_expression:
                                continue
                            if column_name.startswith("__"):
                                continue
                            desc = s(column_name)
                            out.append((desc.pretty_name(None, self.df), desc))
                    else:
                        desc = s(name)
                        out.append((desc.pretty_name(None, self.df) if multiple else name, desc))
                else:
                    desc = s
                    if name is None or multiple:
                        base = name if (name is not None and multiple) else None
                        out.append((desc.pretty_name(base, self.df), desc))
                    else:
                        out.append((name, desc))
        return out


def _grouper_output_name(g):
    expr = g.expression
    from .utils import valid_expression_name
    return expr if valid_expression_name(expr) else expr


def _should_combine(groupers, combine):
    if combine is True:
        return True
    if combine is False:
        return False
    product = 1.0
    for g in groupers:
        product *= max(g.N, 1)
    return product > 1_000_000


def _run_prepare_phase(df, binners, parsed):
    """Give every descriptor its pre-pass (minmax bounds/limits) and run
    them fused as ONE pass, before any aggregation task is queued — so the
    aggregation pass's task set (and hence its compile key) is identical
    between first and repeat runs."""
    for _, desc in parsed:
        desc.prepare(df, binners)
    if df.executor.tasks:
        with trace("agg prepare pre-pass"):
            df.execute()


_NU_NAN, _NU_NULL = 1, 2  # aux codes in the nunique bit-pair exchange


def _run_shuffle_plan(df, ordinal_expression, plan, G, mesh, slack=4, max_retries=3):
    """Evaluate sources once, build the channel set for the widened shuffle
    (sums + extremes + nunique bit pairs), run it with slack-doubling retry,
    and apply the per-output finishers.  Returns {out_name: [G] numpy} plus
    the always-present '__count' (observed-cells grid for empty-cell drops)."""
    from . import array_types
    from .parallel.mesh import shard_rows
    from .parallel.shuffle import shuffle_segment_grids

    codes = np.asarray(df.evaluate(ordinal_expression, array_type="numpy"),
                       dtype=np.int32)
    N = codes.shape[0]

    source_cache = {}

    def source(expr):
        """raw (data, null_mask-or-None) for an expression, evaluated once."""
        expr = str(expr)
        if expr not in source_cache:
            values = df.evaluate(expr, array_type="numpy")
            data, mask = array_types.data_and_mask(values)
            source_cache[expr] = (data, None if mask is None
                                  else np.asarray(mask, bool))
        return source_cache[expr]

    def valid_of(expr):
        """validity with null AND NaN folded in (reference semantics:
        count/sum/min/max skip both, superagg.cpp:168-191)."""
        data, mask = source(expr)
        valid = np.ones(len(data), bool) if mask is None else ~mask
        if data.dtype.kind == "f":
            valid &= ~np.isnan(data)
        elif data.dtype.kind in "Mm":
            # NaT is stored as int64 min; treat it as missing so min/max and
            # nunique skip it like pandas does (advisor r3 low)
            valid &= data.view(np.int64) != np.iinfo(np.int64).min
        return valid

    def sel_mask(sel):
        if sel is None:
            return None
        data, _ = source(sel)
        return np.asarray(data, bool) & valid_of(sel)

    def valid_and_sel(expr, sel):
        data, _ = source(expr)
        valid = valid_of(expr)
        s = sel_mask(sel)
        return data, (valid if s is None else (valid & s))

    add_channels = [np.ones(N, np.float64)]  # channel 0: observed-row count
    precise_add = set()  # channels needing exact-per-segment sums (moments)
    ext_channels = []  # (values np, mode)
    nu_channels = []   # (bits np i64, aux np i32)
    finishers = []     # (out_name, fn(sums, exts, nus) -> column)

    def add(col, precise=False):
        add_channels.append(np.ascontiguousarray(col, np.float64))
        if precise:
            precise_add.add(len(add_channels) - 1)
        return len(add_channels) - 1

    def add_ext(col, mode):
        ext_channels.append((col, mode))
        return len(ext_channels) - 1

    for out_name, kind, p in plan:
        sel = p.get("sel")
        if kind == "count_star":
            if sel is None:
                finishers.append((out_name,
                                  lambda S, E, U: S[:, 0].astype(np.int64)))
            else:
                i = add(sel_mask(sel).astype(np.float64))
                finishers.append((out_name,
                                  lambda S, E, U, i=i: S[:, i].astype(np.int64)))
        elif kind == "count":
            _, v = valid_and_sel(p["expr"], sel)
            i = add(v.astype(np.float64))
            finishers.append((out_name,
                              lambda S, E, U, i=i: S[:, i].astype(np.int64)))
        elif kind == "sum":
            data, v = valid_and_sel(p["expr"], sel)
            i = add(np.where(v, data.astype(np.float64), 0.0))
            dt = p["dtype"]
            if dt.numpy.kind in "iu":
                out_dt = dt.upcast().numpy
                finishers.append((out_name,
                                  lambda S, E, U, i=i, d=out_dt: S[:, i].astype(d)))
            else:
                finishers.append((out_name, lambda S, E, U, i=i: S[:, i]))
        elif kind == "mean":
            data, v = valid_and_sel(p["expr"], sel)
            i = add(np.where(v, data.astype(np.float64), 0.0))
            j = add(v.astype(np.float64))

            def fin_mean(S, E, U, i=i, j=j):
                with np.errstate(divide="ignore", invalid="ignore"):
                    return S[:, i] / S[:, j]
            finishers.append((out_name, fin_mean))
        elif kind in ("min", "max"):
            data, v = valid_and_sel(p["expr"], sel)
            dt = p["dtype"]
            npdt = dt.numpy
            wide_int = (npdt.kind in "iu" and npdt.itemsize == 8) or npdt.kind in "Mm"
            if wide_int:
                # int64/uint64/datetime ride an int64 channel (f64 is lossy
                # past 2^53); uint64 order-preserved by flipping the sign bit
                if npdt.kind == "u":
                    enc = (data.astype(np.uint64) ^ np.uint64(1 << 63)).view(np.int64)
                else:
                    enc = data.view(np.int64) if npdt.kind in "Mm" else data.astype(np.int64)
                fill = (np.iinfo(np.int64).max if kind == "min"
                        else np.iinfo(np.int64).min)
                e = add_ext(np.where(v, enc, fill).astype(np.int64), kind)

                def fin_ext_i(S, E, U, e=e, npdt=npdt, kind=kind):
                    grid = np.asarray(E[e])
                    if npdt.kind == "u":
                        return (grid.view(np.uint64) ^ np.uint64(1 << 63))
                    if npdt.kind in "Mm":
                        return grid.view(npdt)
                    return grid
                finishers.append((out_name, fin_ext_i))
            else:
                fill = np.inf if kind == "min" else -np.inf
                e = add_ext(np.where(v, data.astype(np.float64), fill), kind)

                def fin_ext_f(S, E, U, e=e, npdt=npdt, kind=kind):
                    grid = np.asarray(E[e])
                    if npdt.kind in "iub":
                        # empty cells keep the reference's type-extreme fill
                        idt = np.dtype(np.uint8) if npdt.kind == "b" else npdt
                        fill_i = (np.iinfo(idt).max if kind == "min"
                                  else np.iinfo(idt).min)
                        safe = np.where(np.isfinite(grid), grid, 0).astype(npdt)
                        return np.where(np.isfinite(grid), safe,
                                        np.asarray(fill_i).astype(npdt))
                    return grid.astype(npdt)
                finishers.append((out_name, fin_ext_f))
        elif kind in ("std", "var"):
            data, v = valid_and_sel(p["expr"], sel)
            x = np.where(v, data.astype(np.float64), 0.0)
            # moments cancel in m2/n - mean^2: cumsum-difference noise turns
            # the std of a constant group into sqrt(residue) — use exact
            # per-segment sums for these channels
            i = add(x, precise=True)
            j = add(x * x, precise=True)
            c = add(v.astype(np.float64))
            ddof = p.get("ddof", 0)
            is_std = kind == "std"

            def fin_var(S, E, U, i=i, j=j, c=c, ddof=ddof, is_std=is_std):
                with np.errstate(divide="ignore", invalid="ignore"):
                    n = S[:, c]
                    mean = S[:, i] / n
                    # E[x^2] >= E[x]^2 mathematically: negatives are rounding
                    # residue (segment sums come from cumsum differences)
                    var = np.maximum(S[:, j] / n - mean ** 2, 0.0)
                    if ddof:
                        var = np.where(n > ddof, var * n / (n - ddof), np.nan)
                    return np.sqrt(var) if is_std else var
            finishers.append((out_name, fin_var))
        elif kind == "nunique":
            data, mask = source(p["expr"])
            s = sel_mask(sel)
            in_sel = np.ones(N, bool) if s is None else s
            isnull = np.zeros(N, bool) if mask is None else mask
            npdt = data.dtype
            if npdt.kind == "f":
                d = data.astype(np.float64, copy=True)
                d[d == 0] = 0.0  # -0.0 == 0.0
                bits = d.view(np.int64).copy()
                isnan = np.isnan(data) & ~isnull  # masked garbage is null, not NaN
            else:
                if npdt.kind == "u" and npdt.itemsize == 8:
                    bits = data.view(np.int64).copy()
                elif npdt.kind in "Mm":
                    bits = data.view(np.int64).astype(np.int64)
                else:
                    bits = data.astype(np.int64)
                isnan = np.zeros(N, bool)
            aux = np.zeros(N, np.int32)
            aux[isnan] = _NU_NAN
            aux[isnull] = _NU_NULL
            aux[~in_sel] = 3  # unselected rows never count
            nu_channels.append((bits, aux))
            u = len(nu_channels) - 1
            extra = []
            if not p["dropnan"]:
                extra.append(add((isnan & in_sel).astype(np.float64)))
            if not p["dropmissing"]:
                extra.append(add((isnull & in_sel).astype(np.float64)))

            def fin_nu(S, E, U, u=u, extra=tuple(extra)):
                cnt = np.asarray(U[u]).astype(np.int64)
                for i in extra:
                    cnt = cnt + (S[:, i] > 0).astype(np.int64)
                return cnt
            finishers.append((out_name, fin_nu))

    # every channel goes straight to the devices that own its rows; padding
    # rows (up to a multiple of D) carry code G, dropped in the exchange, so
    # the other channels' fill values are irrelevant
    D = mesh.shape[mesh.axis_names[0]]
    pad = (-N) % D
    codes_j = shard_rows(mesh, codes, G)
    add_stack = shard_rows(mesh, np.stack(add_channels, axis=1))
    ext_j = [(shard_rows(mesh, v), m) for v, m in ext_channels]
    nu_j = [(shard_rows(mesh, bits), shard_rows(mesh, aux, 3))
            for bits, aux in nu_channels]

    dropped = None
    for attempt in range(max_retries + 1):
        sums, exts, nus, dropped = shuffle_segment_grids(
            mesh, codes_j, add_stack, ext_j, nu_j, G, slack=slack,
            precise_add=tuple(sorted(precise_add)))
        if not int(dropped):
            S = np.asarray(sums)
            E = [np.asarray(e) for e in exts]
            U = [np.asarray(u) for u in nus]
            out = {name: fin(S, E, U) for name, fin in finishers}
            out["__count"] = S[:, 0].astype(np.int64)
            # weak-scaling accounting (BASELINE: >=8x rows/s 1->8 hosts):
            # per-device all-to-all bytes are D*cap*row_bytes with
            # cap = slack*n_local/D, i.e. CONSTANT in D at fixed
            # rows/device — the scaling argument the dryrun carries
            n_local = -(-(N + pad) // D)
            cap = max(64, (slack * n_local) // D)
            row_bytes = (4 + 8 * add_stack.shape[1]
                         + sum(int(np.dtype(v.dtype).itemsize) for v, _ in ext_j)
                         + 12 * len(nu_j))
            df.executor.trace_log.append({
                "shuffle": True, "G": int(G), "devices": int(D),
                "rows": int(N), "rows_per_device": int(n_local),
                "slack": slack,
                "alltoall_bytes_per_device": int(D * cap * row_bytes),
            })
            return out
        slack *= 2  # skew: double per-bucket capacity and re-shuffle
    # pathological key skew (or one hot key with D > slack devices): give up
    # on the shuffle and let the replicated-grid fallback compute it instead
    # of aborting the query (advisor r3 low)
    return None


# mesh groupby: above this cardinality the replicated-grid + psum merge
# (every device holds all G cells) loses to the all-to-all shuffle where
# each device owns G/D cells (reference's combine='auto' occupancy
# heuristic, groupby.py:316-328, re-cast for SPMD)
SHUFFLE_MIN_G = int(__import__("os").environ.get("VAEX_TPU_SHUFFLE_MIN_G", 65536))


class GroupBy(GroupByBase):
    """df.groupby (reference groupby.py:479)."""

    def _try_shuffle_agg(self, parsed):
        """Mesh + high-cardinality: route to the all-to-all shuffle
        (parallel/shuffle.py) instead of replicated grids.  Returns the
        result DataFrame, or None when the query shape doesn't qualify
        (then the replicated-grid path runs).

        Covers the full agg surface the reference routes through its
        partitioned hashmaps (hash_primitives.hpp:96-281): count/sum/mean,
        min/max (f64 ride for exact-in-f64 dtypes, int64 channel for wide
        ints/datetimes), std/var (additive moments), nunique (bit-pattern
        exchange + per-segment distinct count), selections (host-side mask
        fold), and cartesian multi-key (fused ordinal, empty combinations
        dropped).  Sums ride f64 (exact to 2^53; the reference's float sums
        carry the same order-nondeterminism, SURVEY §2.4)."""
        mesh = getattr(self.df.executor, "mesh", None)
        if mesh is None or mesh.size <= 1:
            return None
        df = self.df
        # ---- grid shape: single / combined grouper or fused cartesian keys
        multi_shape = None
        if len(self.by) == 1:
            g = self.by[0]
            G = int(getattr(g, "N", 0))
            ordinal = getattr(g, "ordinal_expression", None)
        else:
            ords = [getattr(gr, "ordinal_expression", None) for gr in self.by]
            if any(o is None for o in ords):
                return None
            Ns = [int(gr.N) for gr in self.by]
            G = int(np.prod(Ns, dtype=np.int64))
            if G > (1 << 31) - 2:
                return None
            mult = 1
            parts = []
            for o, n in zip(reversed(ords), reversed(Ns)):
                parts.append(f"(astype({o}, 'int64') * {mult})" if mult != 1
                             else f"(astype({o}, 'int64'))")
                mult *= n
            ordinal = " + ".join(reversed(parts))
            multi_shape = Ns
            g = None
        if G <= SHUFFLE_MIN_G or ordinal is None:
            return None
        plan = self._shuffle_plan(parsed)
        if plan is None:
            return None
        with trace("shuffle groupby (all-to-all)"):
            out_columns = _run_shuffle_plan(df, ordinal, plan, G, mesh)
        if out_columns is None:
            return None  # skew exhausted the slack retries: replicated path
        return self._shuffle_assemble(out_columns, g, multi_shape)

    def _shuffle_plan(self, parsed):
        """Per-output channel requests, or None when a desc can't ride the
        shuffle (e.g. first/median) — then the replicated path runs."""
        df = self.df
        plan = []  # (out_name, kind, payload dict)
        for name, desc in parsed:
            try:
                sel = df._selection_expression(desc.selection)
            except ValueError:
                return None
            e = desc.expression
            kind = desc.name
            if kind == "count" and e in (None, "*"):
                plan.append((name, "count_star", {"sel": sel}))
            elif kind == "count":
                plan.append((name, "count", {"expr": e, "sel": sel}))
            elif kind == "sum":
                plan.append((name, "sum",
                             {"expr": e, "sel": sel,
                              "dtype": DataType(df.data_type(e))}))
            elif kind == "mean":
                plan.append((name, "mean", {"expr": e, "sel": sel}))
            elif kind in ("min", "max"):
                dt = DataType(df.data_type(e))
                if not (dt.is_primitive or dt.is_datetime):
                    return None
                plan.append((name, kind, {"expr": e, "sel": sel, "dtype": dt}))
            elif kind in ("std", "var"):
                plan.append((name, kind,
                             {"expr": e, "sel": sel,
                              "ddof": getattr(desc, "ddof", 0)}))
            elif kind == "nunique":
                dt = DataType(df.data_type(e))
                if not (dt.is_primitive or dt.is_datetime):
                    return None
                plan.append((name, "nunique",
                             {"expr": e, "sel": sel,
                              "dropnan": getattr(desc, "dropnan", False)
                              or getattr(desc, "dropna", False),
                              "dropmissing": getattr(desc, "dropmissing", False)
                              or getattr(desc, "dropna", False)}))
            else:
                return None
        return plan

    def _shuffle_assemble(self, columns_out, g, multi_shape):
        from . import from_dict
        columns = {}
        counts = columns_out.pop("__count", None)
        if multi_shape is not None:
            # cartesian multi-key: drop never-observed combinations using
            # the count grid (reference groupby.py:488-529)
            keep = counts > 0
            index_arrays = np.unravel_index(np.flatnonzero(keep), tuple(multi_shape))
            for name, gr, idx in zip(self.by_names, self.by, index_arrays):
                bv = getattr(gr, "bin_values_raw", gr.bin_values)
                columns[name] = _take_bin_values(
                    bv if isinstance(bv, np.ma.MaskedArray) else np.asarray(bv), idx)
            for name, col in columns_out.items():
                columns[name] = np.asarray(col)[keep.ravel()]
            df_out = from_dict(columns)
            if self.sort:
                df_out = df_out.sort(self.by_names)
            return df_out
        keep = None
        if getattr(g, "dense", False):
            keep = counts > 0
        if self.combined is not None:
            for name, values in zip(self.by_names, self.combined.bin_values_per_key):
                columns[name] = np.asarray(values)
        else:
            # seed with the RAW (ordinal-order) bin values: the blanket
            # sort_indices gather below permutes every column once, so a
            # pre-sorted bin_values here would be double-permuted and pair
            # keys with the wrong groups' aggregates
            columns[self.by_names[0]] = getattr(g, "bin_values_raw", g.bin_values)
        columns.update(columns_out)
        if g is not None and g.sort_indices is not None:
            columns = {k: np.asarray(v)[g.sort_indices] for k, v in columns.items()}
        if keep is not None:
            if g.sort_indices is not None:
                keep = keep[g.sort_indices]
            columns = {k: np.asarray(v)[keep] for k, v in columns.items()}
        return from_dict(columns)

    def agg(self, actions, delay=False):
        from . import from_dict
        from .delayed import delayed
        parsed = self._parse_actions(actions)
        routed = self._try_shuffle_agg(parsed)
        if routed is not None:
            return self._maybe_delay(routed, delay)
        _run_prepare_phase(self.df, self.binners, parsed)
        promises = []
        has_count_star = any(desc.name == "count" and desc.expression in (None, "*")
                             and desc.selection is None for _, desc in parsed)
        count_promise = None
        # the count grid exists to drop never-observed cells; a combined
        # grouper's cells are exactly the observed combinations and a plain
        # (non-dense) single grouper's bins are exactly the observed keys, so
        # neither needs it
        needs_counts = ((self.combined is None and len(self.by) > 1)
                        or any(getattr(g, "dense", False) for g in self.by))
        if not has_count_star and needs_counts:
            [count_promise] = agg_module.count("*").add_tasks(self.df, self.binners)
        for name, desc in parsed:
            desc.edges = True
            [p] = desc.add_tasks(self.df, self.binners)
            promises.append((name, desc, p))
        with trace("groupby agg pass (execute)"):
            self.df.execute()

        grids = {}
        counts = None
        ndim = len(self.binners)
        for name, desc, p in promises:
            # grids may be device-resident (big whole-pass results stay in
            # HBM); assemble only pulls what host logic actually needs
            grid = agg_module.extract_central(p.get(), ndim)
            grids[name] = grid
            if (desc.name == "count" and desc.expression in (None, "*")
                    and desc.selection is None):
                counts = grid
        if counts is None and count_promise is not None:
            counts = agg_module.extract_central(count_promise.get(), ndim)

        with trace("groupby assemble"):
            return self._maybe_delay(self._assemble(grids, counts), delay)

    @staticmethod
    def _maybe_delay(result, delay):
        """delay=True callers expect a promise (reference groupby.py:484
        returns delayed results); execution here is eager, so hand back an
        already-fulfilled one rather than silently returning the DataFrame."""
        if not delay:
            return result
        from .delayed import Promise
        return Promise().fulfill(result)

    def _assemble(self, grids, counts):
        from . import from_dict
        columns = {}
        if self.combined is not None:
            # sparse path: cells are exactly the observed combinations
            for name, values in zip(self.by_names, self.combined.bin_values_per_key):
                columns[name] = values
            for name, grid in grids.items():
                columns[name] = grid
        elif len(self.by) == 1:
            g = self.by[0]
            bin_values = g.bin_values
            keep = None
            keep_idx = None
            if getattr(g, "dense", False):
                # dense-range groupers carry empty cells; drop them by count.
                # boolean compaction is dynamic-shape, so the COUNT grid
                # comes to the host to compute the kept indices — but the
                # (possibly many) result grids compact with a device gather
                # and stay device-resident (1e6-group results = 32MB+ D2H
                # otherwise)
                cnt = counts
                if g.sort_indices is not None:
                    cnt = cnt[g.sort_indices]
                keep = np.asarray(cnt) > 0
                if any(not isinstance(grid, np.ndarray) for grid in grids.values()):
                    import jax.numpy as jnp
                    keep_idx = jnp.asarray(np.flatnonzero(keep))
            for name, grid in grids.items():
                if g.sort_indices is not None:
                    grid = grid[g.sort_indices]
                if keep is not None:
                    if keep_idx is not None and not isinstance(grid, np.ndarray):
                        import jax.numpy as jnp
                        grid = jnp.take(grid, keep_idx, axis=0)
                    else:
                        grid = np.asarray(grid)[keep]
                columns[name] = grid
            columns[self.by_names[0]] = bin_values[keep] if keep is not None else bin_values
            columns = {self.by_names[0]: columns[self.by_names[0]],
                       **{k: v for k, v in columns.items() if k != self.by_names[0]}}
        else:
            # dense cartesian grid: drop empty cells using the count grid
            # (reference groupby.py:488-529) — host-side compaction
            counts = np.asarray(counts)
            grids = {name: np.asarray(grid) for name, grid in grids.items()}
            mask = counts.ravel() > 0
            index_arrays = np.unravel_index(np.flatnonzero(mask), counts.shape)
            for name, g, idx in zip(self.by_names, self.by, index_arrays):
                bin_values = g.bin_values
                if g.sort_indices is not None:
                    inverse = np.empty_like(g.sort_indices)
                    inverse[g.sort_indices] = np.arange(len(g.sort_indices))
                    idx = inverse[idx]
                columns[name] = _take_bin_values(np.asarray(bin_values) if not isinstance(bin_values, np.ma.MaskedArray) else bin_values, idx)
            for name, grid in grids.items():
                flat = grid.ravel() if grid.shape == counts.shape else grid.reshape(counts.shape).ravel()
                columns[name] = flat[mask]
        df_out = from_dict(columns)
        if self.sort and self.combined is None and len(self.by) > 1:
            df_out = df_out.sort(self.by_names)
        if self.combined is not None and self.sort:
            df_out = df_out.sort(self.by_names)
        return df_out

    def __iter__(self):
        """Iterate (group_key, sub-DataFrame) via filters (reference groupby.py:405-442)."""
        for i, key in enumerate(self._group_keys()):
            yield key, self.get_group(key)

    def _group_keys(self):
        if len(self.groupers) == 1:
            bv = self.groupers[0].bin_values
            return [bv[i] for i in range(len(bv))]
        return list(zip(*[g.bin_values for g in self.groupers]))

    def get_group(self, key):
        keys = key if isinstance(key, tuple) else (key,)
        df = self.df
        conds = []
        for g, k in zip(self.groupers, keys):
            if isinstance(k, np.generic):
                k = k.item()
            if k is None or k is np.ma.masked:
                conds.append(f"ismissing({g.expression})")
            elif isinstance(k, str):
                conds.append(f"({g.expression} == {k!r})")
            elif isinstance(k, float) and np.isnan(k):
                conds.append(f"isnan({g.expression})")
            else:
                conds.append(f"({g.expression} == {k!r})")
        return df.filter(" & ".join(conds))

    @property
    def groups(self):
        for key, df in self:
            yield key


class BinBy(GroupByBase):
    """df.binby: N-d grid result (reference groupby.py:445-477).

    Returns an xarray.DataArray when xarray is installed, else a lightweight
    shim with ``.values``/``.coords``/``.dims``.
    """

    def __init__(self, df, by, limits=None, shape=128, sort=False, copy=True):
        self.df = df.copy() if copy else df
        self.sort = sort
        by = by if isinstance(by, (list, tuple)) else [by]
        self.by_names = [str(b) for b in by]
        binners = []
        limits_resolved = self.df.limits(self.by_names, limits) if by else []
        if len(self.by_names) == 1 and limits_resolved and np.isscalar(limits_resolved[0]):
            limits_resolved = [limits_resolved]
        shapes = shape if isinstance(shape, (list, tuple)) else [shape] * len(by)
        self.by = []
        self.coords = []
        for name, lim, sh in zip(self.by_names, limits_resolved, shapes):
            if self.df.is_category(name):
                g = GrouperCategory(name, self.df, sort=sort)
                binners.append(g.binner)
                self.by.append(g)
                self.coords.append(np.asarray(g.bin_values))
            else:
                vmin, vmax = lim
                binners.append(BinnerScalar(name, vmin, vmax, sh))
                centers = np.linspace(vmin, vmax, sh + 1)[:-1] + (vmax - vmin) / sh / 2
                self.by.append(None)
                self.coords.append(centers)
        self.binners = tuple(binners)
        self.groupers = []

    @property
    def groupby_expression(self):
        return self.by_names

    def agg(self, actions, merge=False, delay=False):
        parsed = self._parse_actions(actions)
        _run_prepare_phase(self.df, self.binners, parsed)
        promises = []
        for name, desc in parsed:
            desc.edges = True
            [p] = desc.add_tasks(self.df, self.binners)
            promises.append((name, p))
        self.df.execute()
        ndim = len(self.binners)
        arrays = {}
        for name, p in promises:
            grid = agg_module.extract_central(np.asarray(p.get()), ndim)
            arrays[name] = grid
        return _to_xarray(arrays, self.by_names, self.coords)


def _to_xarray(arrays, dims, coords):
    try:
        import xarray
        if len(arrays) == 1:
            [(name, grid)] = arrays.items()
            return xarray.DataArray(grid, dims=dims, coords=dict(zip(dims, coords)))
        data_vars = {name: (dims, grid) for name, grid in arrays.items()}
        return xarray.Dataset(data_vars, coords=dict(zip(dims, coords)))
    except ImportError:
        if len(arrays) == 1:
            [(name, grid)] = arrays.items()
            return BinnedArray(grid, dims, coords)
        return {name: BinnedArray(grid, dims, coords) for name, grid in arrays.items()}


class BinnedArray:
    """Minimal xarray.DataArray stand-in (values/dims/coords)."""

    def __init__(self, values, dims, coords):
        self.values = values
        self.dims = tuple(dims)
        self.coords = dict(zip(dims, coords))

    def __array__(self, dtype=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, item):
        return self.values[item]

    @property
    def shape(self):
        return self.values.shape

    def __repr__(self):
        return f"BinnedArray(dims={self.dims}, shape={self.values.shape})"
