"""The pass executor: one jitted SPMD step per task batch.

Re-design of the reference's ``vaex/execution.py`` + ``cpu.py`` +
``multithreading.py``.  The reference pops all queued tasks of a DataFrame,
splits the row range into chunks and fans them over a CPU thread pool, each
thread eval()-ing expressions per chunk and feeding C++ kernels, then
tree-reduces per-thread state (execution.py:158-310).

Here one *pass* is:

1.  collect tasks, dedupe by fingerprint, consult the result cache;
2.  classify every needed expression as device- or host-stage
    (:func:`vaex_tpu.scopes.expression_is_device`);
3.  build ONE traced ``step(state, tile, n_valid, aux) -> (state, outputs)``
    closing over all device tasks — expression evaluation, filter/selection
    masks, binning and every aggregator fuse into a single XLA program,
    compiled once per (task structure, tile shape) and cached;
4.  stream fixed-size tiles host->device (JAX async dispatch overlaps the
    next chunk's host stage with device compute), calling ``step`` per tile;
5.  finalize: fetch accumulator state, strip edges, fulfill task promises,
    store results in the cache.

Multi-device: the same step runs under ``shard_map`` over a
``jax.sharding.Mesh`` — rows sharded across devices, each device owning a
partial accumulator; partials are combined with the operation's ``combine``
at finalize (replaces the reference's per-thread task parts + tree reduce).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import array_types, settings
from .datatype import DataType
from .ops.nullable import NA
from .ops.setops import SortedSet, DeviceSetHandle
from .scopes import DeviceScope, HostScope, classify_leaves, expression_is_device
from .tasks import Task, TaskAggregations
from .utils import Signal, fingerprint


class UserAbort(Exception):
    pass


class TileContext:
    """Everything a task's traced ``update`` can ask for about one tile.

    ``local_offset`` is this device's row offset inside the (logically
    whole) tile when running under shard_map; 0 on a single device.
    """

    def __init__(self, scope: DeviceScope, padding_valid, filter_valid, i1, n_rows,
                 local_offset=0):
        self.scope = scope
        self.padding_valid = padding_valid
        self.filter_valid = filter_valid
        self.row_valid = padding_valid if filter_valid is None else padding_valid & filter_valid
        self.i1 = i1
        self.n_rows = n_rows
        self.row_ids = (jax.lax.broadcasted_iota(jnp.int32, (n_rows, 1), 0).squeeze(-1)
                        + i1 + local_offset)
        self._selection_cache = {}

    def expr(self, expression) -> NA:
        return self.scope.evaluate(str(expression))

    def bool_expr(self, expression):
        value = self.expr(expression)
        data = value.data.astype(bool)
        if value.mask is not None:
            data = data & ~value.mask
        return data

    def selection_valid(self, selection):
        """row_valid AND selection (selection given as an expression string)."""
        if selection is None or selection is False:
            return self.row_valid
        key = str(selection)
        if key not in self._selection_cache:
            self._selection_cache[key] = self.row_valid & self.bool_expr(key)
        return self._selection_cache[key]


class Executor:
    """Queue + dedupe + cache (reference: execution.py:86-129)."""

    def __init__(self):
        self.tasks = []
        self.signal_begin = Signal("begin")
        self.signal_progress = Signal("progress")
        self.signal_end = Signal("end")
        self.signal_cancel = Signal("cancel")
        self.passes = 0
        self._step_cache = {}
        self.local_cache = {}
        self.trace_log = []

    def schedule(self, task: Task):
        self.tasks.append(task)
        return task

    def schedule_aggregation(self, df, binners, op):
        """Merge aggregations sharing one binner stack into one task
        (reference: execution.py:47-73 _merge)."""
        binners = tuple(binners)
        for task in self.tasks:
            if (isinstance(task, TaskAggregations) and task.df is df
                    and task.binners == binners and not task.done):
                return task.add_subtask(op)
        task = TaskAggregations(df, binners)
        sub = task.add_subtask(op)
        self.schedule(task)
        return sub

    def _pop_tasks(self):
        """All pending tasks of one DataFrame (reference: execution.py:115-129)."""
        if not self.tasks:
            return None, []
        df = self.tasks[0].df
        picked = [t for t in self.tasks if t.df is df and not t.cancelled]
        self.tasks = [t for t in self.tasks if t not in picked]
        return df, picked


class ExecutorLocal(Executor):
    # whole-pass cancellation/progress granularity (tiles per dispatch)
    WHOLE_PASS_CHUNK_TILES = 8

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh

    # -- public -------------------------------------------------------------
    def execute(self):
        while self.tasks:
            df, tasks = self._pop_tasks()
            if not tasks:
                break
            try:
                from .utils import trace
                with trace(f"pass[{','.join(t.name for t in tasks)}]"):
                    self._execute_pass(df, tasks)
            except Exception as e:
                for task in tasks:
                    if not task.done:
                        task.reject(e)
                raise

    # -- the pass -----------------------------------------------------------
    def _execute_pass(self, df, tasks):
        import time
        from .cache import lookup as cache_lookup, store as cache_store
        self.passes += 1
        t_start = time.time()
        self.signal_begin.emit()

        # result cache (reference: execution.py:96-109)
        df_fp = df.fingerprint()
        remaining = []
        for task in tasks:
            key = f"{task.fingerprint()}-{df_fp}"
            hit = cache_lookup(key)
            if hit is not None and not isinstance(task, TaskAggregations):
                task.fulfill(hit)
            else:
                task._cache_key = key
                remaining.append(task)
        tasks = remaining
        if not tasks:
            self.signal_end.emit()
            return

        device_tasks = [t for t in tasks if t.device]
        host_tasks = [t for t in tasks if not t.device]

        # classify expressions; device tasks with host-only expressions get
        # those expressions evaluated host-side and shipped as tile inputs
        host_stage_exprs = []   # expressions computed on host, fed to device
        device_columns = set()  # physical columns needed on device
        set_variables = {}      # var name -> SortedSet (device probe inputs)
        filter_expr = df._filter_expression()

        def classify(expr):
            expr = str(expr)
            if expression_is_device(df, expr):
                funcs, columns, variables = classify_leaves(df, expr)
                device_columns.update(columns)
                for v in variables:
                    val = df.variables.get(v)
                    if isinstance(val, SortedSet):
                        set_variables[v] = val
                return True
            if expr not in host_stage_exprs:
                host_stage_exprs.append(expr)
            return False

        for task in device_tasks:
            for expr in task.expressions:
                classify(expr)
        filter_on_device = None
        if filter_expr is not None:
            filter_on_device = classify(filter_expr)

        # host stage needs: its own exprs + all host-task exprs
        host_columns = set()
        host_needed = list(host_stage_exprs)
        for task in host_tasks:
            host_needed.extend(task.expressions)
        for expr in host_needed:
            _, columns, _ = classify_leaves(df, expr)
            host_columns.update(columns)
        if host_tasks and filter_expr is not None:
            _, columns, _ = classify_leaves(df, filter_expr)
            host_columns.update(columns)

        need_host_scope = bool(host_needed) or bool(host_tasks)
        all_columns = sorted(device_columns | host_columns)

        # tile input order: device physical columns then host-stage results
        tile_inputs = sorted(device_columns) + [f"__host_{i}" for i in range(len(host_stage_exprs))]
        host_expr_by_slot = {f"__host_{i}": e for i, e in enumerate(host_stage_exprs)}

        T = df._tile_rows or settings.TILE_ROWS
        if self.mesh is not None and self.mesh.size > 1:
            from .utils import round_up
            T = round_up(T, self.mesh.size)
        dataset = df.dataset_for_execution()
        n_total = dataset.row_count
        # huge-grid aggregations ride the sort path, whose per-tile cost is
        # O(G) regardless of tile size (G-sized searchsorted + state update
        # per tile); for device-resident data one whole-table tile turns that
        # into ONE global sort + ONE boundary-gather pass (q10-class groupby:
        # 25.5s -> one sort)
        prefs = [t.preferred_tile_rows(n_total) for t in device_tasks]
        if (prefs and all(p is not None for p in prefs)
                and not host_tasks and not host_stage_exprs
                and (self.mesh is None or self.mesh.size <= 1)
                and dataset.device_columns(sorted(device_columns)) is not None):
            T = max(T, *prefs)

        # initial accumulator state; tasks with geometry-dependent state
        # (collect-style ops like exact percentile) read the pass tiling
        for t in device_tasks:
            t._pass_tile_rows = T
            t._pass_n_total = n_total
        states = [t.initial_state() for t in device_tasks]
        states = jax.tree_util.tree_map(jnp.asarray, states)

        # device-built sets keep their key array in HBM (_device_keys); reuse
        # it instead of re-uploading (1e7-key fused groupby sets = 80MB)
        aux = {name: (s._device_keys if getattr(s, "_device_keys", None) is not None
                      else jnp.asarray(s.keys))
               for name, s in set_variables.items()}

        outputs_per_task = [[] for _ in device_tasks]

        # whole-pass fast path: all data device-resident, all tasks carry
        # their state in the accumulator -> ONE compiled fori_loop over tiles
        # (per device under a mesh: each device loops over its row shard and
        # the partial states merge with ONE collective at the end)
        spmd_whole = self.mesh is not None and self.mesh.size > 1
        resident = None
        if (device_tasks and not host_tasks and not host_stage_exprs
                and filter_on_device is not False
                and (not spmd_whole or all(isinstance(t, TaskAggregations)
                                           for t in device_tasks))
                and all(getattr(t, "scan_safe", False) for t in device_tasks)):
            resident = dataset.device_columns(tile_inputs)
        if resident is not None:
            self.whole_passes = getattr(self, "whole_passes", 0) + 1
            # resident narrowing: i64/u64 device columns with a PROVEN int32
            # range (category metadata always; minmax memo only when no
            # filter streams raw rows past it) read as cached i32 copies —
            # halves the key stream's HBM traffic; the step widens in-trace
            narrow_cache = getattr(self, "_narrow_cache", None)
            if narrow_cache is None:
                narrow_cache = self._narrow_cache = {}
            wire_narrow_res = {}
            for name in tile_inputs:
                if name in host_expr_by_slot or name not in resident:
                    continue
                try:
                    dt = DataType(df.data_type(name)).numpy
                except Exception:
                    continue
                if dt.kind not in "iu" or dt.itemsize <= 4:
                    continue
                lo = hi = None
                if df.is_category(name):
                    lo = df.category_offset(name)
                    hi = lo + df.category_count(name) - 1
                elif filter_expr is None:
                    vb = df._int_value_bound(name, compute=False)
                    if vb is not None:
                        lo, hi = vb
                if lo is None or lo < -(2 ** 31) or hi >= 2 ** 31:
                    continue
                ck = (df.fingerprint(), name)
                narrowed = narrow_cache.get(ck)
                if narrowed is None:
                    narrowed = jnp.asarray(resident[name]).astype(jnp.int32)
                    if len(narrow_cache) >= 4:
                        narrow_cache.pop(next(iter(narrow_cache)))
                    narrow_cache[ck] = narrowed
                resident = dict(resident)
                resident[name] = narrowed
                wire_narrow_res[name] = dt
            from .utils import trace
            with trace("whole-pass build+key"):
                whole = self._get_whole_pass(
                    df, device_tasks, tile_inputs, host_expr_by_slot, set_variables,
                    filter_expr if filter_on_device else None, T, n_total,
                    wire_narrow=wire_narrow_res)
            n_tiles = -(-n_total // T)
            # progress/cancel granularity: one dispatch per CHUNK_TILES tiles
            # when someone is listening (reference execution.py:253-258 emits
            # per chunk); otherwise one dispatch for the whole pass
            observed = bool(self.signal_progress.callbacks)
            chunk = self.WHOLE_PASS_CHUNK_TILES if observed else n_tiles
            with trace("whole-pass dispatch+run"):
                cancelled = False
                for t0 in range(0, n_tiles, max(chunk, 1)):
                    t1 = min(t0 + chunk, n_tiles)
                    states = whole(states, resident, aux, np.int32(t0), np.int32(t1))
                    if observed:
                        states = jax.block_until_ready(states)
                        progress = min(t1 * T / max(n_total, 1), 1.0)
                        if any(r is False for r in self.signal_progress.emit(progress)):
                            cancelled = True
                            break
                states = jax.block_until_ready(states)
            if cancelled:
                self.signal_cancel.emit()
                for task in tasks:
                    task.reject(UserAbort("user aborted"))
                return
            self.signal_progress.emit(1.0)
            with trace("whole-pass finalize"):
                self._finalize_pass(df, device_tasks, host_tasks, states,
                                    outputs_per_task, n_total, T, t_start)
            return

        # wire narrowing: int64/uint64 columns with a PROVEN int32 range
        # (category metadata or a memoized minmax) ship as i32 over the
        # host->device link — the streaming bottleneck — and widen back to
        # their logical dtype on device, so expression semantics are
        # untouched (16 -> 12 B/row for the canonical key+value stream)
        wire_narrow = {}
        f32_memo = getattr(self, "_f32_exact_memo", None)
        if f32_memo is None:
            f32_memo = self._f32_exact_memo = {}
        f32_check = {}  # this pass's running exactness verdicts per column
        if device_tasks and dataset.device_columns(sorted(device_columns)) is None:
            for name in sorted(device_columns):
                try:
                    dt = DataType(df.data_type(name)).numpy
                except Exception:
                    continue
                if dt.kind == "f" and dt.itemsize == 8:
                    # f64 columns PROVEN exactly f32-representable (a full
                    # prior pass checked every raw value, NaN-tolerant) ship
                    # as f32 and widen back on device — lossless, halves the
                    # value-stream wire bytes.  The check is
                    # on raw streamed tiles, so it is filter-safe.
                    state = f32_memo.get((df.fingerprint(), name))
                    if state is True:
                        wire_narrow[name] = dt
                    elif state is None:
                        f32_check[name] = True  # verify during this pass
                    continue
                if dt.kind not in "iu" or dt.itemsize <= 4:
                    continue
                lo = hi = None
                if df.is_category(name):
                    # category metadata is a declared column-level domain: it
                    # covers RAW values, so it stays valid under a filter
                    lo = df.category_offset(name)
                    hi = lo + df.category_count(name) - 1
                elif filter_expr is None:
                    # a memoized minmax on a filtered df respects the filter,
                    # but tiles stream RAW unfiltered rows — filtered-out
                    # values beyond int32 would wrap on the narrowed wire and
                    # could wrongly pass the on-device filter (advisor r3
                    # high): only trust the memo when no filter is active
                    vb = df._int_value_bound(name, compute=False)
                    if vb is not None:
                        lo, hi = vb
                if lo is not None and -(2 ** 31) <= lo and hi < 2 ** 31:
                    wire_narrow[name] = dt

        step = None
        if device_tasks:
            step = self._get_step(df, device_tasks, tile_inputs, host_expr_by_slot,
                                  set_variables, filter_expr if filter_on_device else None,
                                  host_filter=filter_expr if filter_on_device is False else None,
                                  tile_rows=T, wire_narrow=wire_narrow)

        def stage_tile(i1, i2, chunks, host_scope):
            """Host side of one tile: pad/convert columns (+host filter),
            narrowing proven-int32 wires (the step widens back on device)."""
            tile = {}
            host_filter_tile = None
            for name in tile_inputs:
                if name in host_expr_by_slot:
                    values = host_scope.evaluate_raw(host_expr_by_slot[name])
                else:
                    values = chunks[name]
                if isinstance(values, jnp.ndarray):
                    # device-resident column (df.to_device()): no host copy
                    tile[name] = (_pad(values, T), None)
                    continue
                from .ops.setops import _as_dict_string_arrow
                darr = _as_dict_string_arrow(values)
                if darr is not None:
                    # dictionary-encoded strings ship as their int32 codes
                    # (device work on such columns is category binning; the
                    # labels stay host-side in the category metadata)
                    mask = (np.asarray(darr.is_null())
                            if darr.null_count else None)
                    data = np.asarray(darr.indices.fill_null(0)
                                      if darr.null_count else darr.indices)
                    data = data.astype(np.int32, copy=False)
                    tile[name] = (_pad(data, T),
                                  _pad(mask, T) if mask is not None else None)
                    continue
                data, mask = array_types.data_and_mask(values)
                if data.dtype.kind in "Mm":
                    data = data.view(np.int64)
                if data.dtype == object:
                    raise TypeError(f"cannot ship object column {name!r} to device; "
                                    "string expressions must stay host-side")
                if name in wire_narrow:
                    data = data.astype(np.float32 if data.dtype.kind == "f"
                                       else np.int32)
                elif f32_check.get(name):
                    d32 = data.astype(np.float32).astype(np.float64)
                    if not bool(np.all((data == d32) | np.isnan(data))):
                        f32_check[name] = False
                tile[name] = (_pad(data, T), _pad(mask, T) if mask is not None else None)
            if filter_on_device is False and filter_expr is not None:
                fv = host_scope.evaluate_raw(filter_expr)
                fdata, fmask = array_types.data_and_mask(fv)
                fb = fdata.astype(bool)
                if fmask is not None:
                    fb &= ~fmask
                host_filter_tile = _pad(fb, T)
            return tile, host_filter_tile

        cancelled = False
        chunk_stream = dataset.chunk_iterator(all_columns, T)
        # transfer-ahead pipeline: staging + H2D enqueue of tile k+1 run on a
        # worker thread while the device computes tile k, keeping the host
        # link saturated (the streaming bottleneck; the
        # reference's separate IO pool, multithreading.py:34-38)
        transfer_ahead = (device_tasks and not host_tasks
                          and (self.mesh is None or self.mesh.size <= 1)
                          and settings.TRANSFER_AHEAD > 0 and n_total > T)
        if transfer_ahead:
            def _device_stream():
                for i1, i2, chunks in chunk_stream:
                    host_scope = (HostScope(df, i1, i2,
                                            {k: chunks[k] for k in host_columns})
                                  if need_host_scope else None)
                    tile, hf = stage_tile(i1, i2, chunks, host_scope)
                    dtile = {k: (jax.device_put(d),
                                 jax.device_put(m) if m is not None else None)
                             for k, (d, m) in tile.items()}
                    hfd = jax.device_put(hf) if hf is not None else None
                    yield i1, i2, dtile, hfd

            for i1, i2, dtile, hfd in _prefetched(_device_stream(),
                                                  settings.TRANSFER_AHEAD):
                n = i2 - i1
                states, outputs = step(states, dtile, np.int32(n), np.int32(i1),
                                       aux, hfd)
                for idx, out in enumerate(outputs):
                    if out is not None:
                        outputs_per_task[idx].append((out, n))
                progress = i2 / max(n_total, 1)
                if any(r is False for r in self.signal_progress.emit(progress)):
                    cancelled = True
                    break
            chunk_stream = ()  # consumed by the pipeline
        if settings.PREFETCH > 0 and n_total > T and not transfer_ahead:
            # readahead thread: disk/decompression of chunk k+1 overlaps the
            # host stage + device compute of chunk k (the reference's separate
            # IO pool, multithreading.py:34-38; tiles here are pulled eagerly)
            chunk_stream = _prefetched(chunk_stream, settings.PREFETCH)
        for i1, i2, chunks in chunk_stream:
            n = i2 - i1
            host_scope = HostScope(df, i1, i2, {k: chunks[k] for k in host_columns}) if need_host_scope else None

            # host tasks (set builds, map-reduce)
            if host_tasks:
                row_valid_host = None
                if filter_expr is not None and any(t.pre_filter for t in host_tasks):
                    fv = host_scope.evaluate_raw(filter_expr)
                    fdata, fmask = array_types.data_and_mask(fv)
                    row_valid_host = fdata.astype(bool)
                    if fmask is not None:
                        row_valid_host &= ~fmask
                for task in host_tasks:
                    task.process(i1, i2, host_scope,
                                 row_valid=row_valid_host if task.pre_filter else None)

            if device_tasks:
                tile, host_filter_tile = stage_tile(i1, i2, chunks, host_scope)
                states, outputs = step(states, tile, np.int32(n), np.int32(i1), aux,
                                       host_filter_tile)
                for idx, out in enumerate(outputs):
                    if out is not None:
                        outputs_per_task[idx].append((out, n))

            progress = i2 / max(n_total, 1)
            if any(result is False for result in self.signal_progress.emit(progress)):
                cancelled = True
                break

        if cancelled:
            self.signal_cancel.emit()
            for task in tasks:
                task.reject(UserAbort("user aborted"))
            return
        # commit the f32-exactness verdicts: every raw tile of the full pass
        # was checked, so the next pass may narrow (or must never try)
        for name, ok in f32_check.items():
            f32_memo[(df.fingerprint(), name)] = bool(ok)
        self._finalize_pass(df, device_tasks, host_tasks, states,
                            outputs_per_task, n_total, T, t_start)

    def _finalize_pass(self, df, device_tasks, host_tasks, states,
                       outputs_per_task, n_total, T, t_start):
        from .cache import store as cache_store
        # finalize: per-tile outputs come to the host in one transfer (each
        # device fetch is a round trip); accumulator STATE stays on device
        # unless the task's ops need host math — big result grids
        # (1e7-group counts/sums) then land directly as device-resident
        # result columns, and the D2H copy only happens if the user
        # materializes
        outputs_host = jax.device_get([[o for o, n in outs] for outs in outputs_per_task])
        states_host = [jax.device_get(s) if getattr(t, "host_finalize", True) else s
                       for t, s in zip(device_tasks, states)]
        for task, state, outputs, outs_host in zip(device_tasks, states_host,
                                                   outputs_per_task, outputs_host):
            if getattr(task, "trim_outputs", True):
                # row-shaped per-tile outputs: drop the padding rows
                trimmed = [jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], oh)
                           for oh, (_, n) in zip(outs_host, outputs)]
            else:
                trimmed = outs_host
            result = task.finalize(state, trimmed)
            if hasattr(task, "_cache_key"):
                # device-resident results go to the byte-bounded device LRU
                # (eviction frees HBM; the default backend is unbounded)
                cache_store(task._cache_key, result,
                            device=not getattr(task, "host_finalize", True))
        for task in host_tasks:
            result = task.get_result()
            if hasattr(task, "_cache_key"):
                cache_store(task._cache_key, result)
        # pass trace (SURVEY §5: the reference only has a passes counter;
        # here every pass logs rows/tiles/wall time for profiling)
        import time as _t
        self.trace_log.append({
            "pass": self.passes,
            "wall_s": _t.time() - t_start,
            "rows": n_total,
            "tile_rows": T,
            "tasks": [t.name for t in device_tasks + host_tasks],
            "device_tasks": len(device_tasks),
            "host_tasks": len(host_tasks),
        })
        if len(self.trace_log) > 1000:
            del self.trace_log[:500]
        self.signal_end.emit()

    # -- compiled step cache -------------------------------------------------
    def _step_key(self, df, device_tasks, tile_inputs, host_expr_by_slot,
                  set_variables, device_filter_expr, host_filter, tile_rows, extra=None):
        return fingerprint(
            [t.fingerprint() for t in device_tasks], tile_inputs,
            sorted(host_expr_by_slot.items()), device_filter_expr,
            host_filter is not None, tile_rows,
            # n_keys/dtype, NOT len(s.keys): touching .keys forces the lazy
            # D2H copy of device-built sets
            {k: (s.n_keys, s.has_nan, s.has_null, str(s.dtype)) for k, s in set_variables.items()},
            df._virtual_state_fingerprint(),
            # non-set variables are baked into the trace as constants, so the
            # cached step must be keyed on their values
            {k: (v.fingerprint() if hasattr(v, "fingerprint") else repr(v))
             for k, v in df.variables.items() if not isinstance(v, SortedSet)},
            extra,
        )

    def _get_step(self, df, device_tasks, tile_inputs, host_expr_by_slot,
                  set_variables, device_filter_expr, host_filter, tile_rows,
                  wire_narrow=None):
        key = self._step_key(df, device_tasks, tile_inputs, host_expr_by_slot,
                             set_variables, device_filter_expr, host_filter, tile_rows,
                             extra=tuple(sorted((wire_narrow or {}).items())) or None)
        if key in self._step_cache:
            return self._step_cache[key]

        set_meta = {name: (s.n_keys, s.has_nan, s.has_null, s)
                    for name, s in set_variables.items()}
        mesh = self.mesh
        spmd = mesh is not None and mesh.size > 1
        axis_name = mesh.axis_names[0] if spmd else None

        step = _make_step_fn(df, device_tasks, tile_inputs, host_expr_by_slot,
                             set_meta, device_filter_expr, tile_rows,
                             mesh=mesh if spmd else None, axis_name=axis_name,
                             wire_narrow=wire_narrow)

        if spmd:
            from jax.sharding import PartitionSpec as P
            dname = axis_name
            sharded = jax.shard_map(
                step, mesh=mesh,
                in_specs=(P(), {k: P(dname) for k in tile_inputs}, P(), P(), P(),
                          P(dname)),
                out_specs=(P(), P(dname)),
                check_vma=False,
            )
            jitted0 = jax.jit(sharded, donate_argnums=(0,))

            def call(states, tile, n_valid, i1, aux, host_filter_tile):
                if host_filter_tile is None:
                    # shard_map can't take None for a sharded leaf: substitute
                    # an all-true mask (filter handled on device or absent)
                    host_filter_tile = _TRUE_TILE.setdefault(
                        tile_rows, np.ones(tile_rows, bool))
                return jitted0(states, tile, jnp.asarray(n_valid), jnp.asarray(i1),
                               aux, host_filter_tile)
            jitted = call
        else:
            jitted = jax.jit(step, donate_argnums=(0,))
        self._step_cache[key] = jitted
        return jitted

    def _get_whole_pass(self, df, device_tasks, tile_inputs, host_expr_by_slot,
                        set_variables, device_filter_expr, tile_rows, n_total,
                        wire_narrow=None):
        """One compiled program for the WHOLE pass over device-resident data.

        A ``fori_loop`` over tiles replaces the Python dispatch loop: no
        per-tile dispatch latency, no per-tile slice ops, one async
        dispatch per pass.  Only taken for
        tasks whose ``update`` carries all state (``scan_safe``) and when
        every needed column is already a whole ``jax.Array``.
        """
        key = self._step_key(df, device_tasks, tile_inputs, host_expr_by_slot,
                             set_variables, device_filter_expr, None, tile_rows,
                             extra=("whole-pass", n_total,
                                    tuple(sorted((wire_narrow or {}).items())) or None))
        if key in self._step_cache:
            return self._step_cache[key]
        set_meta = {name: (s.n_keys, s.has_nan, s.has_null, s)
                    for name, s in set_variables.items()}
        mesh = self.mesh if (self.mesh is not None and self.mesh.size > 1) else None
        axis_name = mesh.axis_names[0] if mesh is not None else None
        step = _make_step_fn(df, device_tasks, tile_inputs, host_expr_by_slot,
                             set_meta, device_filter_expr, tile_rows,
                             mesh=mesh, axis_name=axis_name,
                             wire_narrow=wire_narrow)
        n_tiles = -(-n_total // tile_rows)
        slice_names = list(tile_inputs)

        if mesh is None:
            def whole(states, cols, aux, t0, t1):
                padded = n_tiles * tile_rows
                cols = {name: (jnp.pad(col, (0, padded - col.shape[0]))
                               if col.shape[0] != padded else col)
                        for name, col in cols.items()}

                def body(i, states):
                    i1 = (i * tile_rows).astype(jnp.int32)
                    tile = {name: (jax.lax.dynamic_slice_in_dim(cols[name], i1, tile_rows), None)
                            for name in slice_names}
                    n_valid = jnp.minimum(jnp.int32(n_total) - i1, tile_rows)
                    states, _ = step(states, tile, n_valid, i1, aux, None)
                    return states

                # [t0, t1) tile range: the executor chunks the pass into
                # several dispatches when progress observers need
                # cancellation points
                return jax.lax.fori_loop(t0, t1, body, states)
        else:
            # SPMD whole pass: rows shard contiguously over the mesh, ceil(N/D)
            # per device (the layout to_device() gives a table under this
            # mesh, so its columns are read where they lie); each device
            # pads its shard to whole tiles and fori-loops its LOCAL tiles,
            # the per-tile update_spmd merges partials with the ops'
            # collectives (psum/pmin/pmax) — the multi-chip version of the
            # reference's per-thread parts + tree reduce, with no per-tile
            # Python dispatch
            from jax.sharding import PartitionSpec as P
            D = mesh.size
            t_local = tile_rows // D
            rps = -(-n_total // D)  # rows per shard
            local_rows = n_tiles * t_local  # a shard padded to whole tiles

            def whole(states, cols, aux, t0, t1):
                cols = {name: jnp.pad(col, (0, rps * D - col.shape[0]))
                        if col.shape[0] != rps * D else col
                        for name, col in cols.items()}

                def local(states, cols, aux):
                    d = jax.lax.axis_index(axis_name).astype(jnp.int32)
                    cols = {name: jnp.pad(col, (0, local_rows - rps))
                            if local_rows != rps else col
                            for name, col in cols.items()}
                    # rows of this shard that are table rows (the last
                    # shard holds the padding to a multiple of D)
                    shard_valid = jnp.minimum(jnp.int32(rps),
                                              jnp.int32(n_total) - d * jnp.int32(rps))

                    def body(i, states):
                        r0 = (i * t_local).astype(jnp.int32)
                        tile = {name: (jax.lax.dynamic_slice_in_dim(cols[name], r0, t_local), None)
                                for name in slice_names}
                        # local row j is valid when r0+j < shard_valid; the
                        # step tests iota + d*t_local < n_valid, so shift:
                        n_valid = (jnp.clip(shard_valid - r0, 0, t_local)
                                   + d * jnp.int32(t_local))
                        # step adds local_offset (= d*t_local) + iota to i1
                        # for row ids: compensate so ids are the true global
                        i1 = d * jnp.int32(rps) + r0 - d * jnp.int32(t_local)
                        states, _ = step(states, tile, n_valid, i1, aux, None)
                        return states

                    return jax.lax.fori_loop(t0, t1, body, states)

                fn = jax.shard_map(local, mesh=mesh,
                                   in_specs=(P(), P(mesh.axis_names[0]), P()),
                                   out_specs=P(), check_vma=False)
                return fn(states, cols, aux)

        jitted = jax.jit(whole, donate_argnums=(0,))
        self._step_cache[key] = jitted
        return jitted


def _make_step_fn(df, device_tasks, tile_inputs, host_expr_by_slot, set_meta,
                  device_filter_expr, tile_rows, mesh=None, axis_name=None,
                  wire_narrow=None):
    """The traced per-tile step shared by the per-tile and whole-pass paths."""
    from .tasks import TaskAggregations
    spmd = mesh is not None
    widen = {k: np.dtype(v) for k, v in (wire_narrow or {}).items()}

    def step(states, tile, n_valid, i1, aux, host_filter_tile):
        T = next(iter(tile.values()))[0].shape[0] if tile else (
            tile_rows // mesh.size if spmd else tile_rows)
        local_offset = 0
        if spmd:
            local_offset = jax.lax.axis_index(axis_name).astype(jnp.int32) * T
        na_tile = {}
        for name, (data, mask) in tile.items():
            if name in widen:  # narrowed wire: restore the logical dtype
                data = data.astype(widen[name])
            na_tile[name] = NA(data, mask)
            if name in host_expr_by_slot:
                na_tile[host_expr_by_slot[name]] = na_tile[name]
        aux_sets = {name: DeviceSetHandle(aux[name], n_keys, has_nan, has_null, host_set=hs)
                    for name, (n_keys, has_nan, has_null, hs) in set_meta.items()}
        scope = DeviceScope(df, na_tile, aux_sets)
        padding_valid = (jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0).squeeze(-1)
                         + local_offset < n_valid)
        filter_valid = None
        if device_filter_expr is not None:
            value = scope.evaluate(device_filter_expr)
            filter_valid = value.data.astype(bool)
            if value.mask is not None:
                filter_valid = filter_valid & ~value.mask
        elif host_filter_tile is not None:
            filter_valid = host_filter_tile
        ctx = TileContext(scope, padding_valid, filter_valid, i1, T,
                          local_offset=local_offset)
        new_states = []
        outputs = []
        for task, state in zip(device_tasks, states):
            if spmd and isinstance(task, TaskAggregations):
                new_state, out = task.update_spmd(state, ctx, axis_name)
            else:
                new_state, out = task.update(state, ctx)
            new_states.append(new_state)
            outputs.append(out)
        return new_states, outputs

    return step


_TRUE_TILE = {}


def _prefetched(iterator, depth):
    """Pull ``iterator`` on a daemon thread, buffering up to ``depth`` items.

    Exceptions re-raise at the consumption point; abandoning the generator
    (cancellation) stops the producer at its next put.
    """
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def produce():
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(e)

    thread = threading.Thread(target=produce, daemon=True, name="vaex-tpu-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _pad(ar, T):
    n = len(ar)
    if isinstance(ar, jnp.ndarray):
        if n == T:
            return ar
        return jnp.concatenate([ar, jnp.zeros(T - n, ar.dtype)])
    if n == T:
        return np.ascontiguousarray(ar)
    out = np.zeros(T, dtype=ar.dtype)
    out[:n] = ar
    return out


def _trim_outputs(outputs):
    """[(tree_of_arrays, n_valid), ...] -> list of host trees trimmed to n."""
    trimmed = []
    for out, n in outputs:
        trimmed.append(jax.tree_util.tree_map(lambda a: np.asarray(a)[:n], out))
    return trimmed
