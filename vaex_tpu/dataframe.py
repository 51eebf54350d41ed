"""DataFrame: the pandas-like lazy API over the device execution engine.

Re-design of the reference's ``vaex/dataframe.py`` (6.8 kLoC DataFrame /
DataFrameLocal).  One class here: a DataFrame owns an immutable Dataset
(column storage graph), plus pure-metadata state — virtual columns,
variables, functions, named selections (the filter is the reserved selection
``__filter__``, reference dataframe.py:405) and category metadata.  All
computation is deferred: stats build aggregation tasks executed in a single
fused pass on the device (see :mod:`vaex_tpu.execution`).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

from . import agg as agg_module
from . import array_types, selections as selections_module
from .column import ColumnVirtualRange
from .dataset import Dataset, DatasetArrays
from .datatype import DataType, dtype_of
from .delayed import Promise, delayed
from .expression import Expression
from .scopes import HostScope, classify_leaves, expression_is_device
from .selections import FILTER_SELECTION_NAME, Selection, SelectionExpression
from .tasks import TaskEvaluate, TaskFilterFill, TaskMapReduce, TaskSetCreate
from .utils import Signal, find_valid_name, fingerprint

logger = logging.getLogger("vaex_tpu.dataframe")

_main_executor = None


def get_main_executor():
    global _main_executor
    if _main_executor is None:
        from .execution import ExecutorLocal
        _main_executor = ExecutorLocal()
    return _main_executor


class DataFrame:
    def __init__(self, dataset: Dataset, executor=None):
        from .utils import valid_expression_name
        # invalid identifiers can't appear in expressions: rename on entry
        # (reference: utils.find_valid_name mangling)
        renaming = {}
        for name in list(dataset):
            if not valid_expression_name(name):
                renaming[name] = find_valid_name(name, used=set(dataset) | set(renaming.values()))
        if renaming:
            dataset = dataset.renamed(renaming)
        self.dataset = dataset
        self.executor = executor or get_main_executor()
        self.column_names: List[str] = list(dataset)
        self.virtual_columns: Dict[str, str] = {}
        self.variables: Dict[str, object] = {}
        self.functions: Dict[str, object] = {}
        self._function_impls: Dict[str, object] = {}
        self.selections: Dict[str, Selection] = {}
        self.selection_histories: Dict[str, list] = {}
        self.selection_history_indices: Dict[str, int] = {}
        self._categories: Dict[str, dict] = {}
        # per-column metadata (reference: ucds/units/descriptions)
        self.units: Dict[str, str] = {}
        self.ucds: Dict[str, str] = {}
        self.descriptions: Dict[str, str] = {}
        self.description = None
        self._tile_rows = None  # test hook: force tiny tiles (small_buffer)
        self._selection_mask_cache: Dict[str, np.ndarray] = {}
        self._length_unfiltered = dataset.row_count
        self._index_start = 0
        self._index_end = dataset.row_count
        self._future_behaviour = False
        self.signal_selection_changed = Signal("selection-changed")
        self._var_counter = 0

    # ------------------------------------------------------------------ copy
    def copy(self, column_names=None):
        df = DataFrame.__new__(DataFrame)
        df.dataset = self.dataset
        df.executor = self.executor
        df.column_names = list(column_names if column_names is not None else self.column_names)
        df.virtual_columns = dict(self.virtual_columns)
        df.variables = dict(self.variables)
        df.functions = dict(self.functions)
        df.selections = dict(self.selections)
        df._function_impls = dict(getattr(self, "_function_impls", {}))
        df.units = dict(self.units)
        df.ucds = dict(self.ucds)
        df.descriptions = dict(self.descriptions)
        df.description = self.description
        df.selection_histories = {k: list(v) for k, v in self.selection_histories.items()}
        df.selection_history_indices = dict(self.selection_history_indices)
        df._categories = dict(self._categories)
        df._tile_rows = self._tile_rows
        df._selection_mask_cache = dict(self._selection_mask_cache)
        df._length_unfiltered = self._length_unfiltered
        df._index_start = self._index_start
        df._index_end = self._index_end
        df._future_behaviour = self._future_behaviour
        df.signal_selection_changed = Signal("selection-changed")
        df._var_counter = self._var_counter
        if column_names is not None:
            # keep virtual columns / hidden deps referenced by kept columns
            pass
        return df

    def to_copy(self, column_names=None, selection=None, strings=True,
                virtual=True, selections=True):
        """Copy of the DataFrame; with a selection the selected rows
        materialize, else data is shared by reference
        (reference dataframe.py:3049)."""
        if selection is not None:
            from . import from_dict
            df = from_dict(self.to_dict(column_names=column_names,
                                        selection=selection, strings=strings,
                                        virtual=virtual))
            return df
        names = column_names
        if names is None and (not strings or not virtual):
            names = self.get_column_names(strings=strings, virtual=virtual)
        df = self.copy(column_names=names)
        if not virtual:
            df.virtual_columns = {}
            df.column_names = [n for n in df.column_names
                               if n not in self.virtual_columns]
        if not selections:
            df.selections = {}
            df.selection_histories = {}
            df.selection_history_indices = {}
        return df

    def delete_virtual_column(self, name):
        """Remove a virtual column (reference dataframe.py:3631)."""
        if name not in self.virtual_columns:
            raise KeyError(f"{name!r} is not a virtual column")
        del self.virtual_columns[name]
        if name in self.column_names:
            self.column_names.remove(name)

    def is_masked(self, column):
        """Whether the column is masked-array/nullable-typed — a type
        check, not a value scan (reference dataframe.py:2099)."""
        column = str(column)
        if column in self.dataset:
            col = self.dataset[column][:]  # numpy mmap / arrow: zero-copy view
            if isinstance(col, np.ma.MaskedArray):
                return True
            try:
                import pyarrow as pa
                if isinstance(col, (pa.Array, pa.ChunkedArray)):
                    return col.null_count > 0
            except ImportError:  # pragma: no cover
                pass
            return False
        from . import array_types
        values = self[0:1].evaluate(column) if len(self) else None
        if values is None:
            return False
        data, mask = array_types.data_and_mask(values)
        return mask is not None

    def column_count(self, hidden=False):
        """Number of columns incl. virtual (reference dataframe.py:4012)."""
        return len(self.get_column_names(hidden=hidden))

    def _rebind_dataset(self, dataset, keep_filter=True):
        df = self.copy()
        df.dataset = dataset
        df._length_unfiltered = dataset.row_count
        df._index_start = 0
        df._index_end = dataset.row_count
        df._selection_mask_cache = {}
        if not keep_filter:
            df.selections.pop(FILTER_SELECTION_NAME, None)
        return df

    # ------------------------------------------------------------- identity
    def fingerprint(self):
        return fingerprint(
            "dataframe", self.dataset.fingerprint(), self.column_names,
            self.virtual_columns,
            {k: (v.fingerprint() if hasattr(v, "fingerprint") else repr(v))
             for k, v in self.variables.items()},
            {k: s.encode() for k, s in self.selections.items()},
            self._index_start, self._index_end,
        )

    def _virtual_state_fingerprint(self):
        return fingerprint(self.virtual_columns, sorted(self.variables))

    # ------------------------------------------------------------- columns
    def get_column_names(self, virtual=True, strings=True, hidden=False, regex=None):
        names = [n for n in self.column_names if hidden or not n.startswith("__")]
        if not virtual:
            names = [n for n in names if n not in self.virtual_columns]
        if not strings:
            names = [n for n in names if not DataType(self.data_type(n)).is_string]
        if regex:
            import re
            names = [n for n in names if re.match(regex, n)]
        return names

    def get_names(self, hidden=False):
        return self.get_column_names(hidden=hidden)

    @property
    def columns(self):
        return self.dataset

    def __contains__(self, name):
        return name in self.get_column_names(hidden=True)

    def add_column(self, name, data):
        """Add an in-memory column (materialized)."""
        if np.isscalar(data):
            from .column import ColumnVirtualConstant
            data = ColumnVirtualConstant(data, self.length_original())
        if len(data) != self.length_original():
            raise ValueError(f"array of length {len(data)} does not match dataframe length "
                             f"{self.length_original()}")
        new_dataset = DatasetArrays({name: data})
        if name in self.dataset:
            self.dataset = self.dataset.dropped(name).merged(new_dataset)
        else:
            self.dataset = self.dataset.merged(new_dataset) if len(self.dataset) else new_dataset
        if name not in self.column_names:
            self.column_names.append(name)

    def add_virtual_column(self, name, expression):
        from . import expresso
        name = find_valid_name(name)
        expression = str(expression)
        refers_self = name in expresso.collect_names(expression)
        if refers_self and name in self.virtual_columns:
            # substitute the old definition so x = x*2 means double the old x
            expression = expresso.substitute(expression, {name: f"({self.virtual_columns[name]})"})
        elif refers_self and name in self.dataset:
            # shadowing a physical column: rename it out of the way so the new
            # virtual column may reference the original data (reference
            # dataframe.py add_virtual_column rename semantics)
            hidden = find_valid_name(f"__{name}", used=self.column_names)
            self.dataset = self.dataset.renamed({name: hidden})
            self.column_names.append(hidden)
            expression = expresso.translate(expression, lambda n: hidden if n == name else None)
        self.virtual_columns[name] = expression
        if name not in self.column_names:
            self.column_names.append(name)
        return name

    def rename(self, name, new_name):
        """Rename a (virtual) column, rewriting referring expressions."""
        from . import expresso
        if name in self.virtual_columns:
            self.virtual_columns[new_name] = self.virtual_columns.pop(name)
        else:
            self.dataset = self.dataset.renamed({name: new_name})
        self.column_names = [new_name if n == name else n for n in self.column_names]
        self.virtual_columns = {
            k: expresso.translate(v, lambda n: new_name if n == name else None)
            for k, v in self.virtual_columns.items()}
        return new_name

    def drop(self, columns, inplace=False, check=True):
        columns = [columns] if isinstance(columns, (str, Expression)) else columns
        columns = [str(c) for c in columns]
        df = self if inplace else self.copy()
        for name in columns:
            if name in df.virtual_columns:
                del df.virtual_columns[name]
            df.column_names = [n for n in df.column_names if n != name]
        return df

    def add_variable(self, name, value, unique=False):
        if unique:
            # content-addressed naming: the same payload (e.g. a grouper's
            # key set) reuses its name, so repeated queries produce identical
            # expression strings and hit the compiled-step cache
            if hasattr(value, "fingerprint"):
                fp = value.fingerprint() if callable(value.fingerprint) else value.fingerprint
                name = f"__{name}_{str(fp)[:12]}"
                if name in self.variables:
                    return name
            else:
                try:
                    name = f"__{name}_{fingerprint(value)[:12]}"
                    if name in self.variables:
                        return name
                except Exception:
                    self._var_counter += 1
                    name = f"__{name}_{self._var_counter}"
        self.variables[name] = value
        return name

    def add_function(self, name, f, vectorize=True, unique=False, multiprocessing=False):
        if unique:
            self._var_counter += 1
            name = f"__fn_{name}_{self._var_counter}"
        name = find_valid_name(name)
        self.functions[name] = f

        def host_impl(*args, _f=f, _vectorize=vectorize, _mp=multiprocessing):
            datas = [array_types.to_numpy(a) if not np.isscalar(a) else a for a in args]
            if _mp:
                # GIL-dodging python UDFs (reference multiprocessing.py:28-35)
                from .multiprocessing import apply_parallel
                return apply_parallel(_f, datas, vectorize=_vectorize)
            if _vectorize:
                return np.asarray(_f(*datas))
            return np.asarray([_f(*row) for row in zip(*datas)])
        # df-LOCAL registration: UDFs must not leak across DataFrames
        if not hasattr(self, "_function_impls"):
            self._function_impls = {}
        self._function_impls[name] = host_impl
        return name

    def evaluate_variable(self, name):
        return self.variables[name]

    def unit(self, expression):
        return self.units.get(str(expression))

    def data_type(self, expression, array_type=None, internal=False, axis=0, expand=True):
        """dtype of an expression, inferred by evaluating a tiny slice."""
        expression = str(expression)
        if expression in self.dataset and expression not in self.virtual_columns:
            dt = dtype_of(self.dataset[expression])
            return dt if isinstance(dt, DataType) else DataType(dt)
        # virtual column or expression: evaluate 1 row (0 rows if empty)
        n = min(1, self.dataset.row_count)
        values = self._evaluate_host(expression, 0, n)
        if pa is not None and isinstance(values, (pa.Array, pa.ChunkedArray)):
            return DataType(values.type)
        return DataType(np.asarray(values).dtype if not isinstance(values, np.ma.MaskedArray)
                        else values.dtype)

    # ---------------------------------------------------------------- length
    def length_original(self):
        return self.dataset.row_count

    def length_unfiltered(self):
        return self._index_end - self._index_start

    @property
    def filtered(self):
        return FILTER_SELECTION_NAME in self.selections

    def count_rows(self):
        return len(self)

    def __len__(self):
        if not self.filtered:
            return self.length_unfiltered()
        from . import hostkern
        return int(hostkern.mask_count(self._get_filter_mask()))

    # --------------------------------------------------------------- filters
    def _filter_expression(self):
        sel = self.selections.get(FILTER_SELECTION_NAME)
        return sel.to_expression(self) if sel is not None else None

    def _get_filter_mask(self):
        """Materialized boolean mask over the unfiltered rows (the reference's
        tri-state superutils.Mask + TaskFilterFill, dataframe.py:5387)."""
        expr = self._filter_expression()
        key = fingerprint("filter", expr, self.dataset.fingerprint(), self._index_start, self._index_end)
        mask = self._selection_mask_cache.get(key)
        if mask is None:
            if expression_is_device(self, expr):
                task = TaskFilterFill(self, expr)
            else:
                task = TaskFilterFill(self, expr)
                task.device = False
            self.executor.schedule(task)
            self.executor.execute()
            mask = task.get()
            self._selection_mask_cache[key] = mask
        return mask

    def filter(self, expression, mode="and"):
        """Return a filtered DataFrame (reference dataframe.py:4984)."""
        df = self.copy()
        expression = str(expression) if not isinstance(expression, str) else expression
        previous = df.selections.get(FILTER_SELECTION_NAME)
        if previous is None and mode in ("and", "replace"):
            sel = SelectionExpression(expression)
        else:
            sel = SelectionExpression(expression, previous, mode if previous is not None else "replace")
        df.selections[FILTER_SELECTION_NAME] = sel
        df._selection_mask_cache = {}
        return df

    def extract(self):
        """Materialize the filter into the dataset (reference dataframe.py:4216)."""
        if not self.filtered:
            df = self.copy()
            if self._index_start != 0 or self._index_end != self.dataset.row_count:
                df = self._rebind_dataset(self.dataset.slice(self._index_start, self._index_end))
            return df
        mask = self._get_filter_mask()
        dataset = self.dataset_for_execution().filtered(mask)
        df = self._rebind_dataset(dataset)
        df.selections.pop(FILTER_SELECTION_NAME, None)
        return df

    def trim(self, inplace=False):
        df = self if inplace else self.copy()
        if df._index_start != 0 or df._index_end != df.dataset.row_count:
            ds = df.dataset.slice(df._index_start, df._index_end)
            df.dataset = ds
            df._index_start = 0
            df._index_end = ds.row_count
            df._length_unfiltered = ds.row_count
        return df

    def set_active_range(self, i1, i2):
        self._index_start = i1
        self._index_end = i2
        self._length_unfiltered = i2 - i1
        self._selection_mask_cache = {}

    def set_active_fraction(self, fraction):
        n = self.dataset.row_count
        self.set_active_range(0, int(fraction * n))

    def dataset_for_execution(self):
        ds = self.dataset
        if self._index_start != 0 or self._index_end != ds.row_count:
            ds = ds.slice(self._index_start, self._index_end)
        return ds

    # ------------------------------------------------------------ selections
    def select(self, expression, mode="replace", name="default"):
        """(reference dataframe.py:4712)"""
        expression = str(expression) if expression is not None else None
        previous = self.selections.get(name)
        if expression is None:
            sel = None
        else:
            sel = SelectionExpression(expression, previous, mode if previous is not None else "replace")
        self._set_selection(name, sel)

    def select_nothing(self, name="default"):
        self._set_selection(name, None)

    def select_inverse(self, name="default"):
        previous = self.selections.get(name)
        if previous is not None:
            self._set_selection(name, selections_module.SelectionInvert(previous))

    def select_box(self, spaces, limits, mode="replace", name="default"):
        exprs = [f"(({space}) >= {lim[0]}) & (({space}) < {lim[1]})" for space, lim in zip(spaces, limits)]
        self.select(" & ".join(f"({e})" for e in exprs), mode=mode, name=name)

    def select_rectangle(self, x, y, limits, mode="replace", name="default"):
        self.select_box([x, y], limits, mode=mode, name=name)

    def select_circle(self, x, y, xc, yc, r, mode="replace", name="default", inclusive=True):
        op = "<=" if inclusive else "<"
        self.select(f"((({x}) - {xc})**2 + (({y}) - {yc})**2) {op} {r}**2", mode=mode, name=name)

    def select_ellipse(self, x, y, xc, yc, width, height, angle=0, mode="replace", name="default",
                       radians=False):
        if not radians:
            angle = np.radians(angle)
        xr, yr = width / 2.0, height / 2.0
        ca, sa = np.cos(angle), np.sin(angle)
        expr = (f"(((({x}) - {xc}) * {ca} + (({y}) - {yc}) * {sa})**2 / {xr}**2 + "
                f"((({x}) - {xc}) * {sa} - (({y}) - {yc}) * {ca})**2 / {yr}**2) <= 1")
        self.select(expr, mode=mode, name=name)

    def select_lasso(self, expression_x, expression_y, xsequence, ysequence, mode="replace", name="default"):
        previous = self.selections.get(name)
        sel = selections_module.SelectionLasso(expression_x, expression_y, xsequence, ysequence,
                                               previous, mode if previous is not None else "replace")
        self._set_selection(name, sel)

    def select_non_missing(self, drop_nan=True, drop_masked=True, column_names=None,
                           mode="replace", name="default"):
        sel = selections_module.SelectionDropNa(column_names, drop_nan=drop_nan, drop_masked=drop_masked)
        self._set_selection(name, sel)

    def _set_selection(self, name, selection):
        if selection is None:
            self.selections.pop(name, None)
        else:
            self.selections[name] = selection
        history = self.selection_histories.setdefault(name, [])
        history.append(selection)
        self.selection_history_indices[name] = len(history) - 1
        self.signal_selection_changed.emit(self, name)

    def selection_undo(self, name="default"):
        history = self.selection_histories.get(name, [])
        index = self.selection_history_indices.get(name, -1)
        if index > 0:
            index -= 1
            self.selection_history_indices[name] = index
            sel = history[index]
            if sel is None:
                self.selections.pop(name, None)
            else:
                self.selections[name] = sel
        elif index == 0:
            self.selection_history_indices[name] = -1
            self.selections.pop(name, None)
        self.signal_selection_changed.emit(self, name)

    def selection_redo(self, name="default"):
        history = self.selection_histories.get(name, [])
        index = self.selection_history_indices.get(name, -1)
        if index + 1 < len(history):
            index += 1
            self.selection_history_indices[name] = index
            sel = history[index]
            if sel is None:
                self.selections.pop(name, None)
            else:
                self.selections[name] = sel
        self.signal_selection_changed.emit(self, name)

    def selection_can_undo(self, name="default"):
        return self.selection_history_indices.get(name, -1) > -1

    def selection_can_redo(self, name="default"):
        return (self.selection_history_indices.get(name, -1) + 1) < len(self.selection_histories.get(name, []))

    def has_selection(self, name="default"):
        return name in self.selections

    def get_selection(self, name="default"):
        return self.selections.get(name)

    def _selection_expression(self, selection):
        """Normalize a selection argument to an expression string or None."""
        if selection is None or selection is False:
            return None
        if selection is True:
            sel = self.selections.get("default")
            if sel is None:
                raise ValueError("selection=True but no selection is active")
            return sel.to_expression(self)
        if isinstance(selection, Selection):
            return selection.to_expression(self)
        name = str(selection)
        if name in self.selections:
            return self.selections[name].to_expression(self)
        return name  # an ad-hoc boolean expression

    # ------------------------------------------------------------ categories
    def categorize(self, column, min_value=0, labels=None, inplace=False):
        """Mark an integer column as categorical (reference dataframe.py:5487)."""
        df = self if inplace else self.copy()
        column = str(column)
        if labels is None:
            vmin, vmax = df.minmax(column)
            labels = np.arange(int(min_value), int(vmax) + 1)
            min_value = int(min_value)
        df._categories[column] = {"labels": list(labels), "N": len(labels), "min_value": min_value}
        return df

    def ordinal_encode(self, column, values=None, inplace=False, lazy=False):
        """Encode column as ordinal codes + category metadata
        (reference dataframe.py:5535)."""
        df = self if inplace else self.copy()
        column = str(column)
        if values is None:
            oset = df._set(column)
            values = list(oset.key_array(masked=False)[:oset.n_keys])
            oset_use = oset
        else:
            from .ops.setops import SortedSet
            values_arr = np.asarray(values)
            dtype = "string" if values_arr.dtype.kind in "OUS" else values_arr.dtype
            oset_use = SortedSet(dtype)
            oset_use.update(values_arr)
            values = list(values)
        var = df.add_variable("ordinal_set", oset_use, unique=True)
        name = f"{column}_ordinal" if not lazy else column
        codes_expr = f"_ordinal_values({column}, {var})"
        df.add_virtual_column(name if name != column else f"__{column}_codes", codes_expr)
        df._categories[name] = {"labels": values, "N": len(values), "min_value": 0}
        return df

    def is_category(self, column):
        column = str(column)
        if column in self._categories:
            return True
        dt = self.data_type(column)
        return DataType(dt).is_encoded

    def _category_meta(self, column):
        """Registered category metadata, lazily derived from the arrow
        dictionary for physically dictionary-encoded columns that were never
        explicitly ``categorize``d (e.g. a DictionaryArray passed to
        from_dict)."""
        column = str(column)
        meta = self._categories.get(column)
        if meta is not None:
            return meta
        col = None
        try:
            col = self.dataset[column]
        except Exception:
            pass
        labels = None
        if col is not None:
            labels_arrow = getattr(col, "_labels_arrow", None)
            if labels_arrow is not None:
                labels = labels_arrow.to_pylist()
            else:
                try:
                    import pyarrow as pa
                    if isinstance(col, pa.ChunkedArray) and col.num_chunks:
                        col = col.chunk(0)
                    if isinstance(col, pa.Array) and pa.types.is_dictionary(col.type):
                        labels = col.dictionary.to_pylist()
                except ImportError:  # pragma: no cover
                    pass
        if labels is None:
            raise KeyError(column)
        meta = {"labels": labels, "N": len(labels), "min_value": 0}
        self._categories[column] = meta
        return meta

    def category_labels(self, column, aslist=True):
        return self._category_meta(column)["labels"]

    def category_count(self, column):
        return self._category_meta(column)["N"]

    def category_offset(self, column):
        return self._category_meta(column)["min_value"]

    # ------------------------------------------------------------ evaluation
    def _evaluate_host(self, expression, i1, i2):
        """Evaluate on host over [i1, i2) in one chunk (small slices only)."""
        expression = str(expression)
        _, columns, _ = classify_leaves(self, expression)
        ds = self.dataset_for_execution()
        chunks = {}
        for name in columns:
            if name not in ds:
                raise NameError(f"column or variable {name!r} does not exist")
            chunks[name] = ds[name][i1:i2] if hasattr(ds[name], "__getitem__") else ds[name][i1:i2]
        scope = HostScope(self, i1, i2, chunks)
        return scope.evaluate_raw(expression)

    def evaluate(self, expression, i1=None, i2=None, out=None, selection=None,
                 filtered=True, array_type=None, parallel=True, chunk_size=None,
                 progress=None):
        """Materialize expression values (reference dataframe.py:2877)."""
        expression = str(expression)
        df = self
        if i1 is not None or i2 is not None:
            i1 = i1 or 0
            i2 = i2 if i2 is not None else len(self)
            if self.filtered and filtered:
                mask = self._get_filter_mask()
                from . import hostkern
                raw = hostkern.mask_indices(mask)[i1:i2]
                ds = self.dataset_for_execution().take(raw)
                df = self._rebind_dataset(ds, keep_filter=False)
                df.selections.pop(FILTER_SELECTION_NAME, None)
            else:
                ds = self.dataset_for_execution().slice(i1, i2)
                df = self._rebind_dataset(ds, keep_filter=False)
        sel_expr = self._selection_expression(selection) if selection is not None else None
        if sel_expr is not None:
            df = df.filter(sel_expr) if not df.filtered else df.filter(sel_expr, mode="and")
        use_filter = df.filtered and filtered
        if (expression in df.dataset and expression not in df.virtual_columns
                and not use_filter):
            # bare physical column: zero-cost view, no pass (reference
            # evaluate's column fast path)
            ds = df.dataset_for_execution()
            col = ds[expression]
            values = col[0:ds.row_count]
            import jax.numpy as jnp
            if isinstance(values, jnp.ndarray) and array_type != "jax":
                values = np.asarray(values)
            return _convert_array_type(values, array_type)
        if parallel and expression_is_device(df, expression) and df.length_unfiltered() > 0:
            task = TaskEvaluate(df, expression, pre_filter=use_filter)
            df.executor.schedule(task)
            df.executor.execute()
            values = task.get()
            dt = df.data_type(expression)
            if dt.is_datetime or dt.is_timedelta:
                values = values.view(dt.numpy) if not isinstance(values, np.ma.MaskedArray) else \
                    np.ma.MaskedArray(values.data.view(dt.numpy), values.mask)
        else:
            # host path (strings, datetimes, tiny frames)
            parts = []
            ds = df.dataset_for_execution()
            filter_expr = df._filter_expression() if use_filter else None
            _, columns, _ = classify_leaves(df, expression)
            if filter_expr:
                _, fcolumns, _ = classify_leaves(df, filter_expr)
                columns = columns | fcolumns
            from . import settings
            T = df._tile_rows or settings.TILE_ROWS
            for ci1, ci2, chunks in ds.chunk_iterator(sorted(columns), T):
                scope = HostScope(df, ci1, ci2, chunks)
                values = scope.evaluate_raw(expression)
                if np.isscalar(values):
                    values = np.full(ci2 - ci1, values)
                if filter_expr:
                    fmask_values = scope.evaluate_raw(filter_expr)
                    fdata, fmask = array_types.data_and_mask(fmask_values)
                    keep = fdata.astype(bool)
                    if fmask is not None:
                        keep &= ~fmask
                    values = array_types.take(values, np.flatnonzero(keep)) if (
                        pa is not None and isinstance(values, (pa.Array, pa.ChunkedArray))) else values[keep]
                parts.append(values)
            values = array_types.concat(parts) if parts else np.empty(0)
        return _convert_array_type(values, array_type)

    def evaluate_iterator(self, expression, s1=None, s2=None, chunk_size=None,
                          parallel=True, array_type=None, prefetch=True, progress=None):
        """Yield (i1, i2, chunk) (reference dataframe.py:2897)."""
        from . import settings
        chunk_size = chunk_size or self._tile_rows or settings.TILE_ROWS
        n = len(self)
        for i1 in range(0, max(n, 1), chunk_size):
            i2 = min(i1 + chunk_size, n)
            yield i1, i2, self.evaluate(expression, i1, i2, array_type=array_type, parallel=parallel)
            if n == 0:
                return

    # ---------------------------------------------------------- aggregation
    def execute(self):
        self.executor.execute()

    async def execute_async(self):
        self.execute()

    def _delay(self, delay, promise, progress=None):
        if delay:
            return promise
        from .progress import scoped_progress
        with scoped_progress(self.executor, progress):
            self.execute()
        return promise.get()

    def _create_binners(self, binby, limits, shape, delay=False):
        binby = _ensure_list(binby)
        shapes = shape if isinstance(shape, (list, tuple)) else [shape] * len(binby)
        from .ops.binners import BinnerOrdinal, BinnerScalar
        limits = self.limits(binby, limits, delay=False) if binby else []
        if len(binby) == 1 and limits is not None and len(limits) == 2 and np.isscalar(limits[0]):
            limits = [limits]
        binners = []
        for i, expr in enumerate(binby):
            expr = str(expr)
            if self.is_category(expr):
                N = self.category_count(expr)
                offset = self.category_offset(expr)
                binners.append(BinnerOrdinal(self._category_binby_expression(expr), offset, N))
            else:
                vmin, vmax = limits[i]
                binners.append(BinnerScalar(expr, vmin, vmax, shapes[i]))
        return tuple(binners)

    def _category_binby_expression(self, expr):
        meta = self._categories.get(str(expr))
        if meta is None:
            return str(expr)
        return str(expr)

    def _agg(self, descriptor, binners=(), delay=False, progress=None):
        [task] = descriptor.add_tasks(self, binners)
        return self._delay(delay, task) if not delay else task

    def _compute_agg(self, name, expression, binby=[], limits=None, shape=128,
                     selection=False, delay=False, edges=False, progress=None,
                     array_type=None, extra_expressions=None, **agg_kwargs):
        """The generic aggregation entry point (reference dataframe.py:741)."""
        selections = selection if isinstance(selection, (list, tuple)) else [selection]
        expressions = expression if isinstance(expression, (list, tuple)) else [expression]
        multi_expr = isinstance(expression, (list, tuple))
        binners = self._create_binners(binby, limits, shape)
        promises = []
        for expr in expressions:
            for sel in selections:
                sel_expr = self._selection_expression(sel)
                if name == "count" and (expr is None or str(expr) == "*"):
                    desc = agg_module.count("*", selection=sel_expr, edges=edges)
                elif name == "first":
                    desc = agg_module.first(str(expr), agg_kwargs.get("order_expression"),
                                            selection=sel_expr, edges=edges)
                elif name in ("std", "var"):
                    desc = agg_module.aggregates[name](str(expr), ddof=agg_kwargs.get("ddof", 0),
                                                       selection=sel_expr, edges=edges)
                else:
                    desc = agg_module.aggregates[name](str(expr), selection=sel_expr, edges=edges)
                [p] = desc.add_tasks(self, binners)
                promises.append(p)

        ndim = len(binners)

        @delayed
        def finish(*grids):
            results = []
            for grid in grids:
                grid = np.asarray(grid) if not isinstance(grid, np.ndarray) else grid
                if ndim and not edges:
                    grid = agg_module.extract_central(grid, ndim)
                if not ndim:
                    grid = grid.reshape(())[()] if grid.size == 1 else grid
                results.append(grid)
            out = results
            if len(selections) > 1 or isinstance(selection, (list, tuple)):
                k = len(selections)
                grouped = [np.stack(results[i:i + k]) if k > 1 else results[i]
                           for i in range(0, len(results), k)]
                out = grouped
            if multi_expr:
                return np.array(out) if ndim == 0 else np.stack([np.asarray(o) for o in out])
            return out[0]
        result = finish(*promises)
        return self._delay(delay, result, progress=progress)

    def count(self, expression=None, binby=[], limits=None, shape=128, selection=False,
              delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("count", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type)

    def sum(self, expression, binby=[], limits=None, shape=128, selection=False,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("sum", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type)

    def mean(self, expression, binby=[], limits=None, shape=128, selection=False,
             delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("mean", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type)

    def min(self, expression, binby=[], limits=None, shape=128, selection=False,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("min", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type)

    def max(self, expression, binby=[], limits=None, shape=128, selection=False,
            delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("max", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type)

    def std(self, expression, binby=[], limits=None, shape=128, selection=False,
            delay=False, edges=False, progress=None, array_type=None, ddof=0):
        return self._compute_agg("std", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type, ddof=ddof)

    def var(self, expression, binby=[], limits=None, shape=128, selection=False,
            delay=False, edges=False, progress=None, array_type=None, ddof=0):
        return self._compute_agg("var", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type, ddof=ddof)

    def first(self, expression, order_expression=None, binby=[], limits=None, shape=128,
              selection=False, delay=False, edges=False, progress=None, array_type=None):
        return self._compute_agg("first", expression, binby, limits, shape, selection,
                                 delay, edges, progress, array_type,
                                 order_expression=str(order_expression) if order_expression else None)

    def nunique(self, expression, dropna=False, dropnan=False, dropmissing=False,
                binby=[], limits=None, shape=128, selection=False, delay=False,
                edges=False, progress=None):
        binners = self._create_binners(binby, limits, shape)
        sel_expr = self._selection_expression(selection)
        desc = agg_module.nunique(str(expression), dropna=dropna, dropnan=dropnan,
                                  dropmissing=dropmissing, selection=sel_expr, edges=edges)
        [p] = desc.add_tasks(self, binners)
        ndim = len(binners)

        @delayed
        def finish(grid):
            grid = np.asarray(grid)
            if ndim and not edges:
                grid = agg_module.extract_central(grid.reshape([b.shape for b in binners]), ndim)
            if not ndim:
                grid = grid.reshape(())[()]
            return grid
        return self._delay(delay, finish(p))

    def minmax(self, expression, binby=[], limits=None, shape=128, selection=False,
               delay=False, progress=None):
        """(reference dataframe.py:1276)"""
        expressions = expression if isinstance(expression, (list, tuple)) else [expression]
        multi = isinstance(expression, (list, tuple))
        binners = self._create_binners(binby, limits, shape)
        sel_expr = self._selection_expression(selection)
        promises = []
        for expr in expressions:
            [pmin] = agg_module.min(str(expr), selection=sel_expr).add_tasks(self, binners)
            [pmax] = agg_module.max(str(expr), selection=sel_expr).add_tasks(self, binners)
            promises.extend([pmin, pmax])
        ndim = len(binners)

        @delayed
        def finish(*grids):
            out = []
            for i in range(0, len(grids), 2):
                gmin, gmax = np.asarray(grids[i]), np.asarray(grids[i + 1])
                if ndim:
                    gmin = agg_module.extract_central(gmin, ndim)
                    gmax = agg_module.extract_central(gmax, ndim)
                else:
                    gmin, gmax = gmin.reshape(())[()], gmax.reshape(())[()]
                out.append(np.stack([gmin, gmax], axis=-1) if ndim else np.array([gmin, gmax]))
            return np.stack(out) if multi else out[0]
        return self._delay(delay, finish(*promises))

    def limits(self, expression, value=None, square=False, selection=None, delay=False,
               shape=None, progress=None):
        """Resolve limits specs (reference dataframe.py:1617)."""
        if isinstance(expression, (list, tuple)):
            exprs = [str(e) for e in expression]
            if value is None or isinstance(value, str) or (isinstance(value, (list, tuple))
                                                           and len(value) == 2 and np.isscalar(value[0])):
                values = [value] * len(exprs)
            else:
                values = list(value)
            return [self.limits(e, v, selection=selection) for e, v in zip(exprs, values)]
        expression = str(expression)
        if value is None or (isinstance(value, str) and value == "minmax"):
            if self.is_category(expression):
                N = self.category_count(expression)
                offset = self.category_offset(expression)
                return [offset, offset + N]
            return [float(v) for v in self.minmax(expression, selection=selection or False)]
        if isinstance(value, str):
            return self.limits_percentage(expression, float(value.rstrip("%")), selection=selection)
        value = list(value)
        assert len(value) == 2
        return [float(v) if not isinstance(v, str) else v for v in value]

    def limits_percentage(self, expression, percentage=99.73, square=False, selection=False,
                          delay=False, progress=None):
        """Quantile limits via a 1024-bin count grid + interpolation
        (reference dataframe.py:1570-1614)."""
        vmin, vmax = self.minmax(expression, selection=selection)
        if vmin == vmax:
            return [vmin, vmax]
        shape = 1024
        counts = self.count(binby=[expression], limits=[[vmin, vmax]], shape=shape,
                            selection=selection)
        cumulative = np.cumsum(counts).astype(np.float64)
        total = cumulative[-1]
        if total == 0:
            return [vmin, vmax]
        cumulative /= total
        fraction = (100.0 - percentage) / 100.0 / 2
        edges_x = np.linspace(vmin, vmax, shape + 1)
        lo = np.interp(fraction, np.concatenate([[0], cumulative]), edges_x)
        hi = np.interp(1 - fraction, np.concatenate([[0], cumulative]), edges_x)
        return [float(lo), float(hi)]

    def percentile_approx(self, expression, percentage=50.0, binby=[], limits=None,
                          shape=128, percentile_shape=1024 * 16, percentile_limits="minmax",
                          selection=False, delay=False, progress=None):
        """Approximate percentile from a binned cumulative count grid
        (reference dataframe.py:1419-1524 via vaexfast grid_find_edges)."""
        expressions = expression if isinstance(expression, (list, tuple)) else [expression]
        multi = isinstance(expression, (list, tuple))
        out = []
        for expr in expressions:
            expr = str(expr)
            lim = self.limits(expr, percentile_limits, selection=selection)
            vmin, vmax = lim
            if vmin == vmax:
                out.append(vmin)
                continue
            percentages = percentage if isinstance(percentage, (list, tuple)) else [percentage]
            if binby:
                # percentile per binby cell: the expression gets a trailing
                # cumulative axis (reference dataframe.py:1419-1524 via
                # vaexfast.grid_find_edges + interpolation)
                binby_list = binby if isinstance(binby, (list, tuple)) else [binby]
                counts = self.count(binby=list(binby_list) + [expr],
                                    limits=self.limits(list(binby_list), limits) + [lim],
                                    shape=([shape] * len(binby_list)) + [percentile_shape],
                                    selection=selection)
                counts = np.asarray(counts, dtype=np.float64)
                cumulative = np.cumsum(counts, axis=-1)
                totals = cumulative[..., -1:]
                edges_x = np.linspace(vmin, vmax, percentile_shape + 1)
                cells = cumulative.reshape(-1, percentile_shape)
                cell_totals = totals.reshape(-1)
                values = np.full((len(percentages),) + cells.shape[:1], np.nan)
                for ci in range(cells.shape[0]):
                    if cell_totals[ci] == 0:
                        continue
                    cum = np.concatenate([[0], cells[ci]])
                    for pi, p in enumerate(percentages):
                        values[pi, ci] = np.interp(p / 100.0 * cell_totals[ci], cum, edges_x)
                grid_shape = counts.shape[:-1]
                values = values.reshape((len(percentages),) + grid_shape)
                out.append(values if isinstance(percentage, (list, tuple)) else values[0])
                continue
            counts = self.count(binby=[expr], limits=[lim], shape=percentile_shape,
                                selection=selection)
            cumulative = np.cumsum(counts).astype(np.float64)
            total = cumulative[-1]
            edges_x = np.linspace(vmin, vmax, percentile_shape + 1)
            values = [float(np.interp(p / 100.0 * total, np.concatenate([[0], cumulative]), edges_x))
                      for p in percentages]
            out.append(values if isinstance(percentage, (list, tuple)) else values[0])
        return out if multi else out[0]

    def median_approx(self, expression, percentage=50, binby=[], limits=None, shape=128,
                      percentile_shape=1024 * 16, percentile_limits="minmax",
                      selection=False, delay=False):
        return self.percentile_approx(expression, 50.0, binby=binby, limits=limits,
                                      shape=shape, percentile_shape=percentile_shape,
                                      percentile_limits=percentile_limits, selection=selection)

    def covar(self, x, y, binby=[], limits=None, shape=128, selection=False, delay=False,
              progress=None):
        """cov(x,y) = E[xy] - E[x]E[y] (reference dataframe.py:1067)."""
        x, y = str(x), str(y)
        mean_xy = self.mean(f"({x}) * ({y})", binby, limits, shape, selection, delay=True)
        mean_x = self.mean(x, binby, limits, shape, selection, delay=True)
        mean_y = self.mean(y, binby, limits, shape, selection, delay=True)

        @delayed
        def finish(mxy, mx, my):
            return np.asarray(mxy) - np.asarray(mx) * np.asarray(my)
        return self._delay(delay, finish(mean_xy, mean_x, mean_y))

    def correlation(self, x, y=None, binby=[], limits=None, shape=128, selection=False,
                    delay=False, progress=None):
        """Pearson correlation (reference dataframe.py:1121)."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of pairs")
            pairs = x
            return np.array([[self.correlation(str(a), str(b), binby, limits, shape, selection)
                              for b in pairs] for a in pairs])
        x, y = str(x), str(y)
        cov_p = self.covar(x, y, binby, limits, shape, selection, delay=True)
        std_x = self.std(x, binby, limits, shape, selection, delay=True)
        std_y = self.std(y, binby, limits, shape, selection, delay=True)

        @delayed
        def finish(cov, sx, sy):
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.asarray(cov) / (np.asarray(sx) * np.asarray(sy))
        return self._delay(delay, finish(cov_p, std_x, std_y))

    def cov(self, x, y=None, binby=[], limits=None, shape=128, selection=False, delay=False,
            progress=None):
        """Covariance matrix (reference dataframe.py:1192)."""
        if y is None:
            exprs = [str(e) for e in (x if isinstance(x, (list, tuple)) else [x])]
        else:
            exprs = [str(x), str(y)]
        n = len(exprs)
        means = [self.mean(e, binby, limits, shape, selection, delay=True) for e in exprs]
        cross = {}
        for i in range(n):
            for j in range(i, n):
                cross[(i, j)] = self.mean(f"({exprs[i]}) * ({exprs[j]})", binby, limits,
                                          shape, selection, delay=True)
        self.execute()
        mvals = [np.asarray(m.get()) for m in means]
        out_shape = np.shape(mvals[0])
        C = np.zeros(out_shape + (n, n))
        for i in range(n):
            for j in range(i, n):
                v = np.asarray(cross[(i, j)].get()) - mvals[i] * mvals[j]
                C[..., i, j] = v
                C[..., j, i] = v
        return C

    def healpix_count(self, expression=None, healpix_expression="source_id/34359738368",
                      healpix_max_level=12, healpix_level=8, binby=None, limits=None,
                      shape=128, **kwargs):
        """Healpix-binned counts (reference dataframe.py:1831): a count over
        the healpix ordinal derived from a nested index expression."""
        reduce_level = healpix_max_level - healpix_level
        nmax = 12 * 4 ** healpix_level
        scaling = 4 ** reduce_level
        epsilon = 1.0 / scaling / 2.0
        expr = f"((astype({healpix_expression}, 'int64')) / {scaling} + {epsilon})"
        return self.count(expression, binby=[expr] + list(binby or []),
                          limits=[[-0.5, nmax - 0.5]] + list(limits or []),
                          shape=[nmax] + list(shape if isinstance(shape, (list, tuple)) else []),
                          **kwargs)

    def mode(self, expression, binby=[], limits=None, shape=256, mode_shape=64,
             mode_limits=None, progressbar=False, selection=None):
        """Most frequent value via a binned count grid (reference dataframe.py:1777)."""
        expression = str(expression)
        lim = self.limits(expression, mode_limits, selection=selection)
        centers = np.linspace(lim[0], lim[1], mode_shape + 1)[:-1] + \
            (lim[1] - lim[0]) / mode_shape / 2
        if binby:
            binby_list = binby if isinstance(binby, (list, tuple)) else [binby]
            counts = self.count(binby=list(binby_list) + [expression],
                                limits=self.limits(list(binby_list), limits) + [lim],
                                shape=([shape] * len(binby_list)) + [mode_shape],
                                selection=selection or False)
            counts = np.asarray(counts)
            return centers[np.argmax(counts, axis=-1)]
        counts = self.count(binby=[expression], limits=[lim], shape=mode_shape,
                            selection=selection or False)
        return centers[np.argmax(counts)]

    def propagate_uncertainties(self, columns, depending_variables=None, cov_matrix="auto",
                                covariance_format="{}_{}_covariance",
                                uncertainty_format="{}_uncertainty"):
        """First-order error propagation via symbolic derivatives
        (reference dataframe.py:3418, using expresso.Derivative)."""
        from . import expresso
        from .scopes import classify_leaves
        columns = [self[str(c)] if not isinstance(c, Expression) else c for c in columns]
        if depending_variables is None:
            deps = set()
            for col in columns:
                _, cols_, _ = classify_leaves(self, col.expand().expression)
                deps |= cols_
            depending_variables = sorted(deps)
        depending_variables = [str(v) for v in depending_variables]
        for col in columns:
            expr = col.expand().expression
            terms = []
            for var in depending_variables:
                try:
                    d = expresso.derivative(expr, var)
                except ValueError:
                    continue
                if d.strip() == "0":
                    continue
                sigma = uncertainty_format.format(var)
                if sigma not in self:
                    continue
                terms.append(f"(({d}))**2 * ({sigma})**2")
            if terms:
                name = uncertainty_format.format(str(col))
                self.add_virtual_column(name, "sqrt(" + " + ".join(terms) + ")")
        return self

    def apply(self, f, arguments=None, vectorize=True, multiprocessing=False):
        """Row-wise python UDF over expressions (reference dataframe.py apply)."""
        arguments = [str(a) for a in (arguments or [])]
        name = self.add_function(getattr(f, "__name__", "lambda"), f,
                                 vectorize=vectorize, unique=True)
        return Expression(self, f"{name}({', '.join(arguments)})")

    def describe(self, strings=True, virtual=True, selection=None):
        """Summary table per column (reference dataframe.py describe)."""
        import pandas as pd
        names = self.get_column_names(strings=strings, virtual=virtual)
        rows = {"data_type": [], "count": [], "NA": [], "mean": [], "std": [],
                "min": [], "max": []}
        N = len(self)
        numeric = []
        for name in names:
            dt = DataType(self.data_type(name))
            rows["data_type"].append(dt.name)
            if dt.is_primitive and not dt.is_bool or dt.is_datetime:
                numeric.append(name)
        counts = {name: self.count(name, selection=selection or False, delay=True) for name in names}
        means = {name: self.mean(name, selection=selection or False, delay=True)
                 for name in numeric if not DataType(self.data_type(name)).is_datetime}
        stds = {name: self.std(name, selection=selection or False, delay=True)
                for name in numeric if not DataType(self.data_type(name)).is_datetime}
        minmaxes = {name: self.minmax(name, selection=selection or False, delay=True)
                    for name in numeric}
        self.execute()
        for name in names:
            count = int(np.asarray(counts[name].get()))
            rows["count"].append(count)
            rows["NA"].append(N - count)
            if name in minmaxes:
                mm = np.asarray(minmaxes[name].get())
                rows["min"].append(mm[0])
                rows["max"].append(mm[1])
            else:
                rows["min"].append("--")
                rows["max"].append("--")
            rows["mean"].append(float(np.asarray(means[name].get())) if name in means else "--")
            rows["std"].append(float(np.asarray(stds[name].get())) if name in stds else "--")
        return pd.DataFrame(rows, index=names).T

    def mutual_information(self, x, y=None, dimension=2, mi_limits=None, mi_shape=256,
                           binby=[], limits=None, shape=128, sort=False, selection=False,
                           delay=False):
        """Mutual information between pairs (reference dataframe.py:622 + kld.py)."""
        if y is None:
            if not isinstance(x, (list, tuple)):
                raise ValueError("provide y or a list of pairs")
            if all(isinstance(e, (list, tuple)) for e in x):
                pairs = [(str(a), str(b)) for a, b in x]
                out = np.array([self.mutual_information(a, b, mi_limits=mi_limits,
                                                        mi_shape=mi_shape, selection=selection)
                                for a, b in pairs])
                if sort:
                    order = np.argsort(out)[::-1]
                    return out[order], [pairs[i] for i in order]
                return out
            exprs = [str(e) for e in x]
            return np.array([[self.mutual_information(a, b, mi_limits=mi_limits,
                                                      mi_shape=mi_shape, selection=selection)
                              for b in exprs] for a in exprs])
        x, y = str(x), str(y)
        lim = self.limits([x, y], mi_limits, selection=selection)
        counts = np.asarray(self.count(binby=[x, y], limits=lim, shape=mi_shape,
                                       selection=selection))
        pxy = counts / counts.sum()
        px = pxy.sum(axis=1, keepdims=True)
        py = pxy.sum(axis=0, keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            terms = pxy * np.log(pxy / (px * py))
        return float(np.nansum(terms))

    # -------------------------------------------------------------- set ops
    def _int_value_bound(self, expression, compute=True, delay=False):
        """(lo, hi) of an integer expression from a memoized minmax pass.

        Used to shrink exact-sum limb channel counts (kernel/sort cost is
        linear in channels).  ``delay=True`` queues the minmax as a delayed
        task (descriptor ``prepare`` phase — all pre-passes fuse into one);
        ``compute=False`` only reads the memo / an already-resolved promise,
        never triggering a pass (safe mid-task-queueing)."""
        from .delayed import Promise
        expression = str(expression)

        def _pair(mm):
            lo, hi = np.asarray(mm)
            if np.asarray(lo).dtype.kind == "f":
                return (float(lo), float(hi))  # float bounds stay floats
            return (int(lo), int(hi))

        memo = getattr(self.executor, "_minmax_memo", None)
        if memo is None:
            memo = self.executor._minmax_memo = {}
        key = (self.fingerprint(), expression)
        val = memo.get(key)
        if isinstance(val, Promise) or hasattr(val, "then"):
            if getattr(val, "done", False) and val.exception is None:
                memo[key] = val = _pair(val.get())
            elif not compute:
                return None
        if key in memo and isinstance(memo[key], (tuple, type(None))):
            return memo[key]
        if delay:
            memo[key] = self.minmax(expression, delay=True)
            return None
        if not compute:
            return None
        try:
            memo[key] = _pair(self.minmax(expression))
        except Exception:
            memo[key] = None
        return memo[key]

    def _set(self, expression, keep_counts=False, limit=None, limit_raise=True,
             expected_cardinality=None):
        """Build a SortedSet over an expression (reference dataframe.py:474).

        Device-evaluable keys build on the accelerator (per-tile static-size
        unique, tiny host merges).  One 64Ki-cap attempt doubles as the
        cardinality probe; on overflow the build jumps straight to the global
        device sort (one sort of all keys, boundary compaction) — the ladder's
        middle rungs only ever paid per-tile sort cost twice.  Callers that
        already know the key is high-cardinality (GrouperCombined's fused
        keys) pass ``expected_cardinality`` to skip the probe entirely.
        """
        expression = str(expression)
        from . import settings
        from .tasks import SetCapOverflow, TaskSetCreateDevice
        if expression_is_device(self, expression):
            tile_cap = self._tile_rows or settings.TILE_ROWS
            hints = getattr(self.executor, "_set_cap_hints", None)
            if hints is None:
                hints = self.executor._set_cap_hints = {}
            hint_key = expression
            ladder = [c for c in (65536, 1 << 20)
                      if c < tile_cap and c >= hints.get(hint_key, 0)]
            if expected_cardinality is not None:
                ladder = [c for c in ladder if expected_cardinality < c]
            for cap in ladder:
                task = TaskSetCreateDevice(self, expression, keep_counts=keep_counts,
                                           limit=limit if limit_raise else None,
                                           pre_filter=self.filtered, cap=cap)
                self.executor.schedule(task)
                try:
                    self.executor.execute()
                    hints[hint_key] = cap
                    return task.get()
                except SetCapOverflow:
                    hints[hint_key] = cap * 2  # skip this rung next time
                    break  # go straight to the global device sort
            # cardinality comparable to the row count: global device sort
            oset = self._set_device_global(expression, keep_counts=keep_counts,
                                           limit=limit if limit_raise else None)
            if oset is not None:
                return oset
        task = TaskSetCreate(self, expression, keep_counts=keep_counts,
                             limit=limit if limit_raise else None,
                             pre_filter=self.filtered)
        self.executor.schedule(task)
        self.executor.execute()
        return task.get()

    def _set_device_global(self, expression, keep_counts=False, limit=None):
        """Set build for near-unique keys: one global device sort, boundary
        flags, compaction — no per-tile caps (the reference's analogue would
        be a hashmap approaching the row count, hash_primitives.hpp)."""
        import jax.numpy as jnp
        from .ops.setops import RowLimitException, SortedSet
        raw = self._evaluate_device_whole(expression)
        if raw is None:
            try:
                raw = self.evaluate(expression)
            except Exception:
                return None  # fall back to the host path
        if isinstance(raw, np.ma.MaskedArray):
            return None  # nullable keys keep the host path (null slot logic)
        data = raw if isinstance(raw, jnp.ndarray) else jnp.asarray(np.asarray(raw))
        if data.shape[0] == 0:
            return SortedSet(np.dtype(data.dtype), keep_counts=keep_counts, limit=limit)
        fdata = data
        nan_count = 0
        if jnp.issubdtype(fdata.dtype, jnp.floating):
            if int(jnp.sum(jnp.isinf(fdata))):
                return None  # inf keys would collide with the NaN substitute
            nan_count = int(jnp.sum(jnp.isnan(fdata)))
            fdata = jnp.where(jnp.isnan(fdata), jnp.inf, fdata)

        s, n_total = _sort_and_count_unique(fdata)
        n_total = int(n_total)  # unique values incl. the NaN->inf slot
        n_uniq = n_total - (1 if nan_count else 0)
        if limit is not None and n_total > limit:
            raise RowLimitException(
                f"set grew to {n_total} unique values, which exceeds the limit of {limit}")

        uniq, counts = _compact_sorted(s, n_total, keep_counts)
        oset = SortedSet(np.dtype(data.dtype), keep_counts=keep_counts, limit=limit)
        if keep_counts:
            counts_np = np.asarray(counts).astype(np.int64)
            if nan_count:  # the NaN->inf slot sits last; its count is nan_count
                counts_np = counts_np[:n_uniq]
            oset.counts = counts_np
        oset.nan_count = nan_count
        # keys stay on the device (probes in later passes reuse them, and a
        # D2H of 1e7 keys is not free); the host copy is lazy
        oset._device_keys = uniq[:n_uniq] if n_uniq != n_total else uniq
        oset._keys = None
        oset._n_keys_device = n_uniq
        # cheap device fingerprint: head/tail samples + counts (a full-key
        # hash would force the D2H copy this laziness exists to avoid)
        head = np.asarray(uniq[:256])
        tail = np.asarray(uniq[max(n_uniq - 256, 0):n_uniq])
        oset._fingerprint = fingerprint(
            "sorted-set-device", head.tobytes(), tail.tobytes(), n_uniq,
            nan_count, str(data.dtype))
        return oset

    def _evaluate_device_whole(self, expression):
        """Evaluate a device expression over whole device-resident columns in
        one shot (no tiling, no host round trip).  Returns a jnp array, or
        None when the frame/expression doesn't qualify (filtered frames,
        host-stage functions, masked or host-resident columns)."""
        import jax.numpy as jnp
        from .ops.setops import DeviceSetHandle, SortedSet
        from .ops.nullable import NA
        from .scopes import DeviceScope
        if self.filtered or not expression_is_device(self, str(expression)):
            return None
        ds = self.dataset_for_execution()
        n = ds.row_count
        if n == 0:
            return None
        _, columns, variables = classify_leaves(self, str(expression))
        na_tile = {}
        for name in columns:
            if name not in ds:
                return None
            col = ds[name][0:n]
            if not isinstance(col, jnp.ndarray):
                return None  # host-resident column: use the tiled pass
            na_tile[name] = NA(col, None)
        aux_sets = {}
        for v in variables:
            val = self.variables.get(v)
            if isinstance(val, SortedSet):
                keys = val._device_keys
                if keys is None:
                    if val.is_string:
                        return None
                    keys = jnp.asarray(val.keys)
                    val._device_keys = keys
                aux_sets[v] = DeviceSetHandle(keys, val.n_keys, val.has_nan,
                                              val.has_null, host_set=val)
        scope = DeviceScope(self, na_tile, aux_sets)
        value = scope.evaluate(str(expression))
        if value.mask is not None:
            data = np.asarray(value.data)
            mask = np.asarray(value.mask)
            return np.ma.MaskedArray(data, mask) if mask.any() else value.data
        return value.data

    def unique(self, expression, return_inverse=False, dropna=False, dropnan=False,
               dropmissing=False, progress=None, selection=None, axis=None,
               delay=False, limit=None, limit_raise=True, array_type="list"):
        """(reference dataframe.py / expression.py:1064)"""
        expression = str(expression)
        df = self
        sel_expr = self._selection_expression(selection) if selection is not None else None
        if sel_expr:
            df = df.filter(sel_expr)
        oset = df._set(expression, limit=limit, limit_raise=limit_raise)
        keys = oset.key_array(masked=True)
        parts = [keys[:oset.n_keys]]
        n = oset.n_keys
        keep_nan = oset.has_nan and not (dropna or dropnan)
        keep_null = oset.has_null and not (dropna or dropmissing)
        values = keys
        take = list(range(oset.n_keys))
        if oset.has_nan and keep_nan:
            take.append(oset.nan_ordinal)
        if oset.has_null and keep_null:
            take.append(oset.null_ordinal)
        values = keys[take] if len(take) != len(keys) else keys
        if return_inverse:
            inverse = self.evaluate_ordinal(expression, oset)
            return _to_array_type(values, array_type), inverse
        return _to_array_type(values, array_type)

    def evaluate_ordinal(self, expression, oset):
        var = self.add_variable("set_inverse", oset, unique=True)
        return self.evaluate(f"_ordinal_values({expression}, {var})", array_type="numpy")

    def isin(self, values, column_names=None):
        column_names = column_names or self.get_column_names()
        exprs = [self[name].isin(values) for name in column_names]
        expr = exprs[0]
        for e in exprs[1:]:
            expr = expr | e
        return expr

    # --------------------------------------------------------- map reduce
    def map_reduce(self, map_fn, reduce_fn, expressions, delay=False, name="map reduce",
                   info=False, to_numpy=True, ignore_filter=False, pre_filter=False,
                   selection=None):
        task = TaskMapReduce(self, [str(e) for e in expressions], map_fn, reduce_fn,
                             name=name, pre_filter=pre_filter and self.filtered, info=info)
        self.executor.schedule(task)
        return self._delay(delay, task)

    def _index(self, expression, progress=None, delay=False):
        """Build a SortedIndex for joins (reference dataframe.py:482-539)."""
        from .ops.setops import SortedIndex
        expression = str(expression)
        values = self.evaluate(expression)
        data, mask = array_types.data_and_mask(values)
        return SortedIndex(data, mask)

    # ------------------------------------------------------ structure ops
    def __getitem__(self, item):
        if isinstance(item, str):
            if item in self.dataset or item in self.virtual_columns or item in self.variables:
                return Expression(self, item)
            # maybe it's an expression
            return Expression(self, item)
        if isinstance(item, Expression):
            return self.filter(item.expression)
        if isinstance(item, (list, tuple)):
            names = [str(c) for c in item]
            df = self.copy(column_names=names)
            return df
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            assert step in (1, None)
            if self.filtered:
                mask = self._get_filter_mask()
                from . import hostkern
                raw = hostkern.mask_indices(mask)[start:stop]
                df = self._rebind_dataset(self.dataset_for_execution().take(raw), keep_filter=False)
                df.selections.pop(FILTER_SELECTION_NAME, None)
                return df
            df = self.copy()
            df.set_active_range(self._index_start + start, self._index_start + stop)
            return df.trim()
        raise TypeError(f"cannot index with {item!r}")

    def __setitem__(self, name, value):
        if isinstance(value, Expression):
            self.add_virtual_column(name, value.expression)
        elif isinstance(value, supported_array_like()):
            self.add_column(name, value)
        else:
            self.add_virtual_column(name, str(value))

    def __delitem__(self, name):
        self.drop(str(name), inplace=True)

    def take(self, indices, filtered=True, dropfilter=True):
        """(reference dataframe.py:4176)"""
        df = self.extract() if (self.filtered and filtered) else self.trim()
        ds = df.dataset.take(np.asarray(indices))
        return df._rebind_dataset(ds)

    def head(self, n=10):
        return self[:min(n, len(self))]

    def tail(self, n=10):
        N = len(self)
        return self[max(0, N - n):N]

    def sort(self, by, ascending=True, kind="quicksort"):
        """Materialize the sort key(s), argsort, take
        (reference dataframe.py:4420-4461).  Device-side radix/argsort via
        jnp.argsort replaces np.argsort for numeric keys."""
        by = _ensure_list(by)
        ascending_list = ascending if isinstance(ascending, (list, tuple)) else [ascending] * len(by)
        df = self.extract() if self.filtered else self.trim()
        keys = []
        for b, asc in zip(by, ascending_list):
            values = df.evaluate(str(b), array_type="numpy")
            data, mask = array_types.data_and_mask(values)
            if data.dtype == object:
                data = np.asarray([("" if v is None else str(v)) for v in data])
            if not asc:
                if data.dtype.kind in "OUS":
                    keys.append(("desc_str", data, mask))
                    continue
                data = -data.astype(np.float64) if data.dtype.kind == "b" else _negate_for_sort(data)
            keys.append((None, data, mask))
        if len(keys) == 1:
            tag, data, mask = keys[0]
            if tag == "desc_str":
                indices = np.argsort(data, kind="stable")[::-1]
            else:
                indices = np.argsort(data, kind="stable")
        else:
            cols = []
            for tag, data, mask in reversed(keys):
                cols.append(data)
            indices = np.lexsort(cols)
        return df.take(indices)

    def shuffle(self, random_state=None):
        rng = np.random.default_rng(random_state)
        indices = rng.permutation(len(self))
        return self.take(indices)

    def sample(self, n=None, frac=None, replace=False, weights=None, random_state=None):
        """(reference dataframe.py:4248)"""
        N = len(self)
        if n is None:
            n = int(round((frac if frac is not None else 1.0) * N))
        rng = np.random.default_rng(random_state)
        p = None
        if weights is not None:
            w = array_types.to_numpy(self.evaluate(str(weights)))
            w = np.asarray(w, np.float64)
            p = w / w.sum()
        indices = rng.choice(N, n, replace=replace, p=p)
        return self.take(indices)

    def split(self, into=None):
        """Split into consecutive sub-frames (reference dataframe.py:4352)."""
        N = len(self)
        if isinstance(into, (int, np.integer)):
            sizes = [N // into + (1 if i < N % into else 0) for i in range(into)]
        else:
            fracs = list(into)
            sizes = [int(round(f * N)) for f in fracs]
            sizes[-1] = N - sum(sizes[:-1])
        dfs = []
        offset = 0
        for size in sizes:
            dfs.append(self[offset:offset + size])
            offset += size
        return dfs

    def split_random(self, into=None, random_state=None):
        df = self.shuffle(random_state=random_state)
        return df.split(into)

    def concat(self, *others, resolver="flexible"):
        """(reference dataframe.py:5881)"""
        dfs = [self] + list(others)
        dfs = [df.extract() for df in dfs]
        datasets = [df.dataset for df in dfs]
        ds = datasets[0].concat(*datasets[1:])
        out = dfs[0]._rebind_dataset(ds)
        out.column_names = [n for n in out.column_names if n in ds or n in out.virtual_columns]
        return out

    def dropna(self, column_names=None, how="any"):
        """(reference dataframe.py:4750)"""
        return self._drop_x(column_names, "notna")

    def dropmissing(self, column_names=None):
        return self._drop_x(column_names, lambda c: f"~ismissing({c})")

    def dropnan(self, column_names=None):
        return self._drop_x(column_names, lambda c: f"~isnan({c})")

    def dropinf(self, column_names=None):
        return self._drop_x(column_names, lambda c: f"~isinf(fillnan(astype({c}, 'float64'), 0.0))"
                            if False else f"~isinf({c})")

    def _drop_x(self, column_names, maker):
        names = column_names or self.get_column_names()
        parts = []
        for name in names:
            dt = DataType(self.data_type(name))
            if isinstance(maker, str):
                parts.append(f"{maker}({name})")
            else:
                expr = maker(name)
                if "isnan" in expr and not dt.is_float:
                    continue
                if "isinf" in expr and not dt.is_float:
                    continue
                parts.append(expr)
        if not parts:
            return self.copy()
        return self.filter(" & ".join(f"({p})" for p in parts))

    def fillna(self, value, column_names=None, prefix="__original_", inplace=False):
        """Virtual-column fills (reference dataframe.py:4595)."""
        df = self if inplace else self.copy()
        names = column_names or df.get_column_names()
        for name in names:
            dt = DataType(df.data_type(name))
            if dt.is_string:
                continue
            df[name] = df[f"fillna({name}, {value!r})" if not isinstance(value, str) else
                          f"fillna({name}, {value!r})"]
        return df

    def to_device(self, column_names=None):
        """Stage columns into device HBM (device-resident table).

        The executor skips host->device transfer for jnp-backed columns, so
        repeated queries run at kernel speed — the device analogue of the
        reference's in-RAM mmap'd columns.  String columns are
        dictionary-encoded ONCE (the SURVEY §7.1 design: codes ride on
        device as int32, labels stay host-side): the column becomes a
        category, so string groupbys bin directly on device codes, while
        string kernels keep working against the original host column.

        Under a distributed executor (``parallel.distributed_executor``)
        columns whose length divides by the device count are placed with
        their rows split over the mesh, each device holding only its own
        shard, which is the layout its passes read.
        """
        import jax
        import jax.numpy as jnp
        names = column_names or self.get_column_names(virtual=False, hidden=True)
        place = jnp.asarray
        mesh = getattr(self.executor, "mesh", None)
        if (mesh is not None and mesh.size > 1
                and self.dataset.row_count % mesh.size == 0):
            from jax.sharding import NamedSharding, PartitionSpec as P
            rows = NamedSharding(mesh, P(mesh.axis_names[0]))

            def place(values):
                return jax.device_put(values, rows)
        columns = {}
        df_meta = self.copy()
        for name in names:
            if name not in self.dataset:
                continue
            col = self.dataset[name]
            raw = col[:] if hasattr(col, "__getitem__") else col
            dt = DataType(dtype_of(col))
            if dt.is_string or dt.is_encoded:
                import pyarrow as pa
                import pyarrow.compute as pc
                arr = array_types.to_arrow(raw)
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.combine_chunks()
                if pa.types.is_dictionary(arr.type):
                    encoded = arr  # already encoded: no O(N)-string re-pass
                else:
                    encoded = pc.dictionary_encode(arr)
                if isinstance(encoded, pa.ChunkedArray):
                    encoded = encoded.combine_chunks()
                labels = encoded.dictionary.to_pylist()
                codes = np.asarray(encoded.indices.fill_null(len(labels))).astype(np.int32)
                has_null = encoded.indices.null_count > 0
                if has_null:
                    labels = labels + [None]
                codes_name = f"__{name}_codes"
                columns[codes_name] = place(codes)
                # the DICTIONARY array becomes the host column: str_* kernels
                # detect it and run per-VALUE at O(U) instead of O(N)
                # (functions._dict_aware), while reads decode transparently
                columns[name] = encoded
                df_meta._categories[name] = {"labels": labels, "N": len(labels),
                                             "min_value": 0, "codes_column": codes_name}
                if codes_name not in df_meta.column_names:
                    df_meta.column_names.append(codes_name)
                continue
            values = array_types.to_numpy(raw)
            if isinstance(values, np.ma.MaskedArray) or (
                    isinstance(values, np.ndarray) and values.dtype.kind in "OUSMm"):
                columns[name] = col  # keep host-side
            elif isinstance(values, np.ndarray):
                columns[name] = place(values)
            else:
                columns[name] = col
        df = df_meta._rebind_dataset(DatasetArrays(columns), keep_filter=True)
        df.column_names = [n for n in df_meta.column_names if n in columns or
                           n in df_meta.virtual_columns]
        return df

    def materialize(self, column=None, inplace=False):
        """Evaluate virtual columns into real arrays (reference dataframe.py:4633)."""
        df = self if inplace else self.copy()
        names = [str(column)] if column is not None else list(df.virtual_columns)
        for name in names:
            values = df.evaluate(name, filtered=False)
            del df.virtual_columns[name]
            df.add_column(name, values if not isinstance(values, np.ndarray) else values)
        return df

    # ------------------------------------------------------------ shift ops
    def shift(self, periods, column=None, fill_value=None, trim=False, inplace=False):
        from .shift import shift as _shift
        return _shift(self, periods, column=column, fill_value=fill_value, trim=trim,
                      inplace=inplace)

    def diff(self, periods=1, column=None, fill_value=None, trim=False, inplace=False,
             reverse=False):
        from .shift import diff as _diff
        return _diff(self, periods=periods, column=column, fill_value=fill_value,
                     trim=trim, inplace=inplace, reverse=reverse)

    def rolling(self, window, trim=False, column=None, fill_value=None, edge="right"):
        from .shift import Rolling
        columns = [column] if isinstance(column, str) else column
        return Rolling(self, window, trim=trim, fill_value=fill_value, edge=edge,
                       columns=columns)

    # ------------------------------------------------------------- groupby
    def groupby(self, by=None, agg=None, sort=False, ascending=True, assume_sparse="auto",
                row_limit=None, copy=True, progress=None, delay=False):
        if agg is not None:
            # one-shot groupby(by, agg=...): the fused one-sort plan replaces
            # set-build + probe + aggregation sort when the shape qualifies
            from .fused_groupby import try_fused_sort_groupby
            routed = try_fused_sort_groupby(self, by, agg, sort=sort,
                                            ascending=ascending,
                                            row_limit=row_limit, delay=delay)
            if routed is not None:
                return routed
        from .groupby import GroupBy
        gb = GroupBy(self, by=by, sort=sort, ascending=ascending, combine=assume_sparse,
                     row_limit=row_limit, copy=copy)
        if agg is None:
            return gb
        return gb.agg(agg, delay=delay)

    def binby(self, by=None, agg=None, limits=None, shape=128, sort=False, delay=False,
              progress=None):
        from .groupby import BinBy
        bb = BinBy(self, by=by, limits=limits, shape=shape, sort=sort)
        if agg is None:
            return bb
        return bb.agg(agg)

    def join(self, other, on=None, left_on=None, right_on=None, lprefix="", rprefix="",
             lsuffix="", rsuffix="", how="left", allow_duplication=False, inplace=False,
             mesh=None):
        from .join import join
        if mesh is None and getattr(self.executor, "mesh", None) is not None:
            mesh = self.executor.mesh  # distributed executor: shuffle join
        return join(self, other, on=on, left_on=left_on, right_on=right_on,
                    lprefix=lprefix, rprefix=rprefix, lsuffix=lsuffix, rsuffix=rsuffix,
                    how=how, allow_duplication=allow_duplication, mesh=mesh)

    # ------------------------------------------------------------- exports
    def to_pandas_df(self, column_names=None, selection=None, strings=True, virtual=True,
                     index_name=None, parallel=True, chunk_size=None, array_type=None):
        import pandas as pd
        names = column_names or self.get_column_names(strings=strings, virtual=virtual)
        data = {}
        for name in names:
            values = self.evaluate(name, selection=selection, parallel=parallel)
            values = array_types.to_numpy(values)
            if isinstance(values, np.ma.MaskedArray):
                if values.dtype.kind in "iu":
                    values = values.astype(np.float64).filled(np.nan)
                elif values.dtype == object:
                    values = np.asarray([None if m else v for v, m in
                                         zip(values.data, np.ma.getmaskarray(values))], dtype=object)
                else:
                    values = values.filled(np.nan)
            data[name] = values
        return pd.DataFrame(data)

    def to_arrow_table(self, column_names=None, selection=None, strings=True, virtual=True,
                       parallel=True, chunk_size=None, reduce_large=False):
        names = column_names or self.get_column_names(strings=strings, virtual=virtual)
        arrays = [array_types.to_arrow(self.evaluate(name, selection=selection, parallel=parallel))
                  for name in names]
        return pa.table(dict(zip(names, arrays)))

    def to_arrays(self, column_names=None, selection=None, strings=True, virtual=True,
                  parallel=True, chunk_size=None, array_type=None):
        names = column_names or self.get_column_names(strings=strings, virtual=virtual)
        return [self.evaluate(name, selection=selection, parallel=parallel, array_type=array_type)
                for name in names]

    def to_dict(self, column_names=None, selection=None, strings=True, virtual=True,
                parallel=True, chunk_size=None, array_type=None):
        names = column_names or self.get_column_names(strings=strings, virtual=virtual)
        return dict(zip(names, self.to_arrays(names, selection, strings, virtual, parallel,
                                              chunk_size, array_type)))

    def to_items(self, column_names=None, selection=None, strings=True, virtual=True,
                 parallel=True, chunk_size=None, array_type=None):
        return list(self.to_dict(column_names, selection, strings, virtual, parallel,
                                 chunk_size, array_type).items())

    def to_records(self, index=None, selection=None):
        names = self.get_column_names()
        arrays = self.to_arrays(names, selection=selection, array_type="python")
        if index is not None:
            return [dict(zip(names, row)) for row in zip(*arrays)][index]
        return [dict(zip(names, row)) for row in zip(*arrays)]

    # ------------------------------------------------------------- export
    def export(self, path, progress=None, chunk_size=None, parallel=True, fs_options=None, fs=None):
        from .io import export as export_module
        export_module.export(self, path, progress=progress, chunk_size=chunk_size)

    def export_hdf5(self, path, progress=None, chunk_size=None, parallel=True, mode="w"):
        from .io import hdf5
        hdf5.export_hdf5(self, path, progress=progress, chunk_size=chunk_size)

    def export_parquet(self, path, progress=None, chunk_size=None, parallel=True, fs_options=None, fs=None):
        from .io import arrow as arrow_io
        arrow_io.export_parquet(self, path, chunk_size=chunk_size)

    def export_arrow(self, path, progress=None, chunk_size=None, parallel=True,
                     reduce_large=False, fs_options=None, fs=None):
        from .io import arrow as arrow_io
        arrow_io.export_arrow(self, path, chunk_size=chunk_size)

    def export_feather(self, path, parallel=True, reduce_large=False, compression="lz4"):
        from .io import arrow as arrow_io
        arrow_io.export_feather(self, path, compression=compression)

    def export_csv(self, path, progress=None, chunk_size=None, parallel=True, **kwargs):
        from .io import export as export_module
        export_module.export_csv(self, path, chunk_size=chunk_size, **kwargs)

    def export_votable(self, path, progress=None):
        from .io import votable
        votable.export_votable(self, path)

    def export_fits(self, path, progress=None):
        from .io import fits
        fits.export_fits(self, path)

    def export_many(self, path, chunk_size=None, max_rows_per_file=None, progress=None):
        """Export into multiple files; path must contain a {i} or {i:0Nd}
        format slot (reference dataframe.py:6478 export_many)."""
        n = len(self)
        per_file = max_rows_per_file or chunk_size or max(1, -(-n // 8))
        paths = []
        i = 0
        offset = 0
        while offset < n or (n == 0 and i == 0):
            sub = self[offset:min(offset + per_file, n)]
            out = path.format(i=i)
            sub.export(out)
            paths.append(out)
            offset += per_file
            i += 1
        return paths

    def export_partitioned(self, path, by, directory_format="{key}={value}", progress=None):
        """Hive-style partitioned export (reference dataframe.py:6426)."""
        import os
        by = [str(b) for b in (by if isinstance(by, (list, tuple)) else [by])]
        assert len(by) == 1, "single partition key in this round"
        key = by[0]
        values = self.unique(key, array_type="list")
        paths = []
        for value in values:
            if value is None:
                continue
            sub = self.filter(f"({key} == {value!r})")
            d = os.path.join(os.path.dirname(path) or ".",
                             directory_format.format(key=key, value=value))
            os.makedirs(d, exist_ok=True)
            out = os.path.join(d, os.path.basename(path))
            sub.export(out)
            paths.append(out)
        return paths

    # ------------------------------------------------------------- state
    def state_get(self, skip=None):
        from .encoding import state_get
        return state_get(self, skip=skip)

    def state_set(self, state, use_active_range=False, keep_columns=None, set_filter=True,
                  trusted=True, warn=True):
        from .encoding import state_set
        state_set(self, state, set_filter=set_filter, trusted=trusted)
        return self

    def state_write(self, file, fs_options=None, fs=None):
        import json
        with open(file, "w") as f:
            json.dump(_jsonify(self.state_get()), f)

    def state_load(self, file, use_active_range=False, keep_columns=None, set_filter=True,
                   trusted=True, fs_options=None, fs=None):
        import json
        with open(file) as f:
            state = json.load(f)
        return self.state_set(state, set_filter=set_filter)

    # ------------------------------------------------------------- pickling
    def __reduce__(self):
        """Pickle = (columns as host arrays) + the pure-metadata state
        (reference: dataframe pickling via dataset registry + state)."""
        columns = {}
        for name in self.dataset:
            col = self.dataset[name]
            values = col[0:self.dataset.row_count] if hasattr(col, "__getitem__") else col
            values = array_types.to_numpy(values) if not isinstance(
                values, (np.ndarray, np.ma.MaskedArray)) else values
            columns[name] = values
        return (_unpickle_dataframe, (columns, self.state_get()))

    @property
    def dtypes(self):
        import pandas as pd
        names = self.get_column_names()
        return pd.Series({n: self.data_type(n).name for n in names})

    @property
    def shape(self):
        return (len(self), len(self.get_column_names()))

    def byte_size(self, selection=False, virtual=False):
        total = 0
        for name in self.get_column_names(virtual=virtual):
            dt = DataType(self.data_type(name))
            if dt.is_string:
                continue
            total += dt.numpy.itemsize * len(self)
        return total

    def close(self):
        self.dataset.close()

    # ------------------------------------------------------------- dunder
    def __repr__(self):
        from .formatting import format_dataframe
        return format_dataframe(self)

    def _repr_html_(self):
        return "<pre>" + self.__repr__() + "</pre>"

    def __iter__(self):
        return iter(self.get_column_names())

    @property
    def col(self):
        """Column namespace accessor (reference: df.col.x)."""
        class Cols:
            def __init__(self, df):
                self.df = df

            def __getattr__(self, name):
                return self.df[name]
        return Cols(self)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            columns = object.__getattribute__(self, "column_names")
        except AttributeError:
            raise AttributeError(name)
        if name in columns or name in object.__getattribute__(self, "virtual_columns"):
            return Expression(self, name)
        if name in _df_accessors:
            acc = _df_accessors[name](self)
            object.__setattr__(self, name, acc)
            return acc
        raise AttributeError(name)


def _unpickle_dataframe(columns, state):
    from . import from_arrays
    df = from_arrays(**columns)
    df.state_set(state)
    return df


_df_accessors = {}


def register_dataframe_accessor(name, cls=None):
    """(reference vaex/__init__.py:663)"""
    def wrapper(cls):
        _df_accessors[name] = cls
        return cls
    return wrapper(cls) if cls is not None else wrapper


def supported_array_like():
    types = [np.ndarray, list, tuple]
    if pa is not None:
        types += [pa.Array, pa.ChunkedArray]
    from .column import Column
    types.append(Column)
    return tuple(types)


def _ensure_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [str(e) for e in x]
    return [str(x)]


def _negate_for_sort(data):
    if data.dtype.kind == "f":
        return -data
    if data.dtype.kind in "iu":
        return -data.astype(np.int64)
    return -data


def _to_array_type(values, array_type):
    if array_type in ("list", "python"):
        if isinstance(values, np.ma.MaskedArray):
            return values.tolist(None)
        return list(values) if values.dtype == object else values.tolist()
    if array_type == "numpy":
        return values
    if array_type == "arrow":
        return array_types.to_arrow(values)
    return values


def _convert_array_type(values, array_type):
    if array_type == "numpy":
        return array_types.to_numpy(values)
    if array_type == "arrow":
        return array_types.to_arrow(values)
    if array_type == "jax":
        import jax.numpy as jnp
        return values if isinstance(values, jnp.ndarray) else jnp.asarray(
            array_types.to_numpy(values))
    if array_type in ("list", "python"):
        values = array_types.to_numpy(values)
        return values.tolist(None) if isinstance(values, np.ma.MaskedArray) else values.tolist()
    return values


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# --- device set-build kernels (module-level so the jit compile caches
# persist across calls; an inline jax.jit would recompile per invocation)
# -------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sort_and_count_unique_jit():
    import jax
    import jax.numpy as jnp

    def f(v):
        s = jnp.sort(v)
        flags = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
        return s, jnp.sum(flags)
    return jax.jit(f)


def _sort_and_count_unique(v):
    return _sort_and_count_unique_jit()(v)


@functools.lru_cache(maxsize=None)
def _compact_sorted_jit(n_total, keep_counts):
    import jax
    import jax.numpy as jnp

    def f(s):
        # positions of the segment starts in already-sorted data (jnp.unique
        # would sort a second time; boundary gather is one pass)
        flags = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
        starts = jnp.nonzero(flags, size=n_total, fill_value=s.shape[0] - 1)[0]
        uniq = s[starts]
        if keep_counts:
            n = s.shape[0]
            ends = jnp.concatenate([starts[1:], jnp.full((1,), n, starts.dtype)])
            return uniq, ends - starts
        return uniq, jnp.zeros(0, jnp.int64)
    return jax.jit(f)


def _compact_sorted(s, n_total, keep_counts):
    uniq, counts = _compact_sorted_jit(n_total, keep_counts)(s)
    return uniq, (counts if keep_counts else None)
