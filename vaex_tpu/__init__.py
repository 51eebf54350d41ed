"""vaex_tpu — a vectorized DataFrame / query-execution engine on JAX.

Brand-new implementation of the capabilities of vaex (lazy, out-of-core,
expression-driven DataFrames) for accelerators: expressions compile into
one fused XLA program per pass, aggregation grids live in device memory,
hashmaps are replaced by sorted-set binary-search kernels, and
multi-device execution is SPMD over a ``jax.sharding.Mesh``.

Top-level API mirrors the reference's ``vaex/__init__.py``:
``open / from_arrays / from_dict / from_pandas / from_arrow_table / from_csv /
from_json / concat / vrange / vconstant / register_function``.
"""

from __future__ import annotations

import glob as _glob
import os as _os

import jax as _jax

from . import settings as _settings

if _settings.X64:
    _jax.config.update("jax_enable_x64", True)

# persistent XLA compile cache: pass programs compile once per (shape,
# task-set), not once per process.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only without it does the package name a directory
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _settings.DEFAULT_COMPILE_CACHE)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as _np

from .dataframe import DataFrame, register_dataframe_accessor  # noqa: E402
from .dataset import Dataset, DatasetArrays  # noqa: E402
from .expression import Expression  # noqa: E402
from .registry import register_function  # noqa: E402
from . import functions as _functions  # noqa: E402,F401  (populates the namespace)
from . import agg  # noqa: E402,F401
from . import cache  # noqa: E402,F401
from . import array_types, settings  # noqa: E402,F401
from .column import ColumnVirtualConstant, ColumnVirtualRange  # noqa: E402
from .groupby import BinnerTime, Grouper, GrouperCategory, RowLimitException  # noqa: E402,F401
from . import geo  # noqa: E402,F401  (registers the df.geo accessor)
from . import astro  # noqa: E402,F401  (registers the df.astro accessor)
from . import stat  # noqa: E402,F401
from . import ml  # noqa: E402,F401  (registers the df.ml accessor)
from . import viz  # noqa: E402,F401  (registers the df.viz accessor)
from . import struct  # noqa: E402,F401  (struct_get/_project + expr.struct)
from . import graphql  # noqa: E402,F401  (registers the df.graphql accessor)
from . import jupyter  # noqa: E402,F401  (registers the df.widget accessor)
from . import progress  # noqa: E402,F401
from .delayed import delayed  # noqa: E402,F401  (API parity: vaex.delayed)

__version__ = "0.1.0"


def from_dataset(dataset) -> DataFrame:
    return DataFrame(dataset)


def from_arrays(**arrays) -> DataFrame:
    """(reference vaex/__init__.py:288)"""
    columns = {}
    for name, ar in arrays.items():
        if isinstance(ar, (list, tuple)):
            ar = _auto_array(ar)
        elif isinstance(ar, _np.ma.MaskedArray) and ar.dtype == object:
            import pyarrow as pa
            ar = pa.array(list(ar.data), mask=_np.ma.getmaskarray(ar))
        elif isinstance(ar, _np.ndarray) and ar.dtype.kind in "OUS":
            import pyarrow as pa
            try:
                # native inference keeps bytes as binary, strings as utf8 —
                # no lossy str() round-trip
                ar = pa.array(ar.tolist() if ar.dtype == object else ar)
            except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError,
                    pa.lib.ArrowNotImplementedError, ValueError, TypeError):
                ar = pa.array([None if v is None else str(v) for v in ar])
        columns[name] = ar
    return from_dataset(DatasetArrays(columns))


def from_dict(data) -> DataFrame:
    return from_arrays(**data)


def from_items(*items) -> DataFrame:
    return from_arrays(**dict(items))


def from_arrow_table(table) -> DataFrame:
    from .io.arrow import ArrowTableDataset
    return from_dataset(ArrowTableDataset(table))


def from_arrow_dataset(ds) -> DataFrame:  # pragma: no cover - thin wrapper
    return from_arrow_table(ds.to_table())


def from_pandas(df, name="pandas", copy_index=False, index_name="index") -> DataFrame:
    """(reference vaex/__init__.py:400ish)"""
    import pandas as pd
    columns = {}
    for name_ in df.columns:
        series = df[name_]
        values = series.to_numpy()
        if series.isna().any() and values.dtype == object:
            mask = series.isna().to_numpy()
            columns[str(name_)] = _np.ma.MaskedArray(values, mask)
        else:
            columns[str(name_)] = values
    if copy_index:
        columns[index_name] = df.index.to_numpy()
    return from_arrays(**columns)


def from_csv(path, convert=False, chunk_size=None, **kwargs) -> DataFrame:
    from .io.arrow import open_csv
    df = open_csv(path, **kwargs)
    if convert:
        out = str(path) + ".hdf5" if convert is True else str(convert)
        if not _os.path.exists(out):
            df.export_hdf5(out)
        return open(out)
    return df


def from_json(path_or_buffer, orient=None, copy_index=False) -> DataFrame:
    import pandas as pd
    return from_pandas(pd.read_json(path_or_buffer, orient=orient), copy_index=copy_index)


def from_ascii(path, seperator=None, names=True, **kwargs) -> DataFrame:
    import pandas as pd
    return from_pandas(pd.read_csv(path, sep=seperator or r"\s+"))


def open(path, convert=False, shuffle=False, fs_options=None, fs=None, *args, **kwargs):
    """Open a file as a DataFrame (reference vaex/__init__.py:96).

    Zero-cost for hdf5 (mmap) and arrow (memory-mapped IPC); parquet streams
    row groups lazily.  Glob patterns open many files concatenated.
    """
    path = str(path)
    from .io.remote import is_remote, open_remote
    if is_remote(path):
        return open_remote(path, fs_options)
    if any(c in path for c in "*?["):
        return open_many(sorted(_glob.glob(path)))
    ext = _os.path.splitext(path)[1].lower()
    if ext in (".hdf5", ".h5"):
        from .io.hdf5 import open_hdf5
        df = open_hdf5(path)
    elif ext == ".parquet":
        from .io.arrow import open_parquet
        df = open_parquet(path)
    elif ext == ".arrow":
        from .io.arrow import open_arrow
        df = open_arrow(path)
    elif ext == ".feather":
        from .io.arrow import open_feather
        df = open_feather(path)
    elif ext == ".fits":
        from .io.fits import open_fits
        df = open_fits(path)
    elif ext in (".vot", ".votable", ".xml"):
        from .io.votable import open_votable
        df = open_votable(path)
    elif ext == ".csv":
        df = from_csv(path, convert=convert)
    elif ext == ".json":
        df = from_json(path)
    else:
        from .io.gadget import is_gadget, open_gadget
        if is_gadget(path):  # gadget snapshots have no canonical extension
            df = open_gadget(path)
        else:
            raise IOError(f"cannot open {path!r}: unknown extension {ext!r}")
    if convert and ext not in (".csv",):
        out = path + ".hdf5" if convert is True else str(convert)
        if not _os.path.exists(out):
            df.export_hdf5(out)
        return open(out) if _os.path.abspath(out) != _os.path.abspath(path) else df
    return df


def open_many(filenames):
    """(reference vaex/__init__.py:256)"""
    dfs = [open(f) for f in filenames]
    return concat(dfs)


def concat(dfs, resolver="flexible") -> DataFrame:
    """(reference vaex/__init__.py:767)"""
    dfs = list(dfs)
    if len(dfs) == 1:
        return dfs[0]
    return dfs[0].concat(*dfs[1:], resolver=resolver)


def vrange(start, stop=None, step=1, dtype="i8") -> DataFrame:
    """A virtual [start, stop) range column, zero memory (reference
    vaex/__init__.py:775): ``vaex_tpu.vrange(0, 1e9)`` is free."""
    if stop is None:
        start, stop = 0, start
    col = ColumnVirtualRange(int(start), int(stop), int(step), dtype)
    return from_dataset(DatasetArrays({"x": col}))


def vconstant(value, length, dtype=None):
    return ColumnVirtualConstant(value, int(length), dtype)


def example():
    """A small generated example dataframe (reference: vaex.example())."""
    rng = _np.random.default_rng(42)
    n = 10000
    return from_arrays(
        id=_np.arange(n),
        x=rng.normal(0, 1, n),
        y=rng.normal(0, 1, n),
        z=rng.normal(0, 1, n),
        vx=rng.normal(0, 10, n),
        vy=rng.normal(0, 10, n),
        vz=rng.normal(0, 10, n),
        E=rng.uniform(0, 100, n),
    )


def _auto_array(values):
    has_none = any(v is None for v in values)
    if has_none:
        types = {type(v) for v in values if v is not None}
        if types <= {int, float, bool}:
            data = _np.asarray([0 if v is None else v for v in values])
            mask = _np.asarray([v is None for v in values])
            return _np.ma.MaskedArray(data, mask)
        import pyarrow as pa
        return pa.array(values)
    arr = _np.asarray(values)
    if arr.dtype.kind in "US":
        import pyarrow as pa
        return pa.array([str(v) for v in values])
    if arr.dtype == object:
        import pyarrow as pa
        return pa.array(values)
    return arr
