"""Columnar storage: the immutable, composable Dataset graph.

Re-design of the reference's ``vaex/dataset.py`` (1596 LoC).  A ``Dataset`` is
a Mapping name -> column with a ``row_count``, a ``chunk_iterator`` streaming
host chunks, a content ``fingerprint``, and pure decorator constructors
(``renamed / sliced / dropped / merged / take / concat / filtered``) that build
a new node without touching data.  The executor pulls chunks from here and
pads them into fixed-size device tiles.
"""

from __future__ import annotations

import collections.abc
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

from . import array_types
from .column import Column, ColumnIndexed
from .datatype import dtype_of
from .utils import fingerprint, hash_array_data

HERE_CHUNK = Tuple[int, int, Dict[str, object]]
builtins_min = min
builtins_max = max


def _slice_column(col, i1, i2):
    if isinstance(col, Column):
        return col[i1:i2]
    return array_types.slice_array(col, i1, i2)


class Dataset(collections.abc.Mapping):
    """Base class (reference: dataset.py:309)."""

    def __init__(self):
        self._row_count = None
        self._ids = {}
        self._fingerprint = None

    # -- Mapping protocol ---------------------------------------------------
    def __getitem__(self, name):
        return self._columns[name]

    def __iter__(self):
        return iter(self._columns)

    def __len__(self):
        return len(self._columns)

    @property
    def row_count(self) -> int:
        return self._row_count

    def dtypes(self):
        return {name: dtype_of(col) for name, col in self._columns.items()}

    # -- identity -----------------------------------------------------------
    def fingerprint(self) -> str:
        """Content fingerprint, computed once — Dataset nodes are immutable
        (and hashing device-resident columns costs a device round-trip)."""
        if getattr(self, "_fingerprint", None) is None:
            self._fingerprint = self._compute_fingerprint()
        return self._fingerprint

    def _compute_fingerprint(self) -> str:
        raise NotImplementedError

    def _column_fingerprint(self, name) -> str:
        if name in self._ids:
            return self._ids[name]
        col = self._columns[name]
        if hasattr(col, "fingerprint"):
            fp = col.fingerprint()
        else:
            # sampled content hash: head + strided middle + tail + length.
            # O(1) per column (full hashes are opt-in via DatasetFile.hashed
            # and its sidecar cache); the strided samples keep two arrays
            # that differ past the head from aliasing (the fingerprint keys
            # the result cache AND minmax value bounds).
            n = len(col)
            if n == 0:
                fp = hash_array_data(np.empty(0)) + "-n0"
            else:
                head = array_types.to_numpy(col[: builtins_min(1000, n)])
                parts = [hash_array_data(head)]
                if n > 2000:
                    step = builtins_max(1, n // 2048)
                    parts.append(hash_array_data(array_types.to_numpy(col[::step])))
                    parts.append(hash_array_data(array_types.to_numpy(col[n - 1000:n])))
                fp = fingerprint("col-sampled", parts) + f"-n{n}"
        self._ids[name] = fp
        return fp

    # -- chunking -----------------------------------------------------------
    def chunk_iterator(self, columns, chunk_size=None, reverse=False) -> Iterator[HERE_CHUNK]:
        """Yield (i1, i2, {name: host_array}) over [0, row_count).

        Default implementation slices columns; decorator nodes override where
        a smarter streaming plan exists (reference: dataset.py:503).
        """
        chunk_size = chunk_size or 1024 * 1024
        n = self.row_count
        starts = range(0, max(n, 1), chunk_size)
        if reverse:
            starts = reversed(list(starts))
        for i1 in starts:
            i2 = min(i1 + chunk_size, n)
            if n == 0:
                yield 0, 0, {name: self._columns[name][0:0] for name in columns}
                return
            yield i1, i2, {name: _slice_column(self._columns[name], i1, i2) for name in columns}

    def device_columns(self, columns):
        """Whole device-resident columns, or None if any needs host staging.

        The executor uses this to fuse an entire pass into one compiled
        program (a ``fori_loop`` over tiles) instead of dispatching one step
        per tile — the device analogue of the reference keeping hot data in the
        page cache (README.md:9-11).  Only nodes that can hand back plain
        ``jax.Array`` columns participate; anything needing host work
        (files, takes, filters, concat rechunking) returns None and rides the
        chunked path.
        """
        import jax
        cols = {}
        for name in columns:
            col = self._columns.get(name)
            if not isinstance(col, jax.Array):
                return None
            cols[name] = col
        return cols

    # -- decorators ---------------------------------------------------------
    def renamed(self, renaming: Dict[str, str]) -> "Dataset":
        return DatasetRenamed(self, renaming)

    def merged(self, other: "Dataset") -> "Dataset":
        return DatasetMerged(self, other)

    def dropped(self, *names) -> "Dataset":
        return DatasetDropped(self, names)

    def project(self, *names) -> "Dataset":
        drop = [n for n in self if n not in names]
        return self.dropped(*drop) if drop else self

    def slice(self, start, end) -> "Dataset":
        if start == 0 and end == self.row_count:
            return self
        return DatasetSliced(self, start, end)

    def take(self, indices, masked=False) -> "Dataset":
        return DatasetTake(self, indices, masked=masked)

    def concat(self, *others) -> "Dataset":
        datasets = []
        for ds in (self,) + others:
            if isinstance(ds, DatasetConcatenated):
                datasets.extend(ds.datasets)
            else:
                datasets.append(ds)
        return DatasetConcatenated(datasets)

    def filtered(self, mask: np.ndarray) -> "Dataset":
        return DatasetFiltered(self, mask)

    def shallow_copy(self):
        return self

    def close(self):
        pass


class DatasetArrays(Dataset):
    """In-memory dict of columns (reference: dataset.py:1304)."""

    def __init__(self, columns: Dict[str, object]):
        super().__init__()
        self._columns = dict(columns)
        lengths = {name: len(col) for name, col in self._columns.items()}
        if lengths:
            unique = set(lengths.values())
            if len(unique) != 1:
                raise ValueError(f"columns have unequal lengths: {lengths}")
            self._row_count = unique.pop()
        else:
            self._row_count = 0

    def _compute_fingerprint(self) -> str:
        return fingerprint("dataset-arrays",
                           {name: self._column_fingerprint(name) for name in self._columns})


class _Decorator(Dataset):
    """Shared plumbing for single-parent decorator nodes."""

    def __init__(self, original: Dataset):
        super().__init__()
        self.original = original


class DatasetRenamed(_Decorator):
    def __init__(self, original, renaming: Dict[str, str]):
        super().__init__(original)
        self.renaming = dict(renaming)
        self.reverse = {v: k for k, v in renaming.items()}
        self._columns = {renaming.get(name, name): col for name, col in original._columns.items()}
        self._row_count = original.row_count

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        src_cols = [self.reverse.get(name, name) for name in columns]
        for i1, i2, chunks in self.original.chunk_iterator(src_cols, chunk_size, reverse=reverse):
            yield i1, i2, {name: chunks[src] for name, src in zip(columns, src_cols)}

    def _compute_fingerprint(self):
        return fingerprint("dataset-renamed", self.original.fingerprint(), self.renaming)


class DatasetDropped(_Decorator):
    def __init__(self, original, names):
        super().__init__(original)
        self.names = tuple(names)
        self._columns = {n: c for n, c in original._columns.items() if n not in self.names}
        self._row_count = original.row_count

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        for name in columns:
            if name in self.names:
                raise KeyError(f"column {name} was dropped")
        yield from self.original.chunk_iterator(columns, chunk_size, reverse=reverse)

    def _compute_fingerprint(self):
        return fingerprint("dataset-dropped", self.original.fingerprint(), self.names)


class DatasetMerged(Dataset):
    """hstack of two datasets (reference: dataset.py:1216)."""

    def __init__(self, left: Dataset, right: Dataset):
        super().__init__()
        if left.row_count != right.row_count:
            raise ValueError(f"row counts differ: {left.row_count} vs {right.row_count}")
        overlap = set(left) & set(right)
        if overlap:
            raise NameError(f"duplicate columns: {overlap}")
        self.left = left
        self.right = right
        self._columns = {**left._columns, **right._columns}
        self._row_count = left.row_count

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        left_cols = [n for n in columns if n in self.left._columns]
        right_cols = [n for n in columns if n in self.right._columns]
        if not right_cols:
            yield from self.left.chunk_iterator(columns, chunk_size, reverse=reverse)
            return
        if not left_cols:
            yield from self.right.chunk_iterator(columns, chunk_size, reverse=reverse)
            return
        lit = self.left.chunk_iterator(left_cols, chunk_size, reverse=reverse)
        rit = self.right.chunk_iterator(right_cols, chunk_size, reverse=reverse)
        for (i1, i2, lc), (j1, j2, rc) in zip(lit, rit):
            assert (i1, i2) == (j1, j2), "merged datasets must chunk identically"
            out = dict(lc)
            out.update(rc)
            yield i1, i2, {name: out[name] for name in columns}

    def _compute_fingerprint(self):
        return fingerprint("dataset-merged", self.left.fingerprint(), self.right.fingerprint())


class DatasetSliced(_Decorator):
    """Row-range view (reference: dataset.py:1027)."""

    def __init__(self, original, start, end):
        super().__init__(original)
        if isinstance(original, DatasetSliced):
            start = original.start + start
            end = original.start + end
            original = original.original
            self.original = original
        self.start = start
        self.end = end
        self._row_count = end - start
        self._columns = {name: _SlicedView(col, start, end) for name, col in original._columns.items()}

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        chunk_size = chunk_size or 1024 * 1024
        n = self._row_count
        starts = range(0, max(n, 1), chunk_size)
        if reverse:
            starts = reversed(list(starts))
        for i1 in starts:
            i2 = min(i1 + chunk_size, n)
            chunks = {name: _slice_column(self.original._columns[name], self.start + i1, self.start + i2)
                      for name in columns}
            yield i1, i2, chunks
            if n == 0:
                return

    def device_columns(self, columns):
        base = self.original.device_columns(columns)
        if base is None:
            return None
        return {name: col[self.start:self.end] for name, col in base.items()}

    def _compute_fingerprint(self):
        return fingerprint("dataset-sliced", self.original.fingerprint(), self.start, self.end)


class _SlicedView:
    """Zero-copy sliced view over a column."""

    def __init__(self, col, start, end):
        self.col = col
        self.start = start
        self.end = end

    def __len__(self):
        return self.end - self.start

    @property
    def dtype(self):
        return dtype_of(self.col).internal

    def __getitem__(self, item):
        if isinstance(item, slice):
            i1, i2, step = item.indices(len(self))
            assert step == 1
            return _slice_column(self.col, self.start + i1, self.start + i2)
        return self.col[self.start:self.end][item]


class DatasetTake(_Decorator):
    """Row gather (reference: dataset.py:853)."""

    def __init__(self, original, indices, masked=False):
        super().__init__(original)
        self.indices = indices
        self.masked = masked
        self._columns = {name: ColumnIndexed.index(col, indices, masked=masked)
                         for name, col in original._columns.items()}
        self._row_count = len(indices)

    def _compute_fingerprint(self):
        idx = self.indices
        data = np.asarray(idx.data if isinstance(idx, np.ma.MaskedArray) else idx)
        return fingerprint("dataset-take", self.original.fingerprint(), hash_array_data(data), self.masked)


class DatasetFiltered(_Decorator):
    """Boolean-mask filter pushed into chunk iteration (reference: dataset.py:929)."""

    def __init__(self, original, mask: np.ndarray):
        super().__init__(original)
        assert len(mask) == original.row_count
        self.mask = np.asarray(mask, dtype=bool)
        from . import hostkern
        indices = hostkern.mask_indices(self.mask)
        self._row_count = len(indices)
        self._indices = indices
        self._columns = {name: ColumnIndexed.index(col, indices) for name, col in original._columns.items()}

    def _compute_fingerprint(self):
        return fingerprint("dataset-filtered", self.original.fingerprint(), hash_array_data(self.mask))


class DatasetConcatenated(Dataset):
    """vstack (reference: dataset.py:660) with chunk re-alignment."""

    def __init__(self, datasets: List[Dataset]):
        super().__init__()
        self.datasets = list(datasets)
        first = self.datasets[0]
        names = list(first)
        for ds in self.datasets[1:]:
            if list(ds) != names:
                common = [n for n in names if n in set(ds)]
                names = common
        self._names = names
        self._columns = {}
        from .column import ColumnConcatenated
        for name in names:
            self._columns[name] = ColumnConcatenated([ds._columns[name] for ds in self.datasets])
        self._row_count = sum(ds.row_count for ds in self.datasets)

    def chunk_iterator(self, columns, chunk_size=None, reverse=False):
        chunk_size = chunk_size or 1024 * 1024
        if not columns:
            # pure row-range iteration (e.g. count('*') passes)
            n = self.row_count
            for i1 in range(0, max(n, 1), chunk_size):
                yield i1, min(i1 + chunk_size, n), {}
                if n == 0:
                    return
            return
        # stream each sub-dataset, rechunking to chunk_size boundaries
        # (reference: dataset.py:238-306 chunk_rechunk)
        pending: Dict[str, list] = {name: [] for name in columns}
        pending_rows = 0
        offset = 0

        def flush(n):
            nonlocal pending_rows, offset
            out = {}
            for name in columns:
                parts = pending[name]
                joined = array_types.concat(parts) if len(parts) > 1 else parts[0]
                out[name] = array_types.slice_array(joined, 0, n)
                rest = array_types.slice_array(joined, n, pending_rows)
                pending[name] = [rest] if pending_rows - n else []
            i1 = offset
            offset += n
            pending_rows -= n
            return i1, offset, out

        datasets = list(reversed(self.datasets)) if reverse else self.datasets
        if reverse:
            raise NotImplementedError("reverse iteration over concat")
        for ds in datasets:
            for _, _, chunks in ds.chunk_iterator(columns, chunk_size):
                for name in columns:
                    pending[name].append(chunks[name])
                pending_rows += array_types.length(chunks[columns[0]]) if columns else 0
                while pending_rows >= chunk_size:
                    yield flush(chunk_size)
        if pending_rows or self.row_count == 0:
            if columns:
                yield flush(pending_rows)
            else:
                yield offset, offset, {}

    def _compute_fingerprint(self):
        return fingerprint("dataset-concat", [ds.fingerprint() for ds in self.datasets])


class DatasetFile(Dataset):
    """Base for file-backed datasets (reference: dataset.py:1415)."""

    def __init__(self, path):
        super().__init__()
        self.path = path
        self._columns = {}
        self._row_count = 0

    def add_column(self, name, column):
        self._columns[name] = column
        self._row_count = len(column)

    def _compute_fingerprint(self) -> str:
        if os.path.exists(str(self.path)):
            stat = os.stat(self.path)
            return fingerprint("dataset-file", str(self.path), stat.st_size, stat.st_mtime)
        # remote url: identity from the url + shape (block cache keys carry
        # the remote mtime/size already)
        return fingerprint("dataset-file-remote", str(self.path), self._row_count,
                           sorted(self._columns))

    # -- content hashes + sidecar cache (reference dataset.py:1489-1596) ----
    def _hash_sidecar_path(self):
        return os.path.join(f"{self.path}.d", "hashes.yaml")

    def _read_hashes(self):
        """Sidecar column hashes, if present and still valid for this file."""
        import yaml
        path = self._hash_sidecar_path()
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                data = yaml.safe_load(f) or {}
            stat = os.stat(self.path)
            if data.get("size") != stat.st_size or data.get("mtime") != stat.st_mtime:
                return {}  # file changed: every hash is stale
            return data.get("columns", {}) or {}
        except Exception:
            return {}

    def _write_hashes(self, hashes):
        import yaml
        stat = os.stat(self.path)
        os.makedirs(f"{self.path}.d", exist_ok=True)
        tmp = self._hash_sidecar_path() + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            yaml.safe_dump({"size": stat.st_size, "mtime": stat.st_mtime,
                            "columns": dict(hashes)}, f)
        os.replace(tmp, self._hash_sidecar_path())

    def hashed(self):
        """A copy whose fingerprint derives from full column content hashes.

        Hashes are computed once per file and persisted in
        ``<path>.d/hashes.yaml`` (the reference's sidecar cache,
        dataset.py:1489-1596), so the expensive pass never repeats across
        processes.  Without this the fingerprint is (path, size, mtime) —
        cheap but not content-derived."""
        from . import array_types
        hashes = self._read_hashes()
        missing = [n for n in self._columns if n not in hashes]
        for name in missing:
            col = self._columns[name]
            data = array_types.to_numpy(col[:]) if len(col) else np.empty(0)
            hashes[name] = hash_array_data(data)
        if missing:
            try:
                self._write_hashes(hashes)
            except OSError:
                pass  # read-only location: hashes still used this process
        import copy
        ds = copy.copy(self)
        ds._ids = dict(hashes)
        ds._fingerprint = fingerprint("dataset-file-hashed", dict(sorted(hashes.items())))
        return ds
