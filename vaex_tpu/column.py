"""Lazy / virtual column types.

Re-design of the reference's ``vaex/column.py`` (753 LoC).  A *column* is
anything sliceable with ``__len__``, ``__getitem__`` (slice -> host array) and
a ``dtype``; plain numpy / numpy.ma / pyarrow arrays qualify directly.  The
lazy wrappers below materialize only the requested slice, so datasets much
larger than RAM stream through the executor tile by tile.
"""

from __future__ import annotations

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None

from . import array_types
from .datatype import DataType, dtype_of


class Column:
    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise NotImplementedError

    @property
    def dtype(self):
        raise NotImplementedError

    def to_numpy(self):
        return array_types.to_numpy(self[:])


class ColumnVirtualRange(Column):
    """Materialization-free arange (reference: column.py:48, ``vaex.vrange``)."""

    def __init__(self, start, stop, step=1, dtype=None):
        self.start = start
        self.stop = stop
        self.step = step
        self._dtype = np.dtype(dtype or np.int64)
        self.shape = (len(self),)

    def __len__(self):
        return int((self.stop - self.start + self.step - 1) // self.step)

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            return np.arange(self.start + start * self.step,
                             self.start + stop * self.step,
                             self.step * step, dtype=self._dtype)
        indices = np.asarray(item)
        return (self.start + indices * self.step).astype(self._dtype)

    def trim(self, i1, i2):
        return ColumnVirtualRange(self.start + i1 * self.step, self.start + i2 * self.step,
                                  self.step, self._dtype)

    def fingerprint(self):
        return f"vrange-{self.start}-{self.stop}-{self.step}-{self._dtype}"


class ColumnVirtualConstant(Column):
    """Constant column (reference: column.py:71, ``vaex.vconstant``)."""

    def __init__(self, value, length, dtype=None):
        self.value = value
        self.length = length
        self._dtype = np.dtype(dtype) if dtype is not None else np.asarray(value).dtype

    def __len__(self):
        return self.length

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, item):
        if isinstance(item, slice):
            start, stop, step = item.indices(len(self))
            n = max(0, (stop - start + (step - 1)) // step)
        else:
            n = len(np.asarray(item))
        return np.full(n, self.value, dtype=self._dtype)

    def trim(self, i1, i2):
        return ColumnVirtualConstant(self.value, i2 - i1, self._dtype)

    def fingerprint(self):
        return f"vconstant-{self.value!r}-{self.length}-{self._dtype}"


class ColumnIndexed(Column):
    """take/join indirection column (reference: column.py:222).

    ``indices`` may be a masked array or contain ``fill_index`` (== -1 style
    sentinel via mask) marking "no match": those rows come out null.
    """

    def __init__(self, source, indices, masked=False):
        self.source = source
        self.indices = indices
        self.masked = masked  # True: indices is np.ma with missing entries

    def __len__(self):
        return len(self.indices)

    @property
    def dtype(self):
        return dtype_of(self.source)

    @staticmethod
    def index(source, indices, masked=False):
        # collapse nested indirections: taking a take stays one hop deep
        if isinstance(source, ColumnIndexed):
            base_idx = source.indices
            if source.masked or masked:
                outer_data = np.ma.filled(indices, 0) if masked else np.asarray(indices)
                inner = np.asarray(np.ma.filled(base_idx, 0) if source.masked else base_idx)
                new_data = inner[outer_data]
                new_mask = np.zeros(len(outer_data), dtype=bool)
                if masked:
                    new_mask |= np.ma.getmaskarray(indices)
                if source.masked:
                    new_mask |= np.ma.getmaskarray(base_idx)[outer_data]
                return ColumnIndexed(source.source, np.ma.MaskedArray(new_data, new_mask), masked=True)
            return ColumnIndexed(source.source, np.asarray(base_idx)[np.asarray(indices)], masked=False)
        return ColumnIndexed(source, indices, masked=masked)

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("ColumnIndexed only supports slice access")
        indices = self.indices[item]
        if self.masked:
            data_idx = np.ma.filled(indices, 0)
            mask = np.ma.getmaskarray(indices)
        else:
            data_idx = np.asarray(indices)
            mask = None
        src = self.source
        if pa is not None and isinstance(src, (pa.Array, pa.ChunkedArray)):
            if mask is not None:
                taken = src.take(pa.array(data_idx, mask=mask))
            else:
                taken = src.take(pa.array(data_idx))
            return taken
        values = array_types.to_numpy(src[:])[data_idx] if isinstance(src, Column) else array_types.to_numpy(src)[data_idx]
        if mask is not None:
            prev = np.ma.getmaskarray(values) if isinstance(values, np.ma.MaskedArray) else False
            values = np.ma.MaskedArray(np.ma.filled(values, 0) if isinstance(values, np.ma.MaskedArray) else values,
                                       mask | prev)
        return values

    def trim(self, i1, i2):
        return ColumnIndexed(self.source, self.indices[i1:i2], self.masked)

    def fingerprint(self):
        from .utils import fingerprint, hash_array_data
        return fingerprint("column-indexed", hash_array_data(np.asarray(self.indices.data if self.masked else self.indices)))


class ColumnConcatenated(Column):
    """Lazy vstack of columns (reference: column.py:327)."""

    def __init__(self, columns):
        self.columns = columns
        self.offsets = np.cumsum([0] + [len(c) for c in columns])

    def __len__(self):
        return int(self.offsets[-1])

    @property
    def dtype(self):
        return dtype_of(self.columns[0])

    def __getitem__(self, item):
        if not isinstance(item, slice):
            raise TypeError("ColumnConcatenated only supports slice access")
        start, stop, step = item.indices(len(self))
        assert step == 1
        parts = []
        for i, col in enumerate(self.columns):
            c0, c1 = self.offsets[i], self.offsets[i + 1]
            lo, hi = max(start, c0), min(stop, c1)
            if lo < hi:
                parts.append(col[lo - c0:hi - c0])
        if not parts:
            return np.empty(0, dtype=DataType(self.dtype).numpy if not DataType(self.dtype).is_arrow else object)
        return array_types.concat(parts)


class ColumnDeviceDictionary(Column):
    """String column as device-resident int32 codes + small host label list.

    Used by GrouperCombined's decode: the 1e7-group fused-key split stays on
    device and the arrow DictionaryArray is materialized only when the
    column is actually read (the reference eagerly gathers materialized
    strings, groupby.py:186-213).
    """

    def __init__(self, codes, labels):
        self.codes = codes          # jnp int32 [N] (or numpy)
        self.labels = list(labels)
        import pyarrow as pa
        self._labels_arrow = pa.array(self.labels, type=pa.large_string())

    def __len__(self):
        return int(self.codes.shape[0])

    @property
    def dtype(self):
        import pyarrow as pa
        from .datatype import DataType
        return DataType(pa.dictionary(pa.int32(), pa.large_string()))

    def __getitem__(self, item):
        import numpy as np
        import pyarrow as pa
        codes = self.codes[item]
        host = np.asarray(codes)
        return pa.DictionaryArray.from_arrays(pa.array(host), self._labels_arrow)

    def trim(self, i1, i2):
        return ColumnDeviceDictionary(self.codes[i1:i2], self.labels)

    def fingerprint(self):
        from .utils import fingerprint
        import numpy as np
        head = np.asarray(self.codes[: min(1024, len(self))])
        return fingerprint("device-dict", head.tobytes(), tuple(self.labels[:64]),
                           len(self), len(self.labels))
