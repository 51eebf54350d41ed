"""DataType: one type object bridging numpy, pyarrow and jax dtypes.

Re-design of the reference's ``vaex/datatype.py`` (438 LoC): a thin value type
that answers "what is this column's logical type" uniformly whether the data
currently lives as a numpy array on the host, an arrow array in a file, or a
jnp array in device memory.  Addition: ``.device`` — the dtype actually used
on device (strings become int32 dictionary codes, datetimes become int64).
"""

from __future__ import annotations

import numpy as np

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


_ARROW_TO_NUMPY = {}
if pa is not None:
    _ARROW_TO_NUMPY = {
        pa.int8(): np.dtype("int8"),
        pa.int16(): np.dtype("int16"),
        pa.int32(): np.dtype("int32"),
        pa.int64(): np.dtype("int64"),
        pa.uint8(): np.dtype("uint8"),
        pa.uint16(): np.dtype("uint16"),
        pa.uint32(): np.dtype("uint32"),
        pa.uint64(): np.dtype("uint64"),
        pa.float16(): np.dtype("float16"),
        pa.float32(): np.dtype("float32"),
        pa.float64(): np.dtype("float64"),
        pa.bool_(): np.dtype("bool"),
    }


class DataType:
    """Unifies np.dtype and arrow DataType (reference: datatype.py DataType)."""

    def __init__(self, internal):
        if isinstance(internal, DataType):
            internal = internal.internal
        if isinstance(internal, str):
            internal = np.dtype(internal)
        if isinstance(internal, type) and issubclass(internal, np.generic):
            internal = np.dtype(internal)
        self.internal = internal

    # -- predicates ---------------------------------------------------------
    @property
    def is_arrow(self):
        return pa is not None and isinstance(self.internal, pa.DataType)

    @property
    def is_numpy(self):
        return isinstance(self.internal, np.dtype)

    @property
    def is_string(self):
        if self.is_arrow:
            # binary counts as string-like, matching numpy 'S' (bytes) below
            return (pa.types.is_string(self.internal)
                    or pa.types.is_large_string(self.internal)
                    or pa.types.is_binary(self.internal)
                    or pa.types.is_large_binary(self.internal))
        return self.internal.kind in "US"

    @property
    def is_primitive(self):
        return not self.is_string and (self.is_numpy and self.internal.kind in "biuf"
                                       or self.is_arrow and self.internal in _ARROW_TO_NUMPY)

    @property
    def is_datetime(self):
        if self.is_arrow:
            return pa.types.is_timestamp(self.internal) or pa.types.is_date(self.internal)
        return self.internal.kind == "M"

    @property
    def is_timedelta(self):
        if self.is_arrow:
            return pa.types.is_duration(self.internal)
        return self.internal.kind == "m"

    @property
    def is_float(self):
        return self.numpy.kind == "f"

    @property
    def is_integer(self):
        return self.numpy.kind in "iu"

    @property
    def is_signed(self):
        return self.numpy.kind == "i"

    @property
    def is_unsigned(self):
        return self.numpy.kind == "u"

    @property
    def is_bool(self):
        return self.numpy.kind == "b"

    @property
    def is_list(self):
        return self.is_arrow and (pa.types.is_list(self.internal) or pa.types.is_large_list(self.internal))

    @property
    def is_struct(self):
        return self.is_arrow and pa.types.is_struct(self.internal)

    @property
    def is_encoded(self):
        return self.is_arrow and pa.types.is_dictionary(self.internal)

    # -- conversions --------------------------------------------------------
    @property
    def numpy(self) -> np.dtype:
        if self.is_numpy:
            return self.internal
        if self.is_arrow:
            if self.internal in _ARROW_TO_NUMPY:
                return _ARROW_TO_NUMPY[self.internal]
            if pa.types.is_timestamp(self.internal):
                return np.dtype(f"M8[{self.internal.unit}]")
            if pa.types.is_duration(self.internal):
                return np.dtype(f"m8[{self.internal.unit}]")
            if self.is_string:
                return np.dtype(object)
            if self.is_encoded:
                return DataType(self.internal.value_type).numpy
        raise TypeError(f"cannot convert {self.internal!r} to numpy dtype")

    @property
    def arrow(self):
        if self.is_arrow:
            return self.internal
        return pa.from_numpy_dtype(self.internal)

    @property
    def device(self) -> np.dtype:
        """The dtype this column uses on the device.

        Strings ride as int32 dictionary codes; datetimes/timedeltas as their
        int64 epoch representation; everything primitive is itself.
        """
        if self.is_string or self.is_encoded:
            return np.dtype("int32")
        if self.is_datetime or self.is_timedelta:
            return np.dtype("int64")
        return self.numpy

    @property
    def index_type(self):
        return self

    def upcast(self) -> "DataType":
        """Sum-accumulator dtype: ints->int64, uints->uint64, float32->float64.

        Reference semantics: superagg.cpp:289-346 / agg.py:99-100.
        """
        n = self.numpy
        if n.kind == "i" or n.kind == "b":
            return DataType(np.dtype("int64"))
        if n.kind == "u":
            return DataType(np.dtype("uint64"))
        if n.kind == "f":
            return DataType(np.dtype("float64"))
        return self

    # -- misc ---------------------------------------------------------------
    @property
    def name(self):
        if self.is_numpy:
            return self.internal.name
        return str(self.internal)

    def __eq__(self, other):
        if other is None:
            return False
        if isinstance(other, str):
            try:
                other = DataType(np.dtype(other))
            except TypeError:
                return self.name == other
        if not isinstance(other, DataType):
            other = DataType(other)
        if self.is_arrow and other.is_arrow:
            return self.internal == other.internal
        try:
            return self.numpy == other.numpy
        except TypeError:
            return False

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"DataType<{self.name}>"


def dtype_of(array) -> DataType:
    """DataType of any supported host/device array."""
    if pa is not None and isinstance(array, (pa.Array, pa.ChunkedArray)):
        return DataType(array.type)
    return DataType(np.asarray(array).dtype if not hasattr(array, "dtype") else array.dtype)
