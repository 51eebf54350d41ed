"""ctypes binding for the native host kernels (csrc/hostkern.cpp).

The C++ library covers the host-resident roles of the reference's native
layer (SURVEY §2.1): row-mask bookkeeping (superutils.cpp Mask), murmur-style
hash partitioning for the distributed shuffle (hash.hpp), NaN-aware min/max
scans (vaexfast.cpp find_nan_min_max) and parallel gather.  Every entry point
has a numpy fallback so the engine works without a compiled library; the
build is one ``make -C csrc``, run at first use when the library is
missing or older than its source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lib = None
_tried = False
_lock = threading.Lock()

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_hostkern.so")
_CSRC = os.path.join(os.path.dirname(_HERE), "csrc")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        src = os.path.join(_CSRC, "hostkern.cpp")
        if os.path.exists(src) and (not os.path.exists(_SO)
                                    or os.path.getmtime(_SO) < os.path.getmtime(src)):
            # a missing or stale library (older than its source, e.g. left
            # by another tree) is rebuilt, never loaded
            try:
                subprocess.run(["make", "-C", _CSRC], check=True, capture_output=True,
                               timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        if not os.path.exists(_SO):
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.mask_count.restype = ctypes.c_int64
        lib.mask_count.argtypes = [u8p, ctypes.c_int64]
        lib.mask_indices.restype = ctypes.c_int64
        lib.mask_indices.argtypes = [u8p, ctypes.c_int64, i64p]
        lib.mask_logical_to_raw.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                            ctypes.c_int64, i64p, i64p]
        lib.hash_partition_i64.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, i32p]
        lib.partition_counts.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p]
        lib.partition_scatter.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32, i64p, i64p]
        lib.minmax_f64.argtypes = [f64p, ctypes.c_int64, f64p, f64p]
        lib.minmax_i64.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
        lib.map_index_i64.argtypes = [i64p, i64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p]
        lib.map_index_f64.argtypes = [f64p, i64p, ctypes.c_int64, f64p, ctypes.c_int64, i64p]
        lib.take_f64.argtypes = [f64p, i64p, ctypes.c_int64, f64p]
        lib.take_i64.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
        lib.take_masked_f64.argtypes = [f64p, i64p, ctypes.c_int64, f64p, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(ar, ctype):
    return ar.ctypes.data_as(ctypes.POINTER(ctype))


def mask_count(mask: np.ndarray) -> int:
    lib = _load()
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    if lib is None:
        return int(np.count_nonzero(mask))
    return lib.mask_count(_ptr(mask, ctypes.c_uint8), len(mask))


def mask_indices(mask: np.ndarray) -> np.ndarray:
    """Raw indices of True rows (reference superutils Mask::indices)."""
    lib = _load()
    mask_u8 = np.ascontiguousarray(mask, dtype=np.uint8)
    if lib is None:
        return np.flatnonzero(mask_u8)
    out = np.empty(len(mask_u8), dtype=np.int64)
    n = lib.mask_indices(_ptr(mask_u8, ctypes.c_uint8), len(mask_u8),
                         _ptr(out, ctypes.c_int64))
    return out[:n]


def hash_partition(keys: np.ndarray, nparts: int) -> np.ndarray:
    """Murmur-mix partition ids for the distributed shuffle."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    if lib is None:
        v = keys.astype(np.uint64)
        v ^= v >> np.uint64(33)
        v *= np.uint64(0xFF51AFD7ED558CCD)
        v ^= v >> np.uint64(33)
        v *= np.uint64(0xC4CEB9FE1A85EC53)
        v ^= v >> np.uint64(33)
        return (v % np.uint64(nparts)).astype(np.int32)
    out = np.empty(len(keys), dtype=np.int32)
    lib.hash_partition_i64(_ptr(keys, ctypes.c_int64), len(keys), nparts,
                           _ptr(out, ctypes.c_int32))
    return out


def partition_layout(parts: np.ndarray, nparts: int):
    """(counts, offsets, row order) for a partition-contiguous shuffle."""
    lib = _load()
    parts = np.ascontiguousarray(parts, dtype=np.int32)
    n = len(parts)
    if lib is None:
        counts = np.bincount(parts, minlength=nparts).astype(np.int64)
        order = np.argsort(parts, kind="stable").astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        return counts, offsets, order
    counts = np.empty(nparts, dtype=np.int64)
    lib.partition_counts(_ptr(parts, ctypes.c_int32), n, nparts, _ptr(counts, ctypes.c_int64))
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    order = np.empty(n, dtype=np.int64)
    lib.partition_scatter(_ptr(parts, ctypes.c_int32), n, nparts,
                          _ptr(offsets.copy(), ctypes.c_int64), _ptr(order, ctypes.c_int64))
    return counts, offsets, order


def minmax(data: np.ndarray):
    """NaN-skipping min/max (reference vaexfast find_nan_min_max)."""
    lib = _load()
    data = np.ascontiguousarray(data)
    if lib is not None and data.dtype == np.float64:
        lo = ctypes.c_double()
        hi = ctypes.c_double()
        lib.minmax_f64(_ptr(data, ctypes.c_double), len(data),
                       ctypes.byref(lo), ctypes.byref(hi))
        return lo.value, hi.value
    if lib is not None and data.dtype == np.int64:
        lo = ctypes.c_int64()
        hi = ctypes.c_int64()
        lib.minmax_i64(_ptr(data, ctypes.c_int64), len(data),
                       ctypes.byref(lo), ctypes.byref(hi))
        return lo.value, hi.value
    if data.dtype.kind == "f":
        return float(np.nanmin(data)), float(np.nanmax(data))
    return data.min(), data.max()


def map_index(sorted_keys: np.ndarray, sorted_rows: np.ndarray,
              left_keys: np.ndarray):
    """First-match row per left key in the sorted right index, -1 unmatched
    (parallel binary search; the join probe). Returns None if no native
    kernel covers the dtype (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    sorted_rows = np.ascontiguousarray(sorted_rows, dtype=np.int64)
    out = np.empty(len(left_keys), dtype=np.int64)
    if sorted_keys.dtype == np.int64 and left_keys.dtype == np.int64:
        sk = np.ascontiguousarray(sorted_keys)
        lk = np.ascontiguousarray(left_keys)
        lib.map_index_i64(_ptr(sk, ctypes.c_int64), _ptr(sorted_rows, ctypes.c_int64),
                          len(sk), _ptr(lk, ctypes.c_int64), len(lk),
                          _ptr(out, ctypes.c_int64))
        return out
    if sorted_keys.dtype == np.float64 and left_keys.dtype == np.float64:
        sk = np.ascontiguousarray(sorted_keys)
        lk = np.ascontiguousarray(left_keys)
        lib.map_index_f64(_ptr(sk, ctypes.c_double), _ptr(sorted_rows, ctypes.c_int64),
                          len(sk), _ptr(lk, ctypes.c_double), len(lk),
                          _ptr(out, ctypes.c_int64))
        return out
    return None


def take(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    lib = _load()
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    src = np.ascontiguousarray(src)
    if lib is not None and src.dtype == np.float64:
        out = np.empty(len(indices), dtype=np.float64)
        lib.take_f64(_ptr(src, ctypes.c_double), _ptr(indices, ctypes.c_int64),
                     len(indices), _ptr(out, ctypes.c_double))
        return out
    if lib is not None and src.dtype == np.int64:
        out = np.empty(len(indices), dtype=np.int64)
        lib.take_i64(_ptr(src, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
                     len(indices), _ptr(out, ctypes.c_int64))
        return out
    return src[indices]
