"""Small shared helpers: fingerprints, name mangling, progress plumbing.

Fingerprints re-implement the role of the reference's
``vaex.cache.fingerprint`` (dask tokenize, cache.py:385-392) and the blake3
content hashes of ``vaex/dataset.py:110-197``: stable content-addressed keys
used to dedupe tasks, key the result cache and identify datasets.
"""

from __future__ import annotations

import hashlib
import keyword
import re

import numpy as np


def _tokenize_into(h, obj):
    if obj is None or isinstance(obj, (bool, int, float, str, bytes, complex)):
        h.update(repr(obj).encode())
    elif isinstance(obj, (list, tuple)):
        h.update(b"(")
        for o in obj:
            _tokenize_into(h, o)
            h.update(b",")
        h.update(b")")
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj, key=repr):
            _tokenize_into(h, k)
            h.update(b":")
            _tokenize_into(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (set, frozenset)):
        _tokenize_into(h, sorted(obj, key=repr))
    elif isinstance(obj, np.dtype):
        h.update(obj.str.encode())
    elif isinstance(obj, np.ndarray):
        h.update(obj.dtype.str.encode())
        h.update(str(obj.shape).encode())
        data = obj if obj.dtype != object else np.array([repr(o) for o in obj.ravel()])
        h.update(np.ascontiguousarray(data).tobytes() if data.dtype != object else repr(data.tolist()).encode())
    elif hasattr(obj, "fingerprint"):
        fp = obj.fingerprint() if callable(obj.fingerprint) else obj.fingerprint
        h.update(str(fp).encode())
    elif hasattr(obj, "__dask_tokenize__"):
        _tokenize_into(h, obj.__dask_tokenize__())
    else:
        h.update(repr(obj).encode())


def fingerprint(*args, **kwargs) -> str:
    """Stable content hash of arbitrary (nested) python values."""
    h = hashlib.sha256()
    _tokenize_into(h, args)
    if kwargs:
        _tokenize_into(h, kwargs)
    return h.hexdigest()


def hash_array_data(ar) -> str:
    """Content hash of one column's raw data (reference: dataset.py:110-197)."""
    h = hashlib.sha256()
    ar = np.asarray(ar) if not isinstance(ar, np.ndarray) else ar
    if isinstance(ar, np.ma.MaskedArray):
        h.update(b"masked")
        _tokenize_into(h, np.ma.getmaskarray(ar))
        ar = ar.data
    _tokenize_into(h, ar)
    return h.hexdigest()


_identifier_re = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def valid_expression_name(name: str) -> bool:
    return bool(_identifier_re.match(name)) and not keyword.iskeyword(name)


_find_valid_name_counter = {}


def find_valid_name(name, used=()):
    """Mangle a column name into a valid python identifier (reference: utils.py)."""
    name = str(name)
    if not valid_expression_name(name):
        translated = re.sub(r"[^a-zA-Z0-9_]", "_", name)
        if not translated or not _identifier_re.match(translated):
            translated = "_" + translated
        name = translated
    base = name
    i = 1
    while name in used:
        name = f"{base}_{i}"
        i += 1
    return name


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


class Signal:
    """Tiny pub/sub (reference: vaex/events.py Signal)."""

    def __init__(self, name=""):
        self.name = name
        self.callbacks = []

    def connect(self, f):
        self.callbacks.append(f)
        return f

    def disconnect(self, f):
        self.callbacks.remove(f)

    def emit(self, *args, **kwargs):
        return [cb(*args, **kwargs) for cb in self.callbacks]


import contextlib as _contextlib
import os as _os
import sys as _sys
import time as _time

TRACE = _os.environ.get("VAEX_TPU_TRACE", "") not in ("", "0")


@_contextlib.contextmanager
def trace(name):
    """Env-gated stage tracing (VAEX_TPU_TRACE=1): prints wall time of the
    wrapped block to stderr.  The stand-in for the reference's
    progressbar tree (vaex/misc/progressbar.py) when profiling headless."""
    if not TRACE:
        yield
        return
    t0 = _time.perf_counter()
    try:
        yield
    finally:
        print(f"[trace] {name}: {(_time.perf_counter() - t0)*1e3:.1f} ms",
              file=_sys.stderr, flush=True)


# the CPU backend reports no allocator stats: plan against a fixed budget
CPU_MEMORY_BUDGET = 16_000_000_000


def device_memory_budget():
    """Bytes of device memory a pass may plan around: the first device's
    allocator limit (``memory_stats()["bytes_limit"]``).  The CPU backend
    has no stats and gets :data:`CPU_MEMORY_BUDGET`; any other device
    without stats is an error."""
    import jax
    dev = jax.devices()[0]
    stats = dev.memory_stats()
    if stats and "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    if dev.platform == "cpu":
        return CPU_MEMORY_BUDGET
    raise RuntimeError(f"{dev.platform} device {dev.device_kind!r} reports no "
                       "memory limit to size device programs against")
