"""Process-pool execution of python UDFs (reference: vaex/multiprocessing.py
+ parallelize.py).  Host-side python UDFs are the one place the GIL still
bites; chunks are shipped to a fork-server pool, whose workers never
inherit the parent's device context.  The UDF must be picklable
(module-level).  Pool size via VAEX_TPU_NUM_PROCESSES."""

from __future__ import annotations

import os

import numpy as np

_pool = None


def _get_pool():
    global _pool
    if _pool is None:
        import multiprocessing as mp
        nproc = int(os.environ.get("VAEX_TPU_NUM_PROCESSES", 0)) or os.cpu_count() or 4
        ctx = mp.get_context("forkserver")
        _pool = ctx.Pool(min(nproc, 16))
    return _pool


def _run_chunk(payload):
    f, vectorize, chunks = payload
    if vectorize:
        return np.asarray(f(*chunks))
    return np.asarray([f(*row) for row in zip(*chunks)])


def apply_parallel(f, arrays, vectorize=True, chunks=None):
    n = len(arrays[0]) if arrays else 0
    if n < 10000:  # not worth the IPC
        return _run_chunk((f, vectorize, arrays))
    pool = _get_pool()
    nchunks = chunks or (pool._processes * 2)
    bounds = np.linspace(0, n, nchunks + 1).astype(int)
    payloads = [(f, vectorize, [a[i1:i2] for a in arrays])
                for i1, i2 in zip(bounds[:-1], bounds[1:]) if i2 > i1]
    parts = pool.map(_run_chunk, payloads)
    return np.concatenate(parts)
