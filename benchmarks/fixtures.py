"""Benchmark dataset generators (reference: benchmarks/fixtures.py:26-75).

``numerical(n)``: x,y float64 + x4,y4 float32 + i1_{10,100,1K,1M} int64 key
columns; ``h2o(n, k)``: the H2O groupby benchmark layout (id1-id6, v1-v3).
Datasets are generated in memory (HDF5 caching via ``--write``).
"""

from __future__ import annotations

import numpy as np


def numerical(n: int, seed=42):
    import vaex_tpu as vt
    rng = np.random.default_rng(seed)
    x = rng.random(n)
    y = rng.random(n)
    return vt.from_arrays(
        x=x, y=y,
        x4=x.astype(np.float32), y4=y.astype(np.float32),
        i1_10=rng.integers(0, 10, n).astype(np.int64),
        i1_100=rng.integers(0, 100, n).astype(np.int64),
        i1_1K=rng.integers(0, 1000, n).astype(np.int64),
        i1_1M=rng.integers(0, 1_000_000, n).astype(np.int64),
    )


def h2o_arrays(n: int, k: int = 100, seed=42):
    """H2O db-benchmark groupby table as numpy columns (reference
    benchmarks/groupbyh2o.py:15-93): id1..id6 int64 keys, v1..v3 values."""
    rng = np.random.default_rng(seed)
    return dict(
        id1=rng.integers(1, k + 1, n, dtype=np.int64),       # 'id%03d' strings in H2O
        id2=rng.integers(1, k + 1, n, dtype=np.int64),
        id3=rng.integers(1, n // k + 1, n, dtype=np.int64),  # high cardinality
        id4=rng.integers(1, k + 1, n, dtype=np.int64),
        id5=rng.integers(1, k + 1, n, dtype=np.int64),
        id6=rng.integers(1, n // k + 1, n, dtype=np.int64),
        v1=rng.integers(1, 6, n, dtype=np.int64),
        v2=rng.integers(1, 16, n, dtype=np.int64),
        v3=rng.random(n) * 100,
    )


def h2o(n: int, k: int = 100, seed=42):
    """H2O db-benchmark layout as a DataFrame."""
    import vaex_tpu as vt
    return vt.from_arrays(**h2o_arrays(n, k, seed))
