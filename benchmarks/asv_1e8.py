"""Reference asv configs at 1e8 rows on one GPU.

Mirrors the reference's remaining asv suites at their largest N with
device-generated data:

  isin    numeric key, M in {1, 100, 1e4, 1e6} values
          (reference benchmarks/isin.py:9-28, N=1e7..1e8 M=1..1e6)
  binby   sum over 10 / 1K / 1M bins for int8/int16/int32/int64 keys
          (reference benchmarks/aggregates.py binby sweep)
  join    fact 1e8 x dim 1e6 plan + count over the joined frame
          (reference README join claim; benchmarks config 4)

Every timing carries an oracle check (counts exact; sums 1e-6).

Run: python benchmarks/asv_1e8.py [--n 1e8] [isin binby join]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def _timed(results, name, n, fn, reps=2):
    fn()  # warm/compile
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    results[name] = {"seconds": best, "rows_per_s": n / best}
    print(f"{name:28s}: {best*1e3:9.1f} ms  {n/best/1e6:9.1f} M rows/s",
          flush=True)
    return out


def bench_isin(vt, cache, n, results):
    import jax
    import jax.numpy as jnp
    k1, = jax.random.split(jax.random.PRNGKey(1), 1)
    keys_dev = jax.random.randint(k1, (n,), 0, 2_000_000, dtype=jnp.int32).astype(jnp.int64)
    df = vt.from_dataset(vt.DatasetArrays({"key": keys_dev}))
    df._tile_rows = 1 << 24
    rng = np.random.default_rng(2)
    with cache.off():
        for m in (1, 100, 10_000, 1_000_000):
            values = np.unique(rng.integers(0, 2_000_000, m * 2))[:m].astype(np.int64)
            cnt = _timed(results, f"isin_M={m}", n, lambda v=values: int(np.asarray(
                df.count(selection=str(df["key"].isin(v))))))
            # oracle on the selection count via a direct device computation
            expect = int(np.asarray(
                jnp.sum(jnp.isin(keys_dev, jnp.asarray(values)))
                if m <= 100 else
                jnp.sum(jnp.searchsorted(jnp.asarray(np.sort(values)), keys_dev,
                                         side="right")
                        > jnp.searchsorted(jnp.asarray(np.sort(values)), keys_dev,
                                           side="left"))))
            assert cnt == expect, (cnt, expect, m)


def bench_binby(vt, cache, n, results):
    import jax
    import jax.numpy as jnp
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    x_dev = jax.random.uniform(k2, (n,), dtype=jnp.float64)
    sum_x = float(np.asarray(jnp.sum(x_dev)))
    with cache.off():
        for dt_name, dt in (("int8", jnp.int8), ("int16", jnp.int16),
                            ("int32", jnp.int32), ("int64", jnp.int64)):
            for bins in (10, 1000, 1_000_000):
                hi = min(bins, np.iinfo(np.dtype(dt_name)).max)
                keys_dev = jax.random.randint(k1, (n,), 0, hi, dtype=jnp.int32).astype(dt)
                if bins > hi:
                    continue  # int8 can't address 1K/1M bins
                df = vt.from_dataset(vt.DatasetArrays({"k": keys_dev, "x": x_dev}))
                df = df.categorize("k", labels=list(range(hi)))
                df._tile_rows = 1 << 24
                grid = _timed(results, f"binby_{dt_name}_{bins}", n,
                              lambda d=df, b=hi: np.asarray(
                                  d.sum("x", binby=["k"], shape=b)))
                np.testing.assert_allclose(float(grid.sum()), sum_x, rtol=1e-6)


def bench_join(vt, cache, n, results):
    # HOST-resident fact table: the join's index build + probe are host
    # kernels (like the reference's RAM-resident config)
    m = 1_000_000
    rng = np.random.default_rng(5)
    fact = vt.from_arrays(key=rng.integers(0, m, n).astype(np.int64))
    dim = vt.from_arrays(key=np.arange(m, dtype=np.int64),
                         label=rng.integers(0, 100, m).astype(np.int64))
    fact._tile_rows = 1 << 24
    with cache.off():
        joined = _timed(results, "join_plan_1e8x1e6", n,
                        lambda: fact.join(dim, on="key"))
        # count over the joined column evaluates the lookup-gathered dim
        # column on the host (the lazy take / ColumnIndexed path)
        cnt = int(np.asarray(joined.count("label")))
        assert cnt == n  # every fact key exists in the dim table


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=float, default=1e8)
    parser.add_argument("suites", nargs="*", default=["isin", "binby", "join"])
    args = parser.parse_args()
    n = int(args.n)

    from benchmarks.device import announce
    device = announce()
    import vaex_tpu as vt
    from vaex_tpu import cache

    results = {}
    for suite in args.suites:
        {"isin": bench_isin, "binby": bench_binby, "join": bench_join}[
            suite](vt, cache, n, results)
    results["device"] = device
    print(json.dumps(results))


if __name__ == "__main__":
    main()
