"""Aggregation semantics vs numpy oracles (reference tests/agg_test.py).

NaN/null contract (SURVEY §2.4): count(expr) counts values neither NaN nor
missing; count('*')/count() counts rows; sum skips NaN and null; min/max skip
NaN; integer aggregates exact, float to tolerance.
"""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt


X = np.arange(10, dtype="f8")


def test_count_star(df):
    assert df.count() == 10


def test_count_column(df):
    assert df.count("x") == 10
    assert df.count("m") == 8          # 2 missing
    assert df.count("f") == 9          # 1 NaN


def test_sum(df):
    assert df.sum("x") == X.sum()
    assert df.sum("m") == X[2:].sum()      # missing skipped
    assert df.sum("f") == X[:-1].sum()     # nan skipped
    assert df.sum("i") == 45
    assert np.asarray(df.sum("i")).dtype == np.int64  # upcast contract


def test_mean(df):
    npt.assert_allclose(df.mean("x"), X.mean())
    npt.assert_allclose(df.mean("m"), X[2:].mean())
    npt.assert_allclose(df.mean("f"), X[:-1].mean())


def test_minmax(df):
    assert df.min("x") == 0
    assert df.max("x") == 9
    assert df.min("m") == 2.0          # masked skipped
    assert df.max("f") == 8.0          # nan skipped
    npt.assert_array_equal(df.minmax("x"), [0.0, 9.0])


def test_std_var(df):
    npt.assert_allclose(df.std("x"), X.std())
    npt.assert_allclose(df.var("x"), X.var())
    npt.assert_allclose(df.std("x", ddof=1), X.std(ddof=1))


def test_binby_count(df):
    counts = df.count(binby=["x"], limits=[[0, 10]], shape=5)
    npt.assert_array_equal(counts, [2, 2, 2, 2, 2])


def test_binby_limits_auto(df):
    # limits=None triggers a minmax pre-pass; the reference's edge contract
    # (superagg_binners.cpp:42-52) sends v == vmax to the overflow bin, which
    # is stripped — so the max row is lost with minmax limits (the reference's
    # own test compares only counts[:-1], tests/count_test.py:27-44)
    counts = df.count(binby=["x"], shape=2)
    assert counts.sum() == 9
    counts2 = df.count(binby=["x"], limits=[[0, 9.5]], shape=2)
    assert counts2.sum() == 10


def test_binby_2d(df):
    grid = df.count(binby=["x", "y"], limits=[[0, 10], [0, 100]], shape=[2, 2])
    assert grid.shape == (2, 2)
    assert grid.sum() == 10


def test_binby_sum(df):
    sums = df.sum("y", binby=["x"], limits=[[0, 10]], shape=2)
    npt.assert_allclose(sums, [np.sum(X[:5] ** 2), np.sum(X[5:] ** 2)])


def test_binby_mean_empty_bins(df):
    means = df.mean("y", binby=["x"], limits=[[20, 30]], shape=2)
    assert np.isnan(means).all()


def test_selection_agg(df):
    assert df.count("x", selection="x > 4") == 5
    assert df.sum("x", selection="x > 4") == X[X > 4].sum()
    # list of selections -> leading axis
    counts = df.count("x", selection=["x > 4", "x > 8"])
    npt.assert_array_equal(counts, [5, 1])


def test_selection_named(df):
    df.select("x > 4")
    assert df.count("x", selection=True) == 5


def test_count_binby_edges(df):
    counts = df.count(binby=["f"], limits=[[0, 8]], shape=4, edges=True)
    # +3 layout: [nan, underflow, d0, d1, d2, d3, overflow]
    assert counts.shape == (7,)
    assert counts[0] == 1          # the NaN row
    assert counts[1] == 0          # underflow
    assert counts[-1] == 1         # f == 8 -> == vmax -> overflow
    assert counts[2:-1].sum() == 8


def test_first(df):
    v = df.first("y", "x")
    assert v == 0.0
    v = df.first("y", "-x")
    assert v == 81.0


def test_agg_expression(df):
    assert df.sum("x + y") == np.sum(X + X ** 2)
    npt.assert_allclose(df.mean("x * 2 + 1"), np.mean(X * 2 + 1))


def test_delayed_merging(df_local):
    df = df_local
    passes0 = df.executor.passes
    s = df.sum("x", delay=True)
    m = df.mean("y", delay=True)
    c = df.count(delay=True)
    df.execute()
    assert df.executor.passes == passes0 + 1  # one fused pass
    assert s.get() == X.sum()
    npt.assert_allclose(m.get(), (X ** 2).mean())
    assert c.get() == 10


def test_datetime_ops(df_local):
    t = np.arange("2015-01-01", "2015-01-11", dtype="M8[D]")
    df = vt.from_arrays(t=t, y=np.arange(10.0))
    assert df.count("t") == 10
    years = df.evaluate("dt_year(t)")
    npt.assert_array_equal(np.asarray(years), [2015] * 10)


def test_binby_large_grid(df_local):
    # exercises the sort-based high-cardinality strategy (G > 2048)
    df = vt.from_arrays(x=np.arange(10000, dtype="f8"),
                        k=np.arange(10000, dtype="i8") % 5000)
    df = df.categorize("k", labels=list(range(5000)))
    counts = df.count(binby=["k"])
    assert counts.sum() == 10000
    sums = df.sum("x", binby=["k"])
    npt.assert_allclose(sums.sum(), np.arange(10000.0).sum())
    npt.assert_allclose(sums[0], 0 + 5000)
    mins = df.min("x", binby=["k"])
    npt.assert_allclose(mins[1], 1.0)
    maxs = df.max("x", binby=["k"])
    npt.assert_allclose(maxs[4999], 9999.0)


def test_int64_sum_exact_beyond_f64(df_local):
    """Integer sums past 2^53 are exact (limb path; reference int64 C++
    accumulation is exact, superagg.cpp:350)."""
    import vaex_tpu as vt
    n = 20000
    big = (1 << 60) + 12345  # not representable in f64
    k = np.arange(n, dtype=np.int64) % 3000  # G=3000 > 2048 -> sort path on CPU
    v = np.full(n, big, dtype=np.int64)
    v[::7] = -((1 << 59) + 991)
    df = vt.from_dict({"k": k * 5 + 1, "v": v})
    out = df.groupby(["k"], agg={"v": "sum"}, sort=True).to_pandas_df()
    oracle = {}
    for kk, vv in zip(k * 5 + 1, v):
        oracle[kk] = np.int64(oracle.get(kk, np.int64(0)) + vv)  # wraparound semantics
    keys = sorted(oracle)
    npt.assert_array_equal(out["k"].to_numpy(), keys)
    npt.assert_array_equal(out["v"].to_numpy(), [oracle[kk] for kk in keys])


def test_uint64_sum_exact(df_local):
    import vaex_tpu as vt
    n = 9000
    k = np.arange(n, dtype=np.int64) % 2500
    v = np.full(n, (1 << 62) + 7, dtype=np.uint64)
    df = vt.from_dict({"k": k * 3, "v": v})
    out = df.groupby(["k"], agg={"v": "sum"}, sort=True).to_pandas_df()
    with np.errstate(over="ignore"):
        oracle = np.zeros(2500, np.uint64)
        np.add.at(oracle, k, v)
    npt.assert_array_equal(out["v"].to_numpy().astype(np.uint64), oracle)


def test_sum_value_bound_exact():
    # minmax-informed limb shrinking must stay exact across value ranges
    import vaex_tpu as vt
    rng = np.random.default_rng(11)
    n = 20000
    for lo, hi in [(1, 6), (0, 300), (-5, 5), (-70000, 70000), (2**40, 2**40 + 9)]:
        k = rng.integers(0, 5000, n).astype(np.int64)
        v = rng.integers(lo, hi + 1, n).astype(np.int64)
        df = vt.from_arrays(k=k, v=v)
        out = df.groupby("k", agg={"v": "sum"}, sort=True)
        import pandas as pd
        oracle = pd.DataFrame({"k": k, "v": v}).groupby("k")["v"].sum().sort_index()
        np.testing.assert_array_equal(np.asarray(out["v"].values, np.int64),
                                      oracle.to_numpy())


def test_minmax_huge_f32_values_big_grid():
    """ADVICE r2 (medium): f32 values near/above 2^126 (inf, 3.4e38 fills)
    must not ride the partition kernel's finite-sentinel extreme path."""
    import vaex_tpu as vt
    n = 50_000
    k = np.arange(n, dtype="i8")  # dense grouper, G > PARTITION_MIN_G
    x = np.ones(n, dtype="f4")
    x[7] = np.float32(3.4e38)
    x[11] = np.inf
    x[13] = -np.inf
    df = vt.from_arrays(k=k, x=x)
    out = df.groupby("k", agg={"mn": vt.agg.min("x"), "mx": vt.agg.max("x")})
    mn = np.asarray(out["mn"].tolist())
    mx = np.asarray(out["mx"].tolist())
    assert mx[7] == np.float32(3.4e38)
    assert np.isposinf(mx[11])
    assert np.isneginf(mn[13])
    assert mn[0] == 1.0 and mx[0] == 1.0


def test_minmax_bounded_f32_partition_gate():
    """Float min/max with a proven small bound still aggregates correctly
    over a big grid (the partition fast path may engage)."""
    import vaex_tpu as vt
    rng = np.random.default_rng(3)
    n = 60_000
    k = rng.integers(0, 40_000, n).astype("i8")
    x = rng.random(n).astype("f4") * 100
    df = vt.from_arrays(k=k, x=x)
    out = df.groupby("k", agg={"mn": vt.agg.min("x"), "mx": vt.agg.max("x")}, sort=True)
    import pandas as pd
    oracle = pd.DataFrame({"k": k, "x": x}).groupby("k").agg(mn=("x", "min"), mx=("x", "max"))
    npt.assert_array_equal(np.asarray(out["mn"].tolist()), oracle["mn"].to_numpy())
    npt.assert_array_equal(np.asarray(out["mx"].tolist()), oracle["mx"].to_numpy())


def test_wire_narrowing_streamed_category():
    """Proven-int32 wire narrowing (execution.py): an int64 categorical key
    streamed in multiple tiles ships as i32 and widens back on device —
    results identical to the unnarrowed path."""
    import vaex_tpu as vt
    rng = np.random.default_rng(8)
    n = 30_000
    k = rng.integers(0, 50, n).astype("i8")
    x = rng.random(n)
    df = vt.from_arrays(i1=k, x=x).categorize("i1", labels=list(range(50)))
    df._tile_rows = 4096  # force multi-tile streaming
    out = df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    oracle_c = np.bincount(k, minlength=50)
    oracle_s = np.bincount(k, weights=x, minlength=50)
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle_c)
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle_s, rtol=1e-9)
    # arithmetic on the narrowed column must still behave as int64
    big = df.sum("i1 * 100000000")  # would overflow int32 without widening
    assert int(big) == int((k.astype("i8") * 100000000).sum())


def test_wire_narrowing_skipped_under_filter():
    """A memoized minmax on a FILTERED df must not drive wire narrowing:
    raw tiles stream unfiltered rows whose values can exceed int32 and wrap,
    wrongly passing the on-device filter (advisor r3 high)."""
    import vaex_tpu as vt
    n = 20_000
    k = np.zeros(n, dtype="i8")
    k[0] = (1 << 32) + 7  # wraps to 7 on a narrowed int32 wire
    x = np.ones(n)
    df = vt.from_arrays(id=k, x=x)
    dff = df[df.id < 1000]
    dff._tile_rows = 4096  # force multi-tile streaming
    # seed the minmax memo the way a prior big-grid sum pre-pass would
    dff._int_value_bound("id")
    out = dff.groupby("id", agg={"c": "count"}, sort=True)
    counts = np.asarray(out["c"].tolist())
    assert counts.sum() == n - 1  # the 2^32+7 row must stay filtered out


def test_exact_percentile_inf_groups():
    """A group whose bracketing order statistics are both +inf must return
    inf (pandas), not inf + 0*(inf-inf) = NaN (advisor r3 low)."""
    import vaex_tpu as vt
    k = np.array([0, 0, 1, 1], dtype="i8")
    x = np.array([np.inf, np.inf, 1.0, 3.0])
    df = vt.from_arrays(k=k, x=x)
    out = df.groupby("k", agg={"m": vt.agg.median("x")}, sort=True)
    med = np.asarray(out["m"].tolist())
    assert np.isinf(med[0]) and med[0] > 0
    npt.assert_allclose(med[1], 2.0)


def test_exact_percentile_streams_across_tiles():
    """exact percentile no longer needs the pass in one tile —
    tiles collect (cell, value) pairs and finalize runs one sort.  Forcing a
    tiny tile makes the pass present many tiles; the median must still match
    pandas to 1e-9 (the approx op's tolerance is ~0.35 here)."""
    import pandas as pd
    rng = np.random.default_rng(3)
    n = 10_000
    k = rng.integers(0, 37, n).astype("i8")
    x = rng.normal(0, 100, n)
    x[rng.random(n) < 0.05] = np.nan
    df = vt.from_arrays(k=k, x=x)
    df._tile_rows = 512                     # 20 tiles
    out = df.groupby("k", agg={"m": vt.agg.median("x")}, sort=True)
    oracle = pd.DataFrame({"k": k, "x": x}).groupby("k")["x"].median()
    npt.assert_allclose(np.asarray(out["m"].tolist()), oracle.to_numpy(),
                        rtol=1e-12, atol=1e-12)


def test_exact_percentile_streams_multi_pct():
    rng = np.random.default_rng(4)
    n = 3_000
    k = rng.integers(0, 11, n).astype("i8")
    x = rng.random(n) * 1000
    df = vt.from_arrays(k=k, x=x)
    df._tile_rows = 256
    out = df.groupby("k", agg={
        "p25": vt.agg.percentile_approx("x", 25, percentile_shape=None),
        "p90": vt.agg.percentile_approx("x", 90, percentile_shape=None)}, sort=True)
    import pandas as pd
    g = pd.DataFrame({"k": k, "x": x}).groupby("k")["x"]
    npt.assert_allclose(np.asarray(out["p25"].tolist()),
                        g.quantile(0.25).to_numpy(), rtol=1e-12)
    npt.assert_allclose(np.asarray(out["p90"].tolist()),
                        g.quantile(0.90).to_numpy(), rtol=1e-12)


def test_wire_narrowing_f32_exact_values():
    """f64 value columns whose raw values are PROVEN exactly
    f32-representable ship as f32 after the first (checking) pass — lossless
    — while non-exact columns never narrow."""
    rng = np.random.default_rng(12)
    n = 5_000
    k = rng.integers(0, 10, n).astype("i8")
    exact = rng.random(n).astype("f4").astype("f8")    # f32-exact f64
    exact[::7] = np.nan                                 # NaN survives narrowing
    lossy = rng.random(n)                               # full f64 mantissas
    df = vt.from_arrays(k=k, exact=exact, lossy=lossy)
    df = df.categorize("k", labels=list(range(10)))
    df._tile_rows = 512
    from vaex_tpu import cache
    import pandas as pd
    oracle = pd.DataFrame({"k": k, "e": exact, "l": lossy}).groupby("k").agg(
        se=("e", "sum"), sl=("l", "sum"))
    with cache.off():
        out1 = df.groupby("k", agg={"se": vt.agg.sum("exact"),
                                    "sl": vt.agg.sum("lossy")}, sort=True)
        memo = df.executor._f32_exact_memo
        states = {name: memo.get((df.fingerprint(), name))
                  for name in ("exact", "lossy")}
        assert states["exact"] is True and states["lossy"] is False, states
        out2 = df.groupby("k", agg={"se": vt.agg.sum("exact"),
                                    "sl": vt.agg.sum("lossy")}, sort=True)
    for out in (out1, out2):
        npt.assert_allclose(np.asarray(out["se"].tolist()),
                            oracle["se"].to_numpy(), rtol=1e-9)
        npt.assert_allclose(np.asarray(out["sl"].tolist()),
                            oracle["sl"].to_numpy(), rtol=1e-9)


def test_extreme_fast_dtype_coverage():
    """extreme_packed (f32/ints<=32bit, exact order-map bijection) and
    extreme_lex2 (f64/i64 wide values) against numpy oracles at G>512
    (the high-G sort route)."""
    import jax
    import jax.numpy as jnp
    from vaex_tpu.ops import gridagg

    rng = np.random.default_rng(2)
    n, g = 20_000, 700
    idx = jnp.asarray(rng.integers(0, g, n).astype(np.int32))
    idx_np = np.asarray(idx)

    cases = [
        rng.normal(0, 100, n).astype(np.float32),
        rng.integers(-(2**31), 2**31, n).astype(np.int32),
        rng.integers(-30000, 30000, n).astype(np.int16),
        rng.integers(0, 250, n).astype(np.uint8),
        rng.normal(0, 100, n),                      # f64 -> lex2
        rng.integers(-(2**60), 2**60, n),           # i64 -> lex2
    ]
    for col in cases:
        for mode, op, fill in (("min", np.minimum, gridagg.min_identity(col.dtype)),
                               ("max", np.maximum, gridagg.max_identity(col.dtype))):
            oracle = np.full(g, fill, col.dtype)
            getattr(np, mode + "imum").at(oracle, idx_np, col)
            out = np.asarray(jax.jit(
                lambda i, c, m=mode: gridagg.extreme_fast(i, c, g, m))(
                    idx, jnp.asarray(col)))
            np.testing.assert_array_equal(out, oracle, err_msg=f"{col.dtype} {mode}")
