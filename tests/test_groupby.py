"""GroupBy semantics (reference tests/groupby_test.py)."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt


def test_groupby_single_key_sum(df):
    dfg = df.groupby("g", agg={"x": "sum"}, sort=True)
    assert dfg["g"].tolist() == [0, 1, 2]
    npt.assert_allclose(dfg["x"].tolist(), [0 + 1 + 2 + 3, 4 + 5 + 6 + 7, 8 + 9])


def test_groupby_count(df):
    dfg = df.groupby("g", agg="count", sort=True)
    assert dfg["count"].tolist() == [4, 4, 2]


def test_groupby_agg_forms(df_local):
    df = df_local
    dfg = df.groupby("g", agg={"z": vt.agg.sum("x")}, sort=True)
    npt.assert_allclose(dfg["z"].tolist(), [6, 22, 17])
    dfg = df.groupby("g", agg=[vt.agg.sum("x")], sort=True)
    npt.assert_allclose(dfg["x_sum"].tolist(), [6, 22, 17])
    dfg = df.groupby("g", agg=[vt.agg.sum("x"), vt.agg.mean("x")], sort=True)
    assert "x_sum" in dfg.get_column_names()
    assert "x_mean" in dfg.get_column_names()
    dfg = df.groupby("g", agg={"z": [vt.agg.sum("x"), vt.agg.mean("x")]}, sort=True)
    assert "z_sum" in dfg.get_column_names()
    assert "z_mean" in dfg.get_column_names()


def test_groupby_string_key(df_local):
    df = df_local
    dfg = df.groupby("name", agg="count", sort=True)
    # names: n0 for x%3==0 (0,3,6,9), n1 (1,4,7), n2 (2,5,8)
    assert dfg["name"].tolist() == ["n0", "n1", "n2"]
    assert dfg["count"].tolist() == [4, 3, 3]


def test_groupby_missing_key(df_local):
    df = df_local
    dfg = df.groupby("m", agg="count", sort=True)
    # m: values 2..9 present once each; 2 missing -> null group last
    keys = dfg["m"].tolist()
    assert keys[-1] is None
    assert dfg["count"].tolist() == [1] * 8 + [2]


def test_groupby_nan_key(df_local):
    df = df_local
    dfg = df.groupby("f", agg="count", sort=True)
    keys = dfg["f"].tolist()
    assert np.isnan(keys[-1])
    assert dfg["count"].tolist() == [1] * 9 + [1]


def test_groupby_multi_key(df_local):
    df = df_local
    df2 = vt.from_arrays(
        a=np.array([0, 0, 1, 1, 0], dtype="i8"),
        b=np.array([0, 1, 0, 1, 0], dtype="i8"),
        v=np.arange(5, dtype="f8"),
    )
    dfg = df2.groupby(["a", "b"], agg={"v": "sum"}, sort=True)
    assert dfg["a"].tolist() == [0, 0, 1, 1]
    assert dfg["b"].tolist() == [0, 1, 0, 1]
    npt.assert_allclose(dfg["v"].tolist(), [0 + 4, 1, 2, 3])


def test_groupby_multi_key_sparse(df_local):
    # only observed combinations appear (reference groupby.py:488-529)
    df2 = vt.from_arrays(
        a=np.array([0, 0, 5, 5], dtype="i8"),
        b=np.array([1, 1, 9, 9], dtype="i8"),
    )
    dfg = df2.groupby(["a", "b"], agg="count", sort=True)
    assert len(dfg) == 2
    assert dfg["count"].tolist() == [2, 2]


def test_groupby_expression_key(df_local):
    df = df_local
    dfg = df.groupby("g * 2", agg="count", sort=True)
    assert len(dfg) == 3
    assert dfg["count"].tolist() == [4, 4, 2]


def test_groupby_row_limit(df_local):
    df = df_local
    with pytest.raises(vt.RowLimitException):
        df.groupby("x", row_limit=5)


def test_groupby_category(df_local):
    df = df_local.categorize("g", labels=[0, 1, 2])
    passes0 = df.executor.passes
    dfg = df.groupby("g", agg="count", sort=True)
    # category grouper needs no set-build pass: only the aggregation pass ran
    assert df.executor.passes == passes0 + 1
    assert dfg["count"].tolist() == [4, 4, 2]


def test_groupby_mean_min_max(df):
    dfg = df.groupby("g", agg={"mean": vt.agg.mean("x"), "mn": vt.agg.min("x"),
                               "mx": vt.agg.max("x")}, sort=True)
    npt.assert_allclose(dfg["mean"].tolist(), [1.5, 5.5, 8.5])
    npt.assert_allclose(dfg["mn"].tolist(), [0, 4, 8])
    npt.assert_allclose(dfg["mx"].tolist(), [3, 7, 9])


def test_groupby_nunique(df_local):
    df = df_local
    dfg = df.groupby("g", agg={"u": vt.agg.nunique("name")}, sort=True)
    # g=0 rows: names n0,n1,n2,n0 -> 3; g=1: n1,n2,n0,n1 -> 3; g=2: n2,n0 -> 2
    assert dfg["u"].tolist() == [3, 3, 2]


def test_groupby_iterator(df_local):
    df = df_local
    gb = df.groupby("g", sort=True)
    seen = {}
    for key, sub in gb:
        seen[key] = len(sub)
    assert seen == {0: 4, 1: 4, 2: 2}


def test_binby_agg(df_local):
    df = df_local
    result = df.binby("x", agg="count", limits=[[0, 10]], shape=5)
    npt.assert_array_equal(np.asarray(result), [2, 2, 2, 2, 2])


def test_binner_time():
    t = np.arange("2015-01-01", "2015-02-01", dtype="M8[D]")
    y = np.arange(len(t), dtype="f8")
    df = vt.from_arrays(t=t, y=y)
    by = vt.BinnerTime.per_week(df.t)
    dfg = df.groupby(by, agg={"y": "sum"})
    expected = [y[k * 7:(k + 1) * 7].sum() for k in range(5)]
    npt.assert_allclose(dfg["y"].tolist(), expected)


def test_groupby_string_device_codes(df_local):
    # to_device dictionary-encodes strings: groupby bins on device codes
    df = df_local.to_device()
    assert df.is_category("name")
    dfg = df.groupby("name", agg="count", sort=True)
    assert dfg["name"].tolist() == ["n0", "n1", "n2"]
    assert dfg["count"].tolist() == [4, 3, 3]


def test_groupby_string_device_codes_with_null():
    import pyarrow as pa
    df = vt.from_arrays(s=pa.array(["a", None, "b", "a"]), x=np.arange(4.0))
    df = df.to_device()
    dfg = df.groupby("s", agg={"c": "count"}, sort=True)
    keys = dfg["s"].tolist()
    assert keys[:2] == ["a", "b"]
    assert keys[2] is None
    assert dfg["c"].tolist() == [2, 1, 1]


def test_groupby_nunique_sorted_pairs(monkeypatch):
    """Large (cells x values) products ride OpNUniqueSorted (sorted distinct
    pairs) instead of the presence grid; results must be identical."""
    import vaex_tpu.agg as agg_module
    rng = np.random.default_rng(5)
    n = 20_000
    g = rng.integers(0, 50, n)
    v = rng.integers(0, 2_000, n)
    fv = np.where(rng.random(n) < 0.01, np.nan, v.astype(np.float64))
    df = vt.from_arrays(g=g, v=v, fv=fv)
    import pandas as pd
    pdf = pd.DataFrame({"g": g, "v": v, "fv": fv})
    want = pdf.groupby("g")["v"].nunique().to_numpy()
    want_f = pdf.groupby("g")["fv"].apply(lambda s: s.nunique(dropna=False)).to_numpy()
    want_f_dropnan = pdf.groupby("g")["fv"].nunique().to_numpy()

    out_presence = df.groupby("g", agg={"u": vt.agg.nunique("v")}, sort=True)
    npt.assert_array_equal(out_presence["u"].tolist(), want)

    monkeypatch.setattr(agg_module, "NUNIQUE_PRESENCE_MAX", 1)
    from vaex_tpu import cache
    cache.clear()
    out_sorted = df.groupby("g", agg={"u": vt.agg.nunique("v")}, sort=True)
    npt.assert_array_equal(out_sorted["u"].tolist(), want)
    out_f = df.groupby("g", agg={"u": vt.agg.nunique("fv")}, sort=True)
    npt.assert_array_equal(out_f["u"].tolist(), want_f)
    out_fd = df.groupby("g", agg={"u": vt.agg.nunique("fv", dropnan=True)}, sort=True)
    npt.assert_array_equal(out_fd["u"].tolist(), want_f_dropnan)

    # multi-tile: the sorted-pair state must merge correctly across tiles
    df._tile_rows = 1024
    cache.clear()
    out_tiled = df.groupby("g", agg={"u": vt.agg.nunique("v")}, sort=True)
    npt.assert_array_equal(out_tiled["u"].tolist(), want)


def test_combined_grouper_sorted_category_decode():
    """Sorted category groupers inside a combined key must decode labels in
    RAW ordinal order (regression: permuted bin_values gathered with raw
    ordinals misaligned keys and aggregates)."""
    import pandas as pd
    rng = np.random.default_rng(0)
    n = 5000
    labels1 = ["zed", "alpha", "mike"]   # unsorted -> sort_indices non-trivial
    labels2 = ["9", "2", "5", "7"]
    c1 = rng.integers(0, 3, n)
    c2 = rng.integers(0, 4, n)
    v = rng.random(n)
    df = (vt.from_arrays(a=c1, b=c2, v=v)
          .categorize("a", labels=labels1).categorize("b", labels=labels2))
    out = df.groupby(["a", "b"], agg={"s": vt.agg.sum("v")}, sort=True,
                     assume_sparse=True).to_pandas_df()
    s1 = np.array(labels1, object)[c1]
    s2 = np.array(labels2, object)[c2]
    want = (pd.DataFrame({"a": s1, "b": s2, "v": v})
            .groupby(["a", "b"], as_index=False)["v"].sum()
            .sort_values(["a", "b"]).reset_index(drop=True))
    npt.assert_array_equal(out["a"].to_numpy(), want["a"].to_numpy())
    npt.assert_array_equal(out["b"].to_numpy(), want["b"].to_numpy())
    npt.assert_allclose(out["s"].to_numpy(), want["v"].to_numpy(), rtol=1e-9)


def test_groupby_dense_rank_strategy():
    """Set-based groupers with mid/high cardinality ride the dense-rank sort
    strategy (raw-key sort, no ordinal probe); exactness and edge semantics
    must match the generic paths."""
    import pandas as pd
    rng = np.random.default_rng(9)
    n, k = 60_000, 5_000     # G=5000 > CPU kernel max 2048 -> sort regime
    # sparse negative keys: span > DENSE_RANGE_MAX forces the set-based
    # grouper whose binner carries dense_rank=True
    keys = rng.integers(-1000, k, n) * 1009
    iv = rng.integers(-2**62, 2**62, n, dtype=np.int64)
    fv = rng.normal(0, 100, n)
    df = vt.from_arrays(g=keys, iv=iv, fv=fv)
    out = df.groupby("g", agg={"s": vt.agg.sum("iv"), "f": vt.agg.sum("fv"),
                               "mn": vt.agg.min("fv"), "mx": vt.agg.max("fv"),
                               "m": vt.agg.mean("fv"), "c": "count"}, sort=True)
    pdf = pd.DataFrame({"g": keys, "iv": iv, "fv": fv})
    want = pdf.groupby("g").agg(s=("iv", "sum"), f=("fv", "sum"), mn=("fv", "min"),
                                mx=("fv", "max"), m=("fv", "mean"), c=("fv", "size"))
    npt.assert_array_equal(out["g"].tolist(), want.index.to_numpy())
    npt.assert_array_equal(np.asarray(out["s"].tolist()), want["s"].to_numpy())
    npt.assert_array_equal(out["c"].tolist(), want["c"].to_numpy())
    npt.assert_allclose(out["f"].tolist(), want["f"].to_numpy(), rtol=1e-9)
    npt.assert_allclose(out["mn"].tolist(), want["mn"].to_numpy())
    npt.assert_allclose(out["mx"].tolist(), want["mx"].to_numpy())
    npt.assert_allclose(out["m"].tolist(), want["m"].to_numpy(), rtol=1e-9)

    # with a filter: invalid rows sort past every real segment
    dff = df[df["fv"] > 0]
    outf = dff.groupby("g", agg={"c": "count", "f": vt.agg.sum("fv")}, sort=True)
    wantf = pdf[pdf.fv > 0].groupby("g").agg(c=("fv", "size"), f=("fv", "sum"))
    npt.assert_array_equal(outf["g"].tolist(), wantf.index.to_numpy())
    npt.assert_array_equal(outf["c"].tolist(), wantf["c"].to_numpy())
    npt.assert_allclose(outf["f"].tolist(), wantf["f"].to_numpy(), rtol=1e-9)

    # with a selection on one agg
    outs = df.groupby("g", agg={"cs": vt.agg.count(selection="fv > 0")}, sort=True)
    wants = pdf.assign(p=pdf.fv > 0).groupby("g")["p"].sum()
    npt.assert_array_equal(outs["cs"].tolist(), wants.to_numpy())


def test_shuffle_nat_treated_as_missing():
    """Datetime NaT (int64 min) must be skipped by min/max like pandas
    (advisor r3 low: the shuffle route treated NaT as a valid value)."""
    import pandas as pd
    import vaex_tpu as vt
    rng = np.random.default_rng(5)
    n = 3000
    k = rng.integers(0, 3, n).astype("i8")
    t = (np.datetime64("2020-01-01") +
         rng.integers(0, 10**6, n).astype("m8[s]"))
    t[::7] = np.datetime64("NaT")
    df = vt.from_arrays(k=k, t=t)
    out = df.groupby("k", agg={"mn": vt.agg.min("t"), "mx": vt.agg.max("t")},
                     sort=True)
    oracle = pd.DataFrame({"k": k, "t": t}).groupby("k")["t"].agg(["min", "max"])
    npt.assert_array_equal(np.asarray(out["mn"].tolist()).astype("M8[s]"),
                           oracle["min"].to_numpy().astype("M8[s]"))
    npt.assert_array_equal(np.asarray(out["mx"].tolist()).astype("M8[s]"),
                           oracle["max"].to_numpy().astype("M8[s]"))


def test_binner_time_stable_column_name():
    """BinnerTime's hidden column name must be deterministic across
    processes (state round-trips)."""
    import subprocess
    import sys
    code = (
        "import numpy as np, vaex_tpu as vt\n"
        "from vaex_tpu.groupby import BinnerTime\n"
        "t = np.datetime64('2021-01-01') + np.arange(100).astype('m8[D]')\n"
        "df = vt.from_arrays(t=t)\n"
        "b = BinnerTime(df.t, resolution='W', df=df)\n"
        "print(b.binby_expression)\n"
    )
    outs = set()
    for _ in range(2):
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, env={**__import__('os').environ,
                                           "JAX_PLATFORMS": "cpu",
                                           "PYTHONHASHSEED": "random"})
        assert r.returncode == 0, r.stderr
        outs.add(r.stdout.strip())
    assert len(outs) == 1, f"column name differs across processes: {outs}"
