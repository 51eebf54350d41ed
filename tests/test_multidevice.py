"""SPMD execution over the 8-virtual-device CPU mesh — the stand-in for a
pod slice (SURVEY §4: single-process multi-device simulation replaces the
reference's in-process websocket server trick)."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt


@pytest.fixture
def dist_df():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import distributed_executor
    df = vt.from_arrays(
        x=np.arange(100, dtype="f8"),
        g=np.arange(100, dtype="i8") % 7,
        m=np.ma.MaskedArray(np.arange(100, dtype="f8"), np.arange(100) < 5),
    )
    df.executor = distributed_executor()
    df._tile_rows = 16
    return df


def test_spmd_stats(dist_df):
    df = dist_df
    X = np.arange(100.0)
    assert df.count() == 100
    assert df.sum("x") == X.sum()
    npt.assert_allclose(df.mean("x"), X.mean())
    assert df.min("x") == 0 and df.max("x") == 99
    assert df.count("m") == 95
    npt.assert_allclose(df.std("x"), X.std())


def test_spmd_groupby(dist_df):
    df = dist_df
    X = np.arange(100.0)
    dfg = df.groupby("g", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    expected = [X[np.arange(100) % 7 == k].sum() for k in range(7)]
    npt.assert_allclose(dfg["s"].tolist(), expected)
    assert sum(dfg["c"].tolist()) == 100


def test_spmd_filter(dist_df):
    df = dist_df.filter("x >= 50")
    assert len(df) == 50
    assert df.sum("x") == np.arange(50, 100).sum()


def test_spmd_binby(dist_df):
    counts = dist_df.count(binby=["x"], limits=[[0, 100]], shape=10)
    npt.assert_array_equal(counts, [10] * 10)


def test_spmd_first(dist_df):
    assert dist_df.first("x", "-x") == 99.0


def test_spmd_evaluate(dist_df):
    values = np.asarray(dist_df.evaluate("x * 2"))
    npt.assert_allclose(values, np.arange(100.0) * 2)


def test_spmd_matches_single_device(dist_df):
    df_single = vt.from_arrays(x=np.arange(100, dtype="f8"),
                               g=np.arange(100, dtype="i8") % 7)
    for sel in [None, "x > 30"]:
        a = dist_df.sum("x", selection=sel or False)
        b = df_single.sum("x", selection=sel or False)
        assert a == b


def test_shuffle_groupby():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import data_mesh
    from vaex_tpu.parallel.shuffle import shuffle_groupby

    N, G = 10000, 1000
    rng = np.random.default_rng(0)
    keys = rng.integers(0, G, N)
    x = rng.random(N)
    df = vt.from_arrays(k=keys.astype("i8"), x=x)
    mesh = data_mesh()
    out = shuffle_groupby(df, "astype(k, 'int32')", ["x"], G, mesh)
    npt.assert_array_equal(out["count"], np.bincount(keys, minlength=G))
    npt.assert_allclose(out["x"], np.bincount(keys, weights=x, minlength=G), rtol=1e-9)


def test_shuffle_overflow_detection():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import data_mesh
    from vaex_tpu.parallel.shuffle import shuffle_groupby

    # all rows share one key -> every row goes to one device: must overflow
    # at low slack and raise when retries are disabled
    N, G = 4096, 64
    df = vt.from_arrays(k=np.zeros(N, "i8"), x=np.ones(N))
    mesh = data_mesh()
    with pytest.raises(RuntimeError):
        shuffle_groupby(df, "astype(k, 'int32')", ["x"], G, mesh, slack=1,
                        max_retries=0)
    # the default slack-doubling retry absorbs the skew automatically
    out = shuffle_groupby(df, "astype(k, 'int32')", ["x"], G, mesh, slack=1)
    assert out["count"][0] == N


def test_shuffle_join_lookup():
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import data_mesh
    from vaex_tpu.parallel.join import shuffle_join_lookup

    mesh = data_mesh()
    rng = np.random.default_rng(0)
    rk = rng.permutation(997).astype(np.int64) * 3
    lk = rng.integers(0, 4000, 5000).astype(np.int64)
    lookup, overflow, dups = shuffle_join_lookup(mesh, lk, rk)
    assert overflow == 0 and dups == 0
    key_to_row = {k: i for i, k in enumerate(rk.tolist())}
    want = np.array([key_to_row.get(k, -1) for k in lk.tolist()], np.int64)
    npt.assert_array_equal(np.asarray(lookup), want)


def test_mesh_join_end_to_end():
    """df.join over the distributed executor's mesh matches the local join."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import data_mesh

    mesh = data_mesh()
    rng = np.random.default_rng(1)
    n = 2000
    left = vt.from_arrays(k=rng.integers(0, 500, n).astype(np.int64),
                          a=rng.random(n))
    right = vt.from_arrays(k=(np.arange(400, dtype=np.int64)),
                           b=np.arange(400, dtype="f8") * 10)
    out_mesh = left.join(right, on="k", mesh=mesh)
    out_local = left.join(right, on="k")
    npt.assert_array_equal(out_mesh["k"].tolist(), out_local["k"].tolist())
    bm = out_mesh.evaluate("b", array_type="numpy")
    bl = out_local.evaluate("b", array_type="numpy")
    npt.assert_array_equal(np.ma.filled(bm, np.nan), np.ma.filled(bl, np.nan))
    # duplicate right keys without allow_duplication still raise through the mesh path
    right_dup = vt.from_arrays(k=np.array([1, 1, 2], dtype=np.int64),
                               b=np.array([1.0, 2.0, 3.0]))
    with pytest.raises(ValueError):
        left.join(right_dup, on="k", mesh=mesh)


def test_groupby_auto_shuffle_route(monkeypatch):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)  # force the shuffle route
    rng = np.random.default_rng(5)
    n = 4000
    k = rng.integers(0, 300, n).astype("i8") * 7  # non-dense keys -> set grouper
    x = rng.random(n)
    v = rng.integers(1, 6, n).astype("i8")
    df = vt.from_arrays(k=k, x=x, v=v)
    df.executor = distributed_executor()
    out = df.groupby("k", agg={"s": vt.agg.sum("x"), "c": "count",
                               "m": vt.agg.mean("x"), "vs": vt.agg.sum("v")},
                     sort=True)
    import pandas as pd
    oracle = pd.DataFrame({"k": k, "x": x, "v": v}).groupby("k").agg(
        s=("x", "sum"), c=("x", "size"), m=("x", "mean"), vs=("v", "sum"))
    npt.assert_array_equal(np.asarray(out["k"].tolist()), oracle.index.to_numpy())
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(), rtol=1e-9)
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    npt.assert_allclose(np.asarray(out["m"].tolist()), oracle["m"].to_numpy(), rtol=1e-9)
    npt.assert_array_equal(np.asarray(out["vs"].tolist()), oracle["vs"].to_numpy())


def test_spmd_whole_pass_device_resident():
    """Device-resident frames under a mesh ride the SPMD whole-pass
    fori_loop (one dispatch, per-device tile loops, collective merges)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import distributed_executor
    n = 1000
    x = np.arange(n, dtype="f8")
    g = (np.arange(n) % 7).astype("i8")
    df = vt.from_arrays(x=x, g=g).to_device()
    df.executor = distributed_executor()
    df._tile_rows = 256
    assert df.count() == n
    assert float(np.asarray(df.sum("x"))) == x.sum()
    assert float(np.asarray(df.min("x"))) == 0.0
    assert float(np.asarray(df.max("x"))) == n - 1
    assert df.executor.whole_passes >= 1  # took the fused path
    out = df.groupby("g", agg={"s": vt.agg.sum("x"), "c": "count",
                               "mn": vt.agg.min("x")}, sort=True)
    import pandas as pd
    oracle = pd.DataFrame({"x": x, "g": g}).groupby("g").agg(
        s=("x", "sum"), c=("x", "size"), mn=("x", "min"))
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy())
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    npt.assert_allclose(np.asarray(out["mn"].tolist()), oracle["mn"].to_numpy())
    # first (order-sensitive): global row ids must be right across shards
    assert float(np.asarray(df.first("x", "-x"))) == n - 1


@pytest.mark.parametrize("n", [1000, 1003])
def test_to_device_under_mesh_shards_rows(n):
    """to_device() under a distributed executor splits the rows over the
    mesh (when they divide evenly) and the whole pass reads them in place:
    shard-local tile padding must not count as rows."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import distributed_executor
    x = np.arange(n, dtype="f8")
    g = (np.arange(n) % 7).astype("i8")
    df = vt.from_arrays(x=x, g=g)
    df.executor = distributed_executor()
    df = df.to_device()
    D = df.executor.mesh.size
    col = df.dataset.device_columns(["x"])["x"]
    shard_rows = sorted({s.data.shape[0] for s in col.addressable_shards})
    assert shard_rows == ([n // D] if n % D == 0 else [n])
    df._tile_rows = 256
    assert df.count() == n
    assert float(np.asarray(df.sum("x"))) == x.sum()
    assert float(np.asarray(df.max("x"))) == n - 1
    assert float(np.asarray(df.first("x", "-x"))) == n - 1
    assert df.executor.whole_passes >= 1
    out = df.groupby("g", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    npt.assert_allclose(np.asarray(out["s"].tolist()),
                        np.bincount(g, weights=x, minlength=7))
    npt.assert_array_equal(np.asarray(out["c"].tolist()), np.bincount(g, minlength=7))


def test_shuffle_route_descending_sort(monkeypatch):
    """ADVICE r2 (high): keys must pair with the right groups' aggregates on
    the shuffle route when sort order permutes bin_values (descending)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    rng = np.random.default_rng(11)
    n = 3000
    k = rng.integers(0, 200, n).astype("i8") * 3 + 1  # set grouper
    x = rng.random(n)
    df = vt.from_arrays(k=k, x=x)
    df.executor = distributed_executor()
    out = df.groupby("k", agg={"s": vt.agg.sum("x")}, sort=True, ascending=False)
    import pandas as pd
    oracle = (pd.DataFrame({"k": k, "x": x}).groupby("k").agg(s=("x", "sum"))
              .sort_index(ascending=False))
    npt.assert_array_equal(np.asarray(out["k"].tolist()), oracle.index.to_numpy())
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(), rtol=1e-9)


def test_groupby_agg_delay_returns_promise(monkeypatch):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    n = 500
    k = (np.arange(n, dtype="i8") % 40) * 3
    df = vt.from_arrays(k=k, x=np.ones(n))
    df.executor = distributed_executor()
    p = df.groupby("k").agg({"s": vt.agg.sum("x")}, delay=True)
    assert hasattr(p, "get")
    out = p.get()
    assert len(out) == 40


def test_shuffle_full_agg_surface(monkeypatch):
    """min/max/std/var/nunique through the shuffle at G=1e5
    match the single-device path bit-for-bit (ints) / 1e-9 (floats)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    rng = np.random.default_rng(21)
    n = 100_000
    G = 100_000
    k = rng.integers(0, G, n).astype("i8") * 2 + 1  # sparse -> set grouper
    x = rng.normal(0, 10, n)
    v = rng.integers(-1000, 1000, n).astype("i8")
    w = rng.integers(0, 5, n).astype("i4")
    big = rng.integers(-(2**62), 2**62, n).astype("i8")  # f64-lossy values
    agg = {"mn": vt.agg.min("x"), "mx": vt.agg.max("x"),
           "vmn": vt.agg.min("v"), "vmx": vt.agg.max("v"),
           "bmn": vt.agg.min("big"), "bmx": vt.agg.max("big"),
           "sd": vt.agg.std("x"), "vr": vt.agg.var("x"),
           "nu": vt.agg.nunique("w"), "s": vt.agg.sum("v"), "c": "count"}
    df1 = vt.from_arrays(k=k, x=x, v=v, w=w, big=big)
    single = df1.groupby("k", agg=agg, sort=True)

    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    df2 = vt.from_arrays(k=k, x=x, v=v, w=w, big=big)
    df2.executor = distributed_executor()
    routed = df2.groupby("k", agg=agg, sort=True)

    npt.assert_array_equal(np.asarray(routed["k"].tolist()), np.asarray(single["k"].tolist()))
    for c in ("vmn", "vmx", "bmn", "bmx", "nu", "s", "c"):
        npt.assert_array_equal(np.asarray(routed[c].tolist()), np.asarray(single[c].tolist()),
                               err_msg=c)
    for c in ("mn", "mx"):
        npt.assert_array_equal(np.asarray(routed[c].tolist()), np.asarray(single[c].tolist()),
                               err_msg=c)
    for c in ("sd", "vr"):
        npt.assert_allclose(np.asarray(routed[c].tolist()), np.asarray(single[c].tolist()),
                            rtol=1e-9, atol=1e-12, err_msg=c)


def test_shuffle_selection_and_nulls(monkeypatch):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    rng = np.random.default_rng(5)
    n = 20_000
    k = rng.integers(0, 2000, n).astype("i8") * 3
    x = rng.normal(0, 1, n)
    x[::7] = np.nan
    m = np.ma.MaskedArray(rng.integers(0, 9, n).astype("f8"), rng.random(n) < 0.1)
    agg = {"s": vt.agg.sum("x", selection="x > 0"),
           "c": vt.agg.count("x", selection="x > 0"),
           "mn": vt.agg.min("x", selection="x > 0"),
           "nu": vt.agg.nunique("m"),
           "nud": vt.agg.nunique("m", dropmissing=True)}
    df1 = vt.from_arrays(k=k, x=x, m=m)
    single = df1.groupby("k", agg=agg, sort=True)
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    df2 = vt.from_arrays(k=k, x=x, m=m)
    df2.executor = distributed_executor()
    routed = df2.groupby("k", agg=agg, sort=True)
    npt.assert_array_equal(np.asarray(routed["k"].tolist()), np.asarray(single["k"].tolist()))
    npt.assert_allclose(np.asarray(routed["s"].tolist()), np.asarray(single["s"].tolist()),
                        rtol=1e-9, atol=1e-12)
    for c in ("c", "nu", "nud"):
        npt.assert_array_equal(np.asarray(routed[c].tolist()), np.asarray(single[c].tolist()),
                               err_msg=c)
    npt.assert_array_equal(np.asarray(routed["mn"].tolist()), np.asarray(single["mn"].tolist()))


def test_shuffle_multikey_cartesian(monkeypatch):
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    rng = np.random.default_rng(9)
    n = 30_000
    a = rng.integers(0, 500, n).astype("i8")
    b = rng.integers(0, 400, n).astype("i8")
    x = rng.normal(0, 1, n)
    agg = {"s": vt.agg.sum("x"), "c": "count"}
    df1 = vt.from_arrays(a=a, b=b, x=x)
    single = df1.groupby(["a", "b"], agg=agg, sort=True, assume_sparse=False)
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    df2 = vt.from_arrays(a=a, b=b, x=x)
    df2.executor = distributed_executor()
    routed = df2.groupby(["a", "b"], agg=agg, sort=True, assume_sparse=False)
    assert len(routed) == len(single)
    for c in ("a", "b", "c"):
        npt.assert_array_equal(np.asarray(routed[c].tolist()), np.asarray(single[c].tolist()),
                               err_msg=c)
    npt.assert_allclose(np.asarray(routed["s"].tolist()), np.asarray(single["s"].tolist()),
                        rtol=1e-9, atol=1e-12)


def test_shuffle_weak_scaling_accounting(monkeypatch):
    """BASELINE '>=8x rows/s scaling 1->8 hosts': at FIXED rows/device, the
    per-device all-to-all bytes and per-device sorted rows stay constant as
    the mesh grows 2->4->8 — the weak-scaling argument the virtual mesh can
    carry (real multi-chip is unavailable here); results stay oracle-exact
    at every D."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import pandas as pd
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    rows_per_device = 20_000
    stats = {}
    for D in (2, 4, 8):
        n = rows_per_device * D
        rng = np.random.default_rng(D)
        k = rng.integers(0, 5_000, n).astype("i8") * 2
        x = rng.random(n)
        df = vt.from_arrays(k=k, x=x)
        df.executor = distributed_executor(D)
        out = df.groupby("k", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
        oracle = pd.DataFrame({"k": k, "x": x}).groupby("k").agg(
            s=("x", "sum"), c=("x", "size"))
        npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(),
                            rtol=1e-9)
        npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
        entry = [e for e in df.executor.trace_log if e.get("shuffle")][-1]
        assert entry["devices"] == D
        stats[D] = entry
    base = stats[2]
    for D in (4, 8):
        e = stats[D]
        assert e["rows_per_device"] == base["rows_per_device"]
        # per-device exchange volume flat in D (within the ceil-div wobble)
        ratio = e["alltoall_bytes_per_device"] / base["alltoall_bytes_per_device"]
        assert 0.9 <= ratio <= 1.1, (D, e, base)


def test_shuffle_nat_skipped_min_max(monkeypatch):
    """Datetime NaT (int64 min) must be masked on the shuffle route so
    min/max match pandas and the single-device path (advisor r3 low)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import pandas as pd
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    rng = np.random.default_rng(11)
    n = 5000
    k = (rng.integers(0, 50, n).astype("i8")) * 7 + 1  # sparse -> set grouper
    t = (np.datetime64("2020-01-01") +
         rng.integers(0, 10**6, n).astype("m8[s]"))
    t[::5] = np.datetime64("NaT")
    df = vt.from_arrays(k=k, t=t)
    df.executor = distributed_executor()
    out = df.groupby("k", agg={"mn": vt.agg.min("t"), "mx": vt.agg.max("t")},
                     sort=True)
    oracle = pd.DataFrame({"k": k, "t": t}).groupby("k")["t"].agg(["min", "max"])
    npt.assert_array_equal(np.asarray(out["mn"].tolist(), dtype="M8[s]"),
                           oracle["min"].to_numpy().astype("M8[s]"))
    npt.assert_array_equal(np.asarray(out["mx"].tolist(), dtype="M8[s]"),
                           oracle["max"].to_numpy().astype("M8[s]"))


def test_shuffle_skew_falls_back_to_replicated(monkeypatch):
    """One hot key exhausting all slack retries must fall back to the
    replicated-grid path instead of raising (advisor r3 low)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import vaex_tpu.groupby as gb
    from vaex_tpu.parallel import distributed_executor
    monkeypatch.setattr(gb, "SHUFFLE_MIN_G", 10)
    # force immediate exhaustion: zero retries at minimal slack
    orig = gb._run_shuffle_plan
    monkeypatch.setattr(gb, "_run_shuffle_plan",
                        lambda df, oe, plan, G, mesh, **kw:
                        orig(df, oe, plan, G, mesh, slack=1, max_retries=0))
    n = 20_000
    k = np.full(n, 999_983, dtype="i8")  # ONE hot key: maximal skew
    k[:50] = np.arange(50) * 13 + 1
    df = vt.from_arrays(k=k, x=np.ones(n))
    df.executor = distributed_executor()
    out = df.groupby("k", agg={"c": "count"}, sort=True)
    counts = np.asarray(out["c"].tolist())
    assert counts.sum() == n
    assert counts.max() == n - 50


def test_fused_mesh_groupby_matches_single_device():
    """sparse-key groupby on the mesh rides the fused
    one-sort plan — shard-local sort, ONE all-to-all, zero set-build
    passes — and matches the single-device fused path (ints bit-for-bit,
    floats to 1e-9)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import distributed_executor
    rng = np.random.default_rng(11)
    n = 60_000
    k = rng.integers(0, 2**31, n).astype("i8") * 3 + 5   # sparse, huge span
    x = rng.normal(0, 10, n)
    v = rng.integers(-(2**40), 2**40, n).astype("i8")
    agg = {"c": "count", "s": vt.agg.sum("v"), "fx": vt.agg.sum("x"),
           "mn": vt.agg.min("x"), "mx": vt.agg.max("v"),
           "mu": vt.agg.mean("x"), "sd": vt.agg.std("x", ddof=1)}

    df1 = vt.from_arrays(k=k, x=x, v=v)
    single = df1.groupby("k", agg=agg, sort=True)

    from vaex_tpu import cache
    with cache.off():
        df2 = vt.from_arrays(k=k, x=x, v=v)
        df2.executor = distributed_executor()
        out = df2.groupby("k", agg=agg, sort=True)
        log = [t for t in df2.executor.trace_log
               if isinstance(t, dict) and t.get("fused_mesh_groupby")]
    assert len(log) == 1, "expected exactly one fused-mesh exchange"
    assert log[0]["exchanges"] == 1 and log[0]["set_build_passes"] == 0

    npt.assert_array_equal(np.asarray(out["k"].tolist()),
                           np.asarray(single["k"].tolist()))
    npt.assert_array_equal(np.asarray(out["c"].tolist()),
                           np.asarray(single["c"].tolist()))
    npt.assert_array_equal(np.asarray(out["s"].tolist()),
                           np.asarray(single["s"].tolist()))
    npt.assert_array_equal(np.asarray(out["mx"].tolist()),
                           np.asarray(single["mx"].tolist()))
    for col in ("fx", "mn", "mu", "sd"):
        npt.assert_allclose(np.asarray(out[col].tolist()),
                            np.asarray(single[col].tolist()),
                            rtol=1e-9, atol=1e-12)
    # pandas oracle on a couple of columns
    import pandas as pd
    oracle = (pd.DataFrame({"k": k, "x": x, "v": v}).groupby("k")
              .agg(c=("x", "size"), s=("v", "sum"), sd=("x", lambda a: a.std(ddof=1))))
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    npt.assert_array_equal(np.asarray(out["s"].tolist()), oracle["s"].to_numpy())
    sd_out = np.asarray(out["sd"].tolist())
    sd_ora = oracle["sd"].to_numpy()
    mask = ~np.isnan(sd_ora)
    npt.assert_allclose(sd_out[mask], sd_ora[mask], rtol=1e-7, atol=1e-9)
    assert np.all(np.isnan(sd_out[~mask]))


def test_fused_mesh_groupby_multikey():
    """Multi-key packed fused keys ride the mesh one-sort plan too."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from vaex_tpu.parallel import distributed_executor
    rng = np.random.default_rng(13)
    n = 30_000
    a = rng.integers(0, 4000, n).astype("i8")
    b = rng.integers(0, 4000, n).astype("i8")   # product 16e6 > 1e6 threshold
    x = rng.normal(0, 1, n)
    from vaex_tpu import cache
    with cache.off():
        df = vt.from_arrays(a=a, b=b, x=x)
        df.executor = distributed_executor()
        out = df.groupby(["a", "b"], agg={"s": vt.agg.sum("x"), "c": "count"},
                         sort=True)
        assert any(isinstance(t, dict) and t.get("fused_mesh_groupby")
                   for t in df.executor.trace_log)
    import pandas as pd
    oracle = (pd.DataFrame({"a": a, "b": b, "x": x})
              .groupby(["a", "b"], as_index=False)
              .agg(s=("x", "sum"), c=("x", "size")))
    npt.assert_array_equal(np.asarray(out["a"].tolist()), oracle["a"].to_numpy())
    npt.assert_array_equal(np.asarray(out["b"].tolist()), oracle["b"].to_numpy())
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(),
                        rtol=1e-9, atol=1e-12)


def test_fused_mesh_exact_median():
    """exact per-group median on the 8-device mesh via the
    fused one-sort exchange (value column as second sort key), matching
    pandas to 1e-12 — including NaN skipping and all-NaN groups.  A small
    cartesian multi-key with a percentile FORCES the fused exchange (the
    replicated-grid path cannot do exact medians across row shards)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import pandas as pd
    from vaex_tpu.parallel import distributed_executor
    from vaex_tpu import cache
    rng = np.random.default_rng(5)
    n = 40_000
    k = rng.integers(0, 2**33, n).astype("i8")
    x = rng.normal(0, 100, n)
    x[rng.random(n) < 0.03] = np.nan
    agg = {"m": vt.agg.median("x"), "p9": vt.agg.percentile_approx("x", 90.0),
           "c": "count"}
    with cache.off():
        df = vt.from_arrays(k=k, x=x)
        df.executor = distributed_executor()
        out = df.groupby("k", agg=agg, sort=True)
        assert any(isinstance(t, dict) and t.get("fused_mesh_groupby")
                   for t in df.executor.trace_log)
    g = pd.DataFrame({"k": k, "x": x}).groupby("k")["x"]
    npt.assert_allclose(np.asarray(out["m"].tolist()), g.median().to_numpy(),
                        rtol=1e-12, atol=1e-12)
    npt.assert_allclose(np.asarray(out["p9"].tolist()),
                        g.quantile(0.9).to_numpy(), rtol=1e-12, atol=1e-12)

    # small cartesian keys + median: percentile forces the fused exchange
    a = rng.integers(0, 40, n).astype("i8")
    b = rng.integers(0, 40, n).astype("i8")
    with cache.off():
        df2 = vt.from_arrays(a=a, b=b, x=x)
        df2.executor = distributed_executor()
        out2 = df2.groupby(["a", "b"], agg={"m": vt.agg.median("x")}, sort=True)
        assert any(isinstance(t, dict) and t.get("fused_mesh_groupby")
                   for t in df2.executor.trace_log)
    og = pd.DataFrame({"a": a, "b": b, "x": x}).groupby(["a", "b"])["x"].median()
    npt.assert_allclose(np.asarray(out2["m"].tolist()), og.to_numpy(),
                        rtol=1e-12, atol=1e-12)


def test_fused_mesh_unpacked_multikey():
    """The unpacked multi-key sort (span product past int64) distributes
    over the mesh too: partition on the leading key, merge sort by all."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import pandas as pd
    from vaex_tpu.parallel import distributed_executor
    from vaex_tpu import cache
    rng = np.random.default_rng(19)
    n = 30_000
    a = rng.integers(0, 2**33, n).astype("i8")
    b = rng.integers(0, 2**33, n).astype("i8")
    x = rng.normal(0, 5, n)
    with cache.off():
        df = vt.from_arrays(a=a, b=b, x=x)
        df.executor = distributed_executor()
        out = df.groupby(["a", "b"], agg={"s": vt.agg.sum("x"), "c": "count"},
                         sort=True)
        assert any(isinstance(t, dict) and t.get("fused_mesh_groupby")
                   for t in df.executor.trace_log)
    oracle = (pd.DataFrame({"a": a, "b": b, "x": x})
              .groupby(["a", "b"], as_index=False)
              .agg(s=("x", "sum"), c=("x", "size")))
    npt.assert_array_equal(np.asarray(out["a"].tolist()), oracle["a"].to_numpy())
    npt.assert_array_equal(np.asarray(out["b"].tolist()), oracle["b"].to_numpy())
    npt.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    npt.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(),
                        rtol=1e-9, atol=1e-9)
