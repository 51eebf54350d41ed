"""describe / mutual_information / stat algebra / covar / correlation /
percentile / geo accessor."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt
from vaex_tpu import stat

X = np.arange(10, dtype="f8")


def test_describe(df_local):
    desc = df_local.describe()
    assert desc.loc["count", "x"] == 10
    assert desc.loc["count", "m"] == 8
    assert desc.loc["NA", "m"] == 2
    npt.assert_allclose(desc.loc["mean", "x"], X.mean())


def test_stat_algebra(df_local):
    df = df_local
    expr = stat.mean("x") + 2 * stat.std("x")
    value = expr.calculate(df)
    npt.assert_allclose(value, X.mean() + 2 * X.std())
    ratio = stat.sum("y") / stat.count("y")
    npt.assert_allclose(ratio.calculate(df), (X ** 2).mean())


def test_covar_correlation(df_local):
    df = df_local
    x, y = X, X ** 2
    npt.assert_allclose(df.covar("x", "y"), ((x - x.mean()) * (y - y.mean())).mean())
    expected_corr = np.corrcoef(x, y)[0, 1]
    npt.assert_allclose(df.correlation("x", "y"), expected_corr, rtol=1e-6)


def test_cov_matrix(df_local):
    C = df_local.cov(["x", "y"])
    assert C.shape == (2, 2)
    npt.assert_allclose(C[0, 0], X.var())


def test_percentile_median(df_local):
    df = df_local
    m = df.median_approx("x")
    assert abs(m - np.median(X)) < 0.6
    p = df.percentile_approx("x", 25.0)
    assert abs(p - np.percentile(X, 25)) < 0.7


def test_mutual_information(df_local):
    df = df_local
    mi_self = df.mutual_information("g", "g", mi_shape=8)
    mi_indep = df.mutual_information("x", "m", mi_shape=8)
    assert mi_self > 0.5  # identical variables share all information


def test_limits_percentage(df_local):
    lo, hi = df_local.limits_percentage("x", 100.0)
    assert lo <= 0.1 and hi >= 8.9


def test_mode(df_local):
    df = vt.from_arrays(x=np.array([1.0, 2.0, 2.0, 2.0, 3.0]))
    assert abs(df.mode("x") - 2.0) < 0.2


def test_geo_polar(df_local):
    df = vt.from_arrays(x=np.array([1.0, 0.0]), y=np.array([0.0, 1.0]))
    df.geo.cartesian2polar()
    npt.assert_allclose(df["polar_radius"].tolist(), [1.0, 1.0])
    npt.assert_allclose(df["polar_azimuth"].tolist(), [0.0, 90.0])


def test_geo_spherical_roundtrip():
    df = vt.from_arrays(alpha=np.array([10.0, 120.0]), delta=np.array([5.0, -30.0]),
                        r=np.array([2.0, 3.0]))
    df.geo.spherical2cartesian("alpha", "delta", "r")
    df.geo.cartesian2spherical(alpha="alpha2", delta="delta2", distance="r2")
    npt.assert_allclose(df["alpha2"].tolist(), [10.0, 120.0], atol=1e-10)
    npt.assert_allclose(df["delta2"].tolist(), [5.0, -30.0], atol=1e-10)
    npt.assert_allclose(df["r2"].tolist(), [2.0, 3.0])


def test_geo_inside_polygon():
    df = vt.from_arrays(x=np.array([0.5, 2.0]), y=np.array([0.5, 2.0]))
    e = df.geo.inside_polygon("x", "y", [0, 1, 1, 0], [0, 0, 1, 1])
    assert np.asarray(e.evaluate(array_type="numpy"), bool).tolist() == [True, False]


def test_first_last_style(df_local):
    # first by order expression on device
    assert df_local.first("x", "y") == 0.0


def test_percentile_binby():
    rng = np.random.default_rng(0)
    g = np.repeat([0, 1], 5000)
    x = np.where(g == 0, rng.normal(10, 1, 10000), rng.normal(20, 1, 10000))
    df = vt.from_arrays(g=g.astype("i8"), x=x)
    medians = df.percentile_approx("x", 50.0, binby=["g"], limits=[[0, 2]], shape=2)
    assert abs(medians[0] - 10) < 0.3
    assert abs(medians[1] - 20) < 0.3


def test_mode_binby():
    g = np.repeat([0, 1], 100)
    x = np.where(g == 0, 3.0, 7.0) + np.linspace(-0.01, 0.01, 200)
    df = vt.from_arrays(g=g.astype("i8"), x=x)
    modes = df.mode("x", binby=["g"], limits=[[0, 2]], shape=2)
    assert abs(modes[0] - 3.0) < 0.3
    assert abs(modes[1] - 7.0) < 0.3


# ---------------------------------------------------------------------------
# groupby-level aggregates for H2O q6/q8/q9: median/percentile, top-k, corr


def _h2o_frame(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    return vt.from_arrays(
        k=rng.integers(0, 7, n).astype("i8"),
        k2=rng.integers(0, 3, n).astype("i8"),
        v1=rng.integers(1, 6, n).astype("i8"),
        v3=rng.random(n) * 100,
    )


def test_agg_median_groupby():
    df = _h2o_frame()
    out = df.groupby("k", agg={"med": vt.agg.median_approx("v3"),
                               "sd": vt.agg.std("v3", ddof=1)}, sort=True)
    pdf = df.to_pandas_df()
    oracle = pdf.groupby("k")["v3"].median().sort_index()
    sd_oracle = pdf.groupby("k")["v3"].std().sort_index()
    np.testing.assert_allclose(np.asarray(out["med"].values), oracle.to_numpy(), atol=0.35)
    np.testing.assert_allclose(np.asarray(out["sd"].values), sd_oracle.to_numpy(), rtol=1e-6)


def test_agg_percentile_groupby():
    df = _h2o_frame()
    out = df.groupby("k", agg={"p90": vt.agg.percentile_approx("v3", 90.0)}, sort=True)
    pdf = df.to_pandas_df()
    oracle = pdf.groupby("k")["v3"].quantile(0.9).sort_index()
    np.testing.assert_allclose(np.asarray(out["p90"].values), oracle.to_numpy(), atol=0.5)


def test_agg_corr_groupby():
    rng = np.random.default_rng(3)
    n = 3000
    k = rng.integers(0, 5, n).astype("i8")
    x = rng.random(n)
    y = 0.5 * x + rng.random(n) * 0.3
    df = vt.from_arrays(k=k, x=x, y=y)
    out = df.groupby("k", agg={"r": vt.agg.corr("x", "y")}, sort=True)
    pdf = df.to_pandas_df()
    oracle = pdf.groupby("k").apply(lambda g: g["x"].corr(g["y"]))
    np.testing.assert_allclose(np.asarray(out["r"].values), oracle.to_numpy(), rtol=1e-9)


def test_agg_covar_groupby():
    rng = np.random.default_rng(4)
    n = 2000
    k = rng.integers(0, 4, n).astype("i8")
    x = rng.random(n)
    y = x + rng.random(n)
    df = vt.from_arrays(k=k, x=x, y=y)
    out = df.groupby("k", agg={"c": vt.agg.covar("x", "y")}, sort=True)
    pdf = df.to_pandas_df()
    oracle = pdf.groupby("k").apply(lambda g: g["x"].cov(g["y"]) * (len(g) - 1) / len(g))
    np.testing.assert_allclose(np.asarray(out["c"].values), oracle.to_numpy(), rtol=1e-9)


def test_agg_nth_largest_groupby():
    df = _h2o_frame(n=500)
    out = df.groupby("k", agg={"top1": vt.agg.nth_largest("v3", 0),
                               "top2": vt.agg.nth_largest("v3", 1),
                               "bot1": vt.agg.nth_smallest("v3", 0)}, sort=True)
    pdf = df.to_pandas_df()
    top1 = pdf.groupby("k")["v3"].max().sort_index()
    top2 = pdf.groupby("k")["v3"].apply(lambda s: s.nlargest(2).iloc[-1]).sort_index()
    bot1 = pdf.groupby("k")["v3"].min().sort_index()
    np.testing.assert_allclose(np.asarray(out["top1"].values), top1.to_numpy())
    np.testing.assert_allclose(np.asarray(out["top2"].values), top2.to_numpy())
    np.testing.assert_allclose(np.asarray(out["bot1"].values), bot1.to_numpy())


def test_agg_corr_with_nan_null():
    x = np.array([1.0, 2.0, np.nan, 4.0, 5.0, 6.0])
    y = np.ma.MaskedArray([2.0, 4.1, 6.0, 8.2, 10.0, 1.0],
                          [False, False, False, False, False, True])
    k = np.zeros(6, "i8")
    df = vt.from_arrays(k=k, x=x, y=y)
    out = df.groupby("k", agg={"r": vt.agg.corr("x", "y")})
    import pandas as pd
    oracle = pd.Series([1.0, 2.0, 4.0, 5.0]).corr(pd.Series([2.0, 4.1, 8.2, 10.0]))
    np.testing.assert_allclose(np.asarray(out["r"].values)[0], oracle, rtol=1e-9)


def test_agg_median_multitile():
    # the histogram state must merge across tiles
    df = _h2o_frame(n=3000)
    df._tile_rows = 512
    out = df.groupby("k", agg={"med": vt.agg.median_approx("v3")}, sort=True)
    pdf = df.to_pandas_df()
    oracle = pdf.groupby("k")["v3"].median().sort_index()
    np.testing.assert_allclose(np.asarray(out["med"].values), oracle.to_numpy(), atol=0.35)


def test_median_exact_groupby():
    """per-group median is EXACT on the sort path (the
    reference is approx-only, dataframe.py:1419-1524)."""
    rng = np.random.default_rng(13)
    n = 50_000
    k = rng.integers(0, 3_000, n).astype("i8")
    v = rng.random(n) * 100
    df = vt.from_arrays(k=k, v=v)
    out = df.groupby("k", agg={"med": vt.agg.median_approx("v"),
                               "q75": vt.agg.percentile_approx("v", 75.0)}, sort=True)
    import pandas as pd
    oracle = pd.DataFrame({"k": k, "v": v}).groupby("k").agg(
        med=("v", "median"), q75=("v", lambda s: s.quantile(0.75)))
    npt.assert_allclose(np.asarray(out["med"].tolist()), oracle["med"].to_numpy(),
                        rtol=0, atol=1e-12)
    npt.assert_allclose(np.asarray(out["q75"].tolist()), oracle["q75"].to_numpy(),
                        rtol=0, atol=1e-12)


def test_median_exact_with_nulls_and_forced_modes():
    rng = np.random.default_rng(7)
    n = 20_000
    k = rng.integers(0, 500, n).astype("i8")
    v = np.ma.MaskedArray(rng.random(n) * 10, rng.random(n) < 0.2)
    df = vt.from_arrays(k=k, v=v)
    import pandas as pd
    out = df.groupby("k", agg={"med": vt.agg.median_approx("v")}, sort=True)
    oracle = pd.DataFrame({"k": k, "v": np.where(v.mask, np.nan, v.data)}).groupby("k").agg(
        med=("v", "median"))
    npt.assert_allclose(np.asarray(out["med"].tolist()), oracle["med"].to_numpy(),
                        rtol=0, atol=1e-12)
    # exact=False keeps the histogram approximation
    out2 = df.groupby("k", agg={"med": vt.agg.median_approx("v", exact=False)}, sort=True)
    err = np.nanmax(np.abs(np.asarray(out2["med"].tolist()) - oracle["med"].to_numpy()))
    assert 1e-9 < err < 0.5


def test_std_precise_on_sort_paths():
    """Variance moments ride exact per-segment sums: std of a constant
    group is exactly 0, not sqrt(cumsum residue)."""
    rng = np.random.default_rng(2)
    n = 60_000
    k = rng.integers(0, 40_000, n).astype("i8")  # dense grouper, sort path
    x = np.full(n, 7.25)
    df = vt.from_arrays(k=k, x=x)
    out = df.groupby("k", agg={"sd": vt.agg.std("x")})
    assert np.nanmax(np.asarray(out["sd"].tolist())) == 0.0


def test_geo_uncertainty_propagation():
    """Geo transforms propagate uncertainties through the coordinate change
    (reference geo.py:58/123/278 -> df.propagate_uncertainties): polar radius
    sigma of independent (x, y) errors is sqrt((x sx)^2 + (y sy)^2)/r."""
    rng = np.random.default_rng(8)
    n = 500
    x = rng.normal(3, 1, n)
    y = rng.normal(4, 1, n)
    df = vt.from_arrays(x=x, y=y,
                        x_uncertainty=np.full(n, 0.1),
                        y_uncertainty=np.full(n, 0.2))
    df.geo.cartesian2polar(radius_out="r", azimuth_out="phi", radians=True,
                           propagate_uncertainties=True)
    assert "r_uncertainty" in df.get_column_names(virtual=True)
    got = np.asarray(df.evaluate("r_uncertainty", array_type="numpy"))
    r = np.sqrt(x ** 2 + y ** 2)
    want = np.sqrt((x * 0.1) ** 2 + (y * 0.2) ** 2) / r
    npt.assert_allclose(got, want, rtol=1e-9)

    # rotation: an isotropic error stays isotropic under rotation
    df2 = vt.from_arrays(x=x, y=y,
                         x_uncertainty=np.full(n, 0.3),
                         y_uncertainty=np.full(n, 0.3))
    df2.geo.rotation_2d("x", "y", "xr", "yr", angle_degrees=30.0,
                        propagate_uncertainties=True)
    got_r = np.asarray(df2.evaluate("xr_uncertainty", array_type="numpy"))
    npt.assert_allclose(got_r, np.full(n, 0.3), rtol=1e-9)


def test_geo_velocity_cartesian2polar_roundtrip():
    rng = np.random.default_rng(9)
    n = 300
    phi = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(1, 5, n)
    vr = rng.normal(0, 1, n)
    vphi = rng.normal(0, 1, n)
    x, y = r * np.cos(phi), r * np.sin(phi)
    vx = vr * np.cos(phi) - vphi * np.sin(phi)
    vy = vr * np.sin(phi) + vphi * np.cos(phi)
    df = vt.from_arrays(x=x, y=y, vx=vx, vy=vy)
    df.geo.velocity_cartesian2polar(vr_out="vr2", vazimuth_out="vphi2")
    npt.assert_allclose(np.asarray(df.evaluate("vr2", array_type="numpy")),
                        vr, rtol=1e-9, atol=1e-12)
    npt.assert_allclose(np.asarray(df.evaluate("vphi2", array_type="numpy")),
                        vphi, rtol=1e-9, atol=1e-12)
