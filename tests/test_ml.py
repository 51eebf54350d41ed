"""ML transformers (reference: packages/vaex-ml tests)."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt
from vaex_tpu import ml

X = np.arange(10, dtype="f8")


@pytest.fixture
def df_ml():
    return vt.from_arrays(
        x=X.copy(),
        y=(X ** 2),
        cat=np.asarray(["a", "b", "a", "c", "b", "a", "a", "c", "b", "a"], dtype=object),
        target=(X > 4).astype("f8"),
    )


def test_standard_scaler(df_ml):
    t = df_ml.ml.standard_scaler(["x"])
    out = t.transform(df_ml)
    values = np.asarray(out["standard_scaled_x"].tolist())
    npt.assert_allclose(values.mean(), 0, atol=1e-12)
    npt.assert_allclose(values.std(), 1, atol=1e-12)


def test_minmax_scaler(df_ml):
    t = df_ml.ml.minmax_scaler(["x"])
    out = t.transform(df_ml)
    values = np.asarray(out["minmax_scaled_x"].tolist())
    assert values.min() == 0 and values.max() == 1


def test_maxabs_scaler(df_ml):
    t = df_ml.ml.max_abs_scaler(["x"])
    out = t.transform(df_ml)
    assert np.asarray(out["absmax_scaled_x"].tolist()).max() == 1.0


def test_label_encoder(df_ml):
    t = df_ml.ml.label_encoder(["cat"])
    out = t.transform(df_ml)
    codes = np.asarray(out["label_encoded_cat"].tolist())
    assert set(codes.tolist()) == {0, 1, 2}
    # same label -> same code
    cats = df_ml["cat"].tolist()
    mapping = {}
    for c, code in zip(cats, codes):
        mapping.setdefault(c, code)
        assert mapping[c] == code


def test_one_hot_encoder(df_ml):
    t = df_ml.ml.one_hot_encoder(["cat"])
    out = t.transform(df_ml)
    names = out.get_column_names()
    assert "cat_a" in names and "cat_b" in names and "cat_c" in names
    a = np.asarray(out["cat_a"].tolist())
    assert a.sum() == 5


def test_frequency_encoder(df_ml):
    t = df_ml.ml.frequency_encoder(["cat"])
    out = t.transform(df_ml)
    values = np.asarray(out["frequency_encoded_cat"].tolist())
    npt.assert_allclose(values[0], 0.5)  # 'a' appears 5/10


def test_pca(df_ml):
    df = df_ml.copy()
    df["z"] = df.x * 2 + 1  # perfectly correlated with x
    t = df.ml.pca(["x", "z"], n_components=2)
    out = t.transform(df)
    p0 = np.asarray(out["PCA_0"].tolist())
    p1 = np.asarray(out["PCA_1"].tolist())
    # second component captures ~no variance
    assert p1.std() < 1e-8
    assert p0.std() > 1


def test_kbins_uniform(df_ml):
    t = df_ml.ml.kbins_discretizer(["x"], n_bins=5)
    out = t.transform(df_ml)
    bins = np.asarray(out["binned_x"].tolist())
    assert bins.min() == 0 and bins.max() == 4


def test_cycle_transformer(df_ml):
    t = df_ml.ml.cycle_transformer(["x"], n=10)
    out = t.transform(df_ml)
    cx = np.asarray(out["x_x"].tolist())
    cy = np.asarray(out["x_y"].tolist())
    npt.assert_allclose(cx ** 2 + cy ** 2, 1.0)


def test_state_roundtrip_pipeline(df_ml):
    t = df_ml.ml.standard_scaler(["x"])
    out = t.transform(df_ml)
    state = out.state_get()
    df2 = vt.from_arrays(x=X.copy(), y=(X ** 2),
                         cat=np.asarray(["a"] * 10, dtype=object),
                         target=np.zeros(10))
    df2.state_set(state)
    values = np.asarray(df2["standard_scaled_x"].tolist())
    npt.assert_allclose(values.mean(), 0, atol=1e-12)


def test_bayesian_target_encoder(df_ml):
    from vaex_tpu.ml import BayesianTargetEncoder
    t = BayesianTargetEncoder(features=["cat"], target="target", weight=0)
    t.fit(df_ml)
    out = t.transform(df_ml)
    values = np.asarray(out["mean_encoded_cat"].tolist())
    # 'a' rows: x in {0,2,5,6,9} -> target 0,0,1,1,1 -> mean 0.6
    npt.assert_allclose(values[0], 0.6)


def test_groupby_transformer(df_ml):
    from vaex_tpu.ml import GroupByTransformer
    t = GroupByTransformer(by="cat", agg={"xs": vt.agg.sum("x")})
    t.fit(df_ml)
    out = t.transform(df_ml)
    values = np.asarray(out["xs"].tolist())
    assert values[0] == 0 + 2 + 5 + 6 + 9  # sum of x over 'a'


def test_sklearn_predictor(df_ml):
    sklearn = pytest.importorskip("sklearn")
    from sklearn.linear_model import LinearRegression
    from vaex_tpu.ml.sklearn import Predictor

    p = Predictor(model=LinearRegression(), features=["x"], target="y",
                  prediction_name="pred")
    p.fit(df_ml)
    out = p.transform(df_ml)
    pred = np.asarray(out["pred"].tolist())
    # y = x^2 fitted linearly still correlates strongly on [0,9]
    assert np.corrcoef(pred, np.asarray(df_ml["y"].tolist()))[0, 1] > 0.95
    # predictions usable in further expressions / aggregations
    assert out.count("pred") == 10


def test_sklearn_incremental(df_ml):
    sklearn = pytest.importorskip("sklearn")
    from sklearn.linear_model import SGDRegressor
    from vaex_tpu.ml.sklearn import IncrementalPredictor

    p = IncrementalPredictor(model=SGDRegressor(random_state=0), features=["x"],
                             target="y", batch_size=4, num_epochs=30)
    p.fit(df_ml)
    out = p.transform(df_ml)
    assert out.count("prediction") == 10


def test_boosting_wrappers_state_roundtrip():
    """Boosted-tree wrappers (reference vaex-ml lightgbm/xgboost/catboost):
    import-gated; unfitted state round-trips without the libraries."""
    from vaex_tpu.ml.boosting import (CatBoostModel, KerasModel,
                                      LightGBMModel, XGBoostModel)
    for cls in (LightGBMModel, XGBoostModel, CatBoostModel):
        m = cls(features=["a", "b"], target="y", params={"objective": "mse"},
                num_boost_round=7, prediction_name="p")
        state = m.state_get()
        m2 = cls()
        m2.state_set(state)
        assert m2.features == ["a", "b"] and m2.target == "y"
        assert m2.num_boost_round == 7 and m2.prediction_name == "p"
        assert m2.model is None
    km = KerasModel(features=["a"], target="y")
    assert km.state_get()["model"] is None


def test_boosting_wrapper_stub_predict_column():
    """transform() attaches the prediction as a virtual column through a
    registered function — df-state pipeline contract — exercised with a
    stub booster (no third-party library needed)."""
    from vaex_tpu.ml.boosting import LightGBMModel

    class StubBooster:
        def predict(self, X):
            return X[:, 0] * 2 + X[:, 1]

    df = vt.from_arrays(a=np.arange(5.0), b=np.ones(5))
    m = LightGBMModel(features=["a", "b"], target="b")
    m.model = StubBooster()
    out = m.transform(df)
    npt.assert_allclose(np.asarray(out["prediction"].tolist()),
                        np.arange(5.0) * 2 + 1)


def test_boosting_requires_library():
    from vaex_tpu.ml.boosting import LightGBMModel
    m = LightGBMModel(features=["a"], target="y")
    df = vt.from_arrays(a=np.arange(4.0), y=np.arange(4.0))
    try:
        import lightgbm  # noqa: F401
        m.fit(df)  # real library present: should just work
        assert m.model is not None
    except ImportError:
        with pytest.raises(ImportError):
            m.fit(df)


def test_kmeans_clusters_and_transform():
    """KMeans (reference cluster.py:66): matmul-batched Lloyd's on three
    well-separated blobs recovers the centers; transform adds the
    prediction as a virtual column; state round-trips."""
    from vaex_tpu.ml import KMeans
    rng = np.random.default_rng(0)
    centers = np.array([[0.0, 0.0], [10.0, 10.0], [-10.0, 5.0]])
    X = np.concatenate([rng.normal(c, 0.5, size=(200, 2)) for c in centers])
    df = vt.from_arrays(a=X[:, 0], b=X[:, 1])
    km = KMeans(features=["a", "b"], n_clusters=3, n_init=3, random_state=42,
                chunk_size=150)  # forces multi-chunk streaming fit
    km.fit(df)
    got = np.sort(np.asarray(km.cluster_centers_), axis=0)
    want = np.sort(centers, axis=0)
    npt.assert_allclose(got, want, atol=0.3)
    assert km.inertia_ < 600 * 2 * 0.5 ** 2 * 3

    out = km.transform(df)
    pred = np.asarray(out.evaluate("prediction_kmeans", array_type="numpy"))
    assert pred.shape == (600,)
    # each blob maps to exactly one cluster id
    for blob in range(3):
        ids = pred[blob * 200:(blob + 1) * 200]
        assert len(np.unique(ids)) == 1

    # state round-trip through the df state machinery
    state = km.state_get()
    km2 = KMeans()
    km2.state_set(state)
    pred2 = km2.predict(df)
    npt.assert_array_equal(pred2, km.predict(df))


def test_metrics_classification_and_regression():
    """df.ml.metrics (reference metrics.py): every metric agrees with
    sklearn on the same arrays."""
    from sklearn import metrics as skm
    rng = np.random.default_rng(1)
    n = 5000
    y = rng.integers(0, 2, n)
    p = np.where(rng.random(n) < 0.8, y, 1 - y)   # ~80% accurate
    yr = rng.normal(0, 2, n)
    pr = yr + rng.normal(0, 0.5, n)
    df = vt.from_arrays(y=y.astype("i8"), p=p.astype("i8"), yr=yr, pr=pr)
    m = df.ml.metrics
    npt.assert_allclose(m.accuracy_score("y", "p"),
                        skm.accuracy_score(y, p), rtol=1e-12)
    npt.assert_array_equal(m.confusion_matrix("y", "p"),
                           skm.confusion_matrix(y, p))
    npt.assert_allclose(m.precision_score("y", "p"),
                        skm.precision_score(y, p), rtol=1e-12)
    npt.assert_allclose(m.recall_score("y", "p"),
                        skm.recall_score(y, p), rtol=1e-12)
    npt.assert_allclose(m.f1_score("y", "p"), skm.f1_score(y, p), rtol=1e-12)
    npt.assert_allclose(m.matthews_correlation_coefficient("y", "p"),
                        skm.matthews_corrcoef(y, p), rtol=1e-9)
    npt.assert_allclose(m.mean_absolute_error("yr", "pr"),
                        skm.mean_absolute_error(yr, pr), rtol=1e-9)
    npt.assert_allclose(m.mean_squared_error("yr", "pr"),
                        skm.mean_squared_error(yr, pr), rtol=1e-9)
    npt.assert_allclose(m.r2_score("yr", "pr"), skm.r2_score(yr, pr), rtol=1e-9)
    # multi-class macro averaging
    y3 = rng.integers(0, 3, n)
    p3 = np.where(rng.random(n) < 0.7, y3, (y3 + 1) % 3)
    df3 = vt.from_arrays(y=y3.astype("i8"), p=p3.astype("i8"))
    got = df3.ml.metrics.precision_recall_fscore("y", "p", average="macro")
    want = skm.precision_recall_fscore_support(y3, p3, average="macro")[:3]
    npt.assert_allclose(got, want, rtol=1e-9)
    report = df.ml.metrics.classification_report("y", "p")
    assert "Accuracy" in report and "F1" in report


def test_river_model_streaming_regressor():
    """Streaming mini-batch training through RiverModel (reference
    incubator/river.py): chunked learn_many over the engine iterator, then
    predictions as a virtual column."""
    from vaex_tpu.ml import OnlineSGDRegressor, RiverModel
    rng = np.random.default_rng(8)
    n = 20_000
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = 3.0 * x1 - 2.0 * x2 + 0.5 + rng.normal(0, 0.01, n)
    df = vt.from_arrays(x1=x1, x2=x2, y=y)
    m = RiverModel(model=OnlineSGDRegressor(learning_rate=0.2),
                   features=["x1", "x2"], target="y",
                   batch_size=4096, num_epochs=8)
    m.fit(df)
    out = m.transform(df)
    pred = np.asarray(out.evaluate("prediction"))
    resid = np.abs(pred - y)
    assert resid.mean() < 0.1, resid.mean()
    # coefficients recovered
    npt.assert_allclose(m.model.weights, [3.0, -2.0], atol=0.05)
    npt.assert_allclose(m.model.intercept, 0.5, atol=0.05)


def test_river_model_streaming_classifier():
    from vaex_tpu.ml import OnlineSGDClassifier, RiverModel
    rng = np.random.default_rng(9)
    n = 20_000
    x1 = rng.normal(size=n)
    x2 = rng.normal(size=n)
    y = (x1 - x2 > 0).astype("i8")
    df = vt.from_arrays(x1=x1, x2=x2, y=y)
    m = RiverModel(model=OnlineSGDClassifier(learning_rate=0.5),
                   features=["x1", "x2"], target="y",
                   batch_size=4096, num_epochs=6)
    m.fit(df)
    pred = m.predict(df)
    acc = (pred == y).mean()
    assert acc > 0.97, acc
    # predict_proba virtual column flavor
    m.prediction_type = "predict_proba"
    out = m.transform(df)
    proba = np.asarray(out.evaluate("prediction"))
    assert proba.min() >= 0 and proba.max() <= 1
    assert ((proba >= 0.5).astype("i8") == pred).all()
