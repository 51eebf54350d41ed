"""unique / nunique / value_counts / isin (reference tests/unique_test.py,
value_counts_test.py, isin_test.py).  NaN and null are distinct keys
(SURVEY §2.4); unsorted order is not a contract — compare as sets."""

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu as vt


def test_unique(df):
    assert set(df.unique("g")) == {0, 1, 2}
    vals = df.unique("m")
    non_null = [v for v in vals if v is not None]
    assert set(non_null) == set(range(2, 10))
    assert None in vals  # null is a key
    vals = df.unique("f")
    assert any(v is not None and np.isnan(v) for v in vals)  # nan is a key


def test_unique_drop(df_local):
    df = df_local
    vals = df.unique("m", dropmissing=True)
    assert None not in vals
    vals = df.unique("f", dropnan=True)
    assert not any(v is not None and np.isnan(v) for v in vals)


def test_unique_strings(df):
    assert set(df.unique("name")) == {"n0", "n1", "n2"}


def test_nunique(df_local):
    df = df_local
    assert df["g"].nunique() == 3
    assert df["m"].nunique() == 9          # 8 values + null
    assert df["m"].nunique(dropmissing=True) == 8
    assert df["f"].nunique() == 10         # 9 values + nan
    assert df["f"].nunique(dropnan=True) == 9
    assert df["name"].nunique() == 3


def test_value_counts(df_local):
    df = df_local
    vc = df["g"].value_counts()
    assert vc.to_dict() == {0: 4, 1: 4, 2: 2}
    vc = df["m"].value_counts()
    assert vc["missing"] == 2
    vc = df["m"].value_counts(dropmissing=True)
    assert "missing" not in vc.index
    vc = df["name"].value_counts()
    assert vc.to_dict() == {"n0": 4, "n1": 3, "n2": 3}


def test_isin(df):
    expr = df["g"].isin([0, 2])
    values = expr.evaluate(array_type="numpy")
    expected = np.isin(np.array([0, 0, 0, 0, 1, 1, 1, 1, 2, 2]), [0, 2])
    npt.assert_array_equal(np.asarray(values, bool), expected)


def test_isin_strings(df_local):
    df = df_local
    expr = df["name"].isin(["n1"])
    values = np.asarray(expr.evaluate(array_type="numpy"), bool)
    assert values.sum() == 3


def test_isin_count(df):
    assert df.count(selection=str(df["g"].isin([1]))) == 4


def test_expression_map(df_local):
    df = df_local
    e = df["g"].map({0: 10, 1: 20, 2: 30})
    assert e.tolist() == [10, 10, 10, 10, 20, 20, 20, 20, 30, 30]


def test_unique_limit(df_local):
    df = df_local
    with pytest.raises(vt.RowLimitException):
        df.unique("x", limit=3)


def test_set_device_global():
    # near-unique keys force the global-sort set build
    n = 5000
    keys = np.arange(n, dtype="i8")
    rng = np.random.default_rng(0)
    rng.shuffle(keys)
    df = vt.from_arrays(k=keys, x=np.arange(n, dtype="f8"))
    oset = df._set_device_global("k")
    assert oset is not None
    assert oset.n_keys == n
    assert oset.keys.tolist() == list(range(n))
    oset2 = df._set_device_global("k", keep_counts=True)
    assert oset2.counts.sum() == n


def test_set_device_global_with_nan():
    x = np.array([1.0, 2.0, np.nan, 2.0, np.nan])
    df = vt.from_arrays(x=x)
    oset = df._set_device_global("x")
    assert oset.keys.tolist() == [1.0, 2.0]
    assert oset.nan_count == 2


def test_set_device_global_limit():
    df = vt.from_arrays(k=np.arange(100, dtype="i8"))
    with pytest.raises(vt.RowLimitException):
        df._set_device_global("k", limit=10)


def test_unique_bytes_non_utf8():
    """ADVICE r2: non-UTF8 bytes must fall back to np.unique, not crash."""
    import vaex_tpu as vt
    raw = [b"\xff\xfe" + bytes([i % 7]) for i in range(5000)]
    data = np.array(raw, dtype="S3")
    from vaex_tpu.ops.setops import _unique_and_counts
    uniq, _ = _unique_and_counts(data, keep_counts=False)
    assert len(uniq) == 7


def test_unique_object_mixed_types():
    from vaex_tpu.ops.setops import _unique_and_counts
    data = np.empty(6000, dtype=object)
    data[:] = [((1, 2), (3, 4))[i % 2] for i in range(6000)]
    uniq, counts = _unique_and_counts(data, keep_counts=True)
    assert len(uniq) == 2


def test_object_bytes_keys_ride_arrow_hash_path():
    """object columns holding non-UTF8 values (bytes)
    dictionary-encode through arrow's generic inference — set build AND
    probe use the C++ hash kernels, not per-row Python loops."""
    from vaex_tpu.ops.setops import SortedSet
    rng = np.random.default_rng(2)
    raw = [bytes([b, 255, b ^ 0xAA]) for b in rng.integers(0, 50, 5000)]
    data = np.asarray(raw, dtype=object)
    s = SortedSet("string", keep_counts=True)
    s.update(data)
    assert s.n_keys == len(set(raw))
    codes = s.map_ordinal(data)
    # codes are ordinals into the sorted key array: decoding restores input
    keys = s.keys
    decoded = keys[np.asarray(codes)]
    assert list(decoded) == raw
    # isin agrees
    probe = np.asarray([raw[0], b"\x01\x02\x03"], dtype=object)
    got = s.isin(probe)
    assert got.tolist() == [True, False]


def test_object_mixed_keys_fall_back():
    """Truly mixed/unorderable object values still probe correctly via the
    dict fallback."""
    from vaex_tpu.ops.setops import _string_index_in
    keys = np.empty(2, dtype=object)
    keys[:] = [(1, 2), (3, 4)]
    data = np.empty(3, dtype=object)
    data[:] = [(3, 4), (1, 2), (9, 9)]
    codes = _string_index_in(data, keys)
    assert codes.tolist() == [1, 0, -1]


def test_bytes_column_groupby_end_to_end():
    """Object arrays of bytes ingest as arrow binary (no lossy str() repr)
    and groupby through the same dictionary-code path as strings."""
    import pandas as pd
    rng = np.random.default_rng(6)
    raw = [bytes([b, 200]) for b in rng.integers(0, 30, 5000)]
    k = np.asarray(raw, dtype=object)
    x = rng.random(5000)
    df = vt.from_dict({"k": k, "x": x})
    out = df.groupby("k", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    oracle = (pd.DataFrame({"k": raw, "x": x})
              .groupby("k", as_index=False).agg(s=("x", "sum"), c=("x", "size")))
    np.testing.assert_array_equal(np.asarray(out["c"].tolist()),
                                  oracle["c"].to_numpy())
    np.testing.assert_allclose(np.asarray(out["s"].tolist()),
                               oracle["s"].to_numpy(), rtol=1e-9)
    assert [bytes(v) for v in out["k"].tolist()] == list(oracle["k"])


def test_dict_encoded_string_set_paths():
    """Dictionary-encoded string chunks build/probe sets through the O(U)
    integer path (setops._update_from_dict / _dict_ordinals) and agree with
    the decoded-string path, including nulls and duplicate dict values."""
    import pyarrow as pa
    from vaex_tpu.ops.setops import SortedSet

    d = pa.array(["b", "a", "c", "a"], type=pa.large_utf8())  # "a" repeated
    idx = pa.array([0, 1, 2, 3, None, 0, 1], type=pa.int32())
    darr = pa.DictionaryArray.from_arrays(idx, d)

    s_dict = SortedSet("string", keep_counts=True)
    s_dict.update(darr)
    s_flat = SortedSet("string", keep_counts=True)
    s_flat.update(darr.dictionary_decode())
    assert list(s_dict.keys) == list(s_flat.keys)
    assert list(s_dict.counts) == list(s_flat.counts)
    assert s_dict.null_count == s_flat.null_count == 1
    assert s_dict.map_ordinal(darr).tolist() == \
        s_flat.map_ordinal(darr.dictionary_decode()).tolist()
    assert s_dict.isin(darr).tolist() == \
        s_flat.isin(darr.dictionary_decode()).tolist()

    # probing with a set that covers only part of the dictionary
    part = SortedSet("string")
    part.update(pa.array(["a", "zz"], type=pa.large_utf8()))
    assert part.map_ordinal(darr).tolist() == [-1, 0, -1, 0, -1, -1, 0]
    assert part.isin(darr).tolist() == [False, True, False, True, False, False, True]


def test_dict_encoded_string_groupby_end_to_end():
    """A dictionary-encoded string column groups identically to its decoded
    form (the 1e8 string-groupby host leg rides this path)."""
    import pandas as pd
    import pyarrow as pa
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 40, 4000)
    dictionary = pa.array([f"k{i:03d}" for i in range(40)], type=pa.large_utf8())
    darr = pa.DictionaryArray.from_arrays(pa.array(codes, type=pa.int32()), dictionary)
    x = rng.random(4000)
    df = vt.from_dict({"k": darr, "x": x})
    out = df.groupby("k", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
    oracle = (pd.DataFrame({"k": [f"k{c:03d}" for c in codes], "x": x})
              .groupby("k", as_index=False).agg(s=("x", "sum"), c=("x", "size")))
    np.testing.assert_array_equal(np.asarray(out["c"].tolist()), oracle["c"].to_numpy())
    np.testing.assert_allclose(np.asarray(out["s"].tolist()), oracle["s"].to_numpy(),
                               rtol=1e-9)
    assert [str(v) for v in out["k"].tolist()] == list(oracle["k"])
