"""String benchmarks: groupby / unique / isin / value_counts on string keys
plus the str_* kernel surface (reference: benchmarks/strings.py,
benchmarks/isin.py — 1e8-row numeric strings, fixtures.py:8-23).

Strings ride the declared device design (SURVEY §7.1): dictionary-encode at
ingest (``to_device``), device ops on int32 codes, str_* kernels on the host
via pyarrow.  Run: python benchmarks/strings.py [--n 1e7] [--device] [--check]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def strings_frame(n: int, k: int = 100, seed=42):
    """Numeric strings, shuffled (reference benchmarks/fixtures.py:8-23)."""
    import vaex_tpu as vt
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, n)
    labels = np.asarray([f"id{i:07d}" for i in range(k)], dtype=object)
    s = labels[codes]
    hi = rng.integers(0, n, n)  # near-unique strings
    return vt.from_arrays(s=s, s_hi=np.asarray([f"v{v}" for v in hi], dtype=object),
                          x=rng.random(n))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=float, default=1e7)
    parser.add_argument("--k", type=float, default=1e2)
    parser.add_argument("--device", action="store_true")
    parser.add_argument("--check", action="store_true")
    args = parser.parse_args()

    from benchmarks.device import announce
    device = announce()
    import vaex_tpu as vt
    from vaex_tpu import cache

    n, k = int(args.n), int(args.k)
    df = strings_frame(n, k)
    pdf = df.to_pandas_df() if args.check else None
    if args.device:
        t0 = time.perf_counter()
        df = df.to_device()
        print(f"to_device (dictionary encode + stage): {time.perf_counter()-t0:.3f} s",
              flush=True)
    df._tile_rows = 1 << 22

    isin_values = [f"id{i:07d}" for i in range(0, k, 2)][:500]

    cases = {
        "groupby_str_sum": lambda: df.groupby("s", agg={"x": "sum"}),
        "value_counts_str": lambda: df["s"].value_counts(),
        "unique_str": lambda: df.unique("s"),
        "isin_str_500": lambda: df[df["s"].isin(isin_values)].count("*"),
        "str_upper": lambda: df["s"].str.upper().evaluate(),
        "str_contains": lambda: df["s"].str.contains("3", regex=False).evaluate(),
        "str_len_sum": lambda: df["s"].str.len().sum(),
    }

    results = {}
    with cache.off():
        for name, fn in cases.items():
            fn()  # warm
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            results[name] = {"seconds": dt, "rows_per_s": n / dt}
            print(f"{name}: {dt*1e3:9.1f} ms  {n/dt/1e6:8.1f} M rows/s", flush=True)

    if args.check:
        got = cases["groupby_str_sum"]().sort("s").to_pandas_df()
        oracle = pdf.groupby("s", as_index=False)["x"].sum().sort_values("s")
        np.testing.assert_array_equal(got["s"].to_numpy(), oracle["s"].to_numpy())
        np.testing.assert_allclose(got["x"].to_numpy(), oracle["x"].to_numpy(),
                                   rtol=1e-6)
        got_isin = int(np.asarray(cases["isin_str_500"]()))
        oracle_isin = int(pdf["s"].isin(isin_values).sum())
        assert got_isin == oracle_isin, (got_isin, oracle_isin)
        print("oracle checks pass", flush=True)
    results["device"] = device
    print(json.dumps(results))


if __name__ == "__main__":
    main()
