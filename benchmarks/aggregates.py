"""Binned-statistics benchmarks (reference: benchmarks/aggregates.py asv suite:
count/mean over f64/f32; binby 10 / 1K / 1M bins for int keys).

Run: python benchmarks/aggregates.py [--n 1e7] [--device]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from benchmarks.fixtures import numerical  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=float, default=1e7)
    parser.add_argument("--device", action="store_true")
    args = parser.parse_args()

    from benchmarks.device import announce
    device = announce()
    import vaex_tpu as vt
    from vaex_tpu import cache

    n = int(args.n)
    df = numerical(n)
    if args.device:
        df = df.to_device()
    df._tile_rows = 1 << 22

    cases = {
        "count_star": lambda: df.count(),
        "minmax_x": lambda: df.minmax("x"),
        "mean_x_f64": lambda: df.mean("x"),
        "mean_x4_f32": lambda: df.mean("x4"),
        "sum_x_binby_i1_10": lambda: df.sum("x", binby=["i1_10"], limits=[[0, 10]], shape=10),
        "sum_x_binby_i1_1K": lambda: df.sum("x", binby=["i1_1K"], limits=[[0, 1000]], shape=1000),
        "sum_x_binby_i1_1M": lambda: df.sum("x", binby=["i1_1M"], limits=[[0, 1_000_000]],
                                            shape=1_000_000),
        "count_binby_x_128": lambda: df.count(binby=["x"], limits=[[0, 1]], shape=128),
        "mean_binby_2d_128": lambda: df.mean("x", binby=["x", "y"],
                                             limits=[[0, 1], [0, 1]], shape=128),
        "std_x": lambda: df.std("x"),
        "expr_agg": lambda: df.sum("x * y + x4"),
    }
    results = {}
    with cache.off():
        for name, fn in cases.items():
            fn()  # warm
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
            results[name] = {"seconds": dt, "rows_per_s": n / dt}
            print(f"{name:24s}: {dt*1e3:8.1f} ms  {n/dt/1e6:9.1f} M rows/s", flush=True)
    results["device"] = device
    print(json.dumps(results))


if __name__ == "__main__":
    main()
