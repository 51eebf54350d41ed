"""Join + isin benchmarks (reference: benchmarks/isin.py N=1e7..1e8 M=1..1e6;
BASELINE config 4: fact-vs-dim hash join).

Run: python benchmarks/join_isin.py [--n 1e7] [--dim 1e6]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=float, default=1e7)
    parser.add_argument("--dim", type=float, default=1e6)
    args = parser.parse_args()

    from benchmarks.device import announce
    device = announce()
    import vaex_tpu as vt
    from vaex_tpu import cache

    n = int(args.n)
    m = int(args.dim)
    rng = np.random.default_rng(42)
    fact = vt.from_arrays(
        key=rng.integers(0, m, n).astype(np.int64),
        x=rng.random(n),
    )
    dim = vt.from_arrays(
        key=np.arange(m, dtype=np.int64),
        label=rng.integers(0, 100, m).astype(np.int64),
    )
    fact._tile_rows = 1 << 22

    results = {}
    with cache.off():
        def timed(name, fn, warm=True):
            if warm:
                fn()
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            results[name] = {"seconds": dt, "rows_per_s": n / dt}
            print(f"{name:24s}: {dt*1e3:8.1f} ms  {n/dt/1e6:9.1f} M rows/s", flush=True)
            return out

        # join is lazy: time the plan (index build + probe) and the
        # materialization of a joined column separately
        j = timed("join_plan", lambda: fact.join(dim, on="key", allow_duplication=False))
        timed("join_materialize_sum", lambda: fact.join(dim, on="key").sum("label"))

        fact_dev = fact.to_device()  # device-resident for the selection passes
        fact_dev._tile_rows = 1 << 22
        values = rng.choice(m, 1000, replace=False).astype(np.int64)
        timed("isin_1000", lambda: np.asarray(
            fact_dev.count(selection=str(fact_dev["key"].isin(values)))))
        few = values[:10]
        timed("isin_10", lambda: np.asarray(
            fact_dev.count(selection=str(fact_dev["key"].isin(few)))))
    results["device"] = device
    print(json.dumps(results))


if __name__ == "__main__":
    main()
