"""Benchmark: single-key int64 groupby (sum + count) throughput on one GPU.

BASELINE config 1 (BASELINE.md / reference benchmarks/groupby.py): groupby
sum/count over a table with an int64 key of cardinality 100.  The
reference's headline claim is >1e9 rows/s for categorical-key groupby on a
CPU workstation (README.md:60); vs_baseline is measured against that.

The table is staged device-resident (``df.to_device()``) so the number
measures the fused binning + aggregation path, mirroring the reference whose
data sits in RAM.  A second leg streams the same kind of table from
memory-mapped host columns through the executor's tile stager.  Fails
unless JAX's default device is a GPU.  Prints the card's name and power
limit, then ONE JSON line.

Env knobs: VAEX_TPU_BENCH_N (rows), VAEX_TPU_BENCH_K (cardinality),
VAEX_TPU_BENCH_REPS, VAEX_TPU_BENCH_STREAM_N (streamed rows, 0 skips).
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def tile_for(n):
    """The largest tile of at most 2^24 rows that divides n, so the
    whole-pass loop needs no padding copy of the table."""
    for parts in range(1, 1024):
        if n % parts == 0 and n // parts <= (1 << 24):
            return n // parts
    return 1 << 24


def main():
    from benchmarks.device import announce
    dev = announce()

    N = int(float(os.environ.get("VAEX_TPU_BENCH_N", 4e8)))
    K = int(os.environ.get("VAEX_TPU_BENCH_K", 100))
    reps = int(os.environ.get("VAEX_TPU_BENCH_REPS", 5))

    import vaex_tpu as vt
    from vaex_tpu import cache

    rng = np.random.default_rng(42)
    keys_np = rng.integers(0, K, N, dtype=np.int64)
    x_np = rng.random(N)
    df = vt.from_arrays(i1=keys_np, x=x_np).to_device()
    df = df.categorize("i1", labels=list(range(K)))
    df._tile_rows = tile_for(N)

    def run():
        out = df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
        return out["c"].to_numpy(), out["s"].to_numpy()

    with cache.off():
        got_counts, got_sums = run()  # warmup + compile
        np.testing.assert_array_equal(got_counts, np.bincount(keys_np, minlength=K))
        np.testing.assert_allclose(got_sums, np.bincount(keys_np, weights=x_np, minlength=K),
                                   rtol=1e-6)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    del df

    best = min(times)
    median = sorted(times)[len(times) // 2]
    line = {
        "metric": "groupby_sum_count_rows_per_s",
        "value": N / best,
        "unit": "rows/s",
        "vs_baseline": N / best / 1e9,  # reference claim: >1e9 rows/s
        "reps": reps,
        "rep_times_s": times,
        "median_rows_per_s": N / median,
        "device": dev,
    }
    stream_n = int(float(os.environ.get("VAEX_TPU_BENCH_STREAM_N", 1e8)))
    if stream_n:
        line["streaming_rows_per_s"] = _streaming_leg(stream_n, K)
    print(json.dumps(line))


def _streaming_leg(N, K):
    """Rows/s of the same groupby over memory-mapped host columns: tiles
    are staged on the host and shipped to the card by the executor's
    transfer-ahead thread."""
    import vaex_tpu as vt
    from vaex_tpu import cache
    workdir = tempfile.mkdtemp(prefix="vt_bench_stream_")
    try:
        rng = np.random.default_rng(7)
        cols = {}
        for name, values in (("i1", rng.integers(0, K, N, dtype=np.int64)),
                             ("x", rng.random(N))):
            path = os.path.join(workdir, f"{name}.npy")
            np.save(path, values)
            cols[name] = np.load(path, mmap_mode="r")
        df = vt.from_arrays(**cols).categorize("i1", labels=list(range(K)))
        df._tile_rows = 1 << 22

        def run():
            out = df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)
            return out["c"].to_numpy()

        with cache.off():
            if int(run().sum()) != N:  # warm/compile
                raise AssertionError("streamed count total mismatch")
            best = None
            for _ in range(2):
                t0 = time.perf_counter()
                run()
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
        return N / best
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
