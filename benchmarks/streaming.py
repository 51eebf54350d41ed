"""Out-of-core streaming benchmark: HDF5 mmap -> host stage -> H2D -> kernel.

The reference's core pitch is out-of-core throughput from mmap'd files
(README.md:9-11, dataset_mmap.py:70-110); the device-resident bench.py number
deliberately excludes the host->device leg.  This benchmark measures the
whole streaming pipeline: tiles are pulled from an on-disk HDF5 file by the
readahead thread, staged, shipped to the device and aggregated, double-buffered by
JAX's async dispatch.

Run: python benchmarks/streaming.py [--n 1e8] [--k 100] [--tile 2**22]
Prints per-phase timing + rows/s, and the executor trace showing
compute/transfer overlap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=float, default=1e8)
    parser.add_argument("--k", type=float, default=100)
    parser.add_argument("--tile", type=int, default=1 << 22)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--path", default=None)
    args = parser.parse_args()

    from benchmarks.device import announce
    device = announce()
    import vaex_tpu as vt
    from vaex_tpu import cache

    n, k = int(args.n), int(args.k)
    path = args.path or os.path.join(tempfile.gettempdir(), f"vt_stream_{n}_{k}.hdf5")
    if not os.path.exists(path):
        print(f"generating {path} ...", flush=True)
        rng = np.random.default_rng(42)
        chunk = 10_000_000
        parts = []
        for i0 in range(0, n, chunk):
            m = min(chunk, n - i0)
            parts.append(vt.from_arrays(i1=rng.integers(0, k, m).astype(np.int64),
                                        x=rng.random(m)))
        df_gen = parts[0] if len(parts) == 1 else vt.concat(parts)
        df_gen.export_hdf5(path)

    df = vt.open(path)  # np.memmap columns: zero-copy open
    df = df.categorize("i1", labels=list(range(k)))
    df._tile_rows = args.tile

    link_gbps = measure_link(args.tile)

    def run():
        return df.groupby("i1", agg={"s": vt.agg.sum("x"), "c": "count"}, sort=True)

    results = {}
    with cache.off():
        t0 = time.perf_counter()
        out = run()  # compile + first stream (cold page cache)
        cold = time.perf_counter() - t0
        assert int(np.asarray(out["c"].tolist()).sum()) == n
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    best = min(times)
    results["streaming_rows_per_s"] = n / best
    results["cold_seconds"] = cold
    results["warm_seconds"] = best
    # wire bytes: the categorical key ships as i32 (proven-range wire
    # narrowing, execution.py) + f64 value
    bytes_per_row = 12
    results["effective_GBps"] = n * bytes_per_row / best / 1e9
    results["link_GBps"] = link_gbps
    results["pct_of_link"] = 100.0 * results["effective_GBps"] / link_gbps
    print(f"streaming groupby: cold {cold:.2f}s, warm {best:.2f}s  "
          f"{n/best/1e6:.1f} M rows/s  ({results['effective_GBps']:.2f} GB/s "
          f"host->device pipeline = {results['pct_of_link']:.0f}% of the "
          f"measured {link_gbps:.2f} GB/s link)", flush=True)
    for entry in df.executor.trace_log[-3:]:
        print(f"  pass trace: {entry}", flush=True)
    results["device"] = device
    print(json.dumps(results))


def measure_link(tile_rows):
    """Raw host->device bandwidth for one tile's bytes (i32 key + f64
    value), the speed-of-light reference for the streaming pipeline."""
    import jax
    rng = np.random.default_rng(0)
    key = rng.integers(0, 100, tile_rows).astype(np.int32)
    val = rng.random(tile_rows)
    for _ in range(2):  # warm, then measure
        t0 = time.perf_counter()
        a = jax.device_put(key)
        b = jax.device_put(val)
        np.asarray(a[-1:]); np.asarray(b[-1:])
        dt = time.perf_counter() - t0
    return (key.nbytes + val.nbytes) / dt / 1e9


if __name__ == "__main__":
    main()
