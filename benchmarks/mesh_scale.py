"""Virtual-mesh scale run: 1e7-row fused-mesh groupby + shuffle-join on
the 8-virtual-device CPU mesh.

Speed is NOT the point (8 virtual devices share the host's CPUs); the point is
that the mesh plans hold at 1e7 scale: correctness vs pandas, per-device
capacity ~ N/D * slack, and exchange bytes matching the accounting model
(rows_per_device * slack * row_bytes) that the weak-scaling test pins at
toy sizes (tests/test_multidevice.py:356).

Run:  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      JAX_PLATFORMS=cpu python benchmarks/mesh_scale.py
"""

import os
import sys
import time

import jax
jax.config.update("jax_enable_x64", True)

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import vaex_tpu as vt


def main():
    D = len(jax.devices())
    print(f"devices: {D} ({jax.default_backend()})")
    assert D >= 8, "needs the 8-virtual-device mesh"

    N = 10_000_000
    G_target = 1_000_000
    rng = np.random.default_rng(42)
    k = rng.integers(0, G_target, N).astype("i8") * 4097 + 1  # span 4e9 >> DENSE_RANGE_MAX: fused route
    x = rng.normal(0, 10, N)
    v = rng.integers(-(2 ** 40), 2 ** 40, N).astype("i8")

    # ---- fused-mesh groupby at 1e7 ----------------------------------------
    from vaex_tpu.parallel import distributed_executor
    from vaex_tpu import cache
    with cache.off():
        df = vt.from_arrays(k=k, x=x, v=v)
        df.executor = distributed_executor()
        t0 = time.perf_counter()
        out = df.groupby("k", agg={"c": "count", "s": vt.agg.sum("v"),
                                   "fx": vt.agg.sum("x"),
                                   "mn": vt.agg.min("x")}, sort=True)
        cols = {name: np.asarray(out[name].tolist())
                for name in ("k", "c", "s", "fx", "mn")}
        dt = time.perf_counter() - t0
        log = [t for t in df.executor.trace_log
               if isinstance(t, dict) and t.get("fused_mesh_groupby")]
    assert len(log) == 1, f"expected one fused-mesh exchange, got {len(log)}"
    e = log[0]
    print(f"fused-mesh groupby 1e7: {dt:.1f} s, {e['groups']} groups, "
          f"devices={e['devices']} exchanges={e['exchanges']} "
          f"set_build_passes={e['set_build_passes']}")

    # capacity accounting: per-device exchange capacity ~ (N/D) * slack
    capt_rows = e["capacity_rows_per_device"]
    model_rows = e["rows_per_device"] * e["slack"]
    ratio = capt_rows / model_rows
    print(f"per-device exchange capacity: {capt_rows} rows of "
          f"{e['row_bytes']} B (model rows/dev*slack = {model_rows}, "
          f"ratio {ratio:.2f})")
    assert 0.5 <= ratio <= 1.6, "exchange capacity off the accounting model"
    assert e["alltoall_bytes_per_device"] == capt_rows * e["row_bytes"]

    # correctness vs pandas
    import pandas as pd
    t0 = time.perf_counter()
    oracle = (pd.DataFrame({"k": k, "x": x, "v": v}).groupby("k")
              .agg(c=("x", "size"), s=("v", "sum"), fx=("x", "sum"),
                   mn=("x", "min")))
    print(f"pandas oracle: {time.perf_counter() - t0:.1f} s")
    np.testing.assert_array_equal(cols["k"], oracle.index.to_numpy())
    np.testing.assert_array_equal(cols["c"], oracle["c"].to_numpy())
    np.testing.assert_array_equal(cols["s"], oracle["s"].to_numpy())
    # float sums: cumsum-difference contract (near-zero group sums of
    # ~10 normal values need an absolute term)
    np.testing.assert_allclose(cols["fx"], oracle["fx"].to_numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(cols["mn"], oracle["mn"].to_numpy(), rtol=1e-12)
    print("groupby oracle check: OK (ints exact, floats 1e-6/1e-7)")

    # ---- shuffle-join at 1e7 x 1e6 ----------------------------------------
    from vaex_tpu.parallel.join import shuffle_join
    from vaex_tpu.parallel.mesh import data_mesh
    M = 1_000_000
    dim_k = np.arange(M, dtype="i8") * 4097 + 1
    dim_val = rng.normal(size=M)
    fact = vt.from_arrays(k=k)
    dim = vt.from_arrays(k=dim_k, val=dim_val)
    mesh = data_mesh()
    t0 = time.perf_counter()
    lookup, has_dups = shuffle_join(fact, dim, "k", "k", mesh)
    dt_join = time.perf_counter() - t0
    print(f"shuffle-join 1e7 x 1e6: {dt_join:.1f} s, dups={has_dups}")
    # oracle: every fact key is (k-1)/3 in the dim table
    expected = (k - 1) // 4097
    matched = lookup >= 0
    assert matched.all(), "all fact keys exist in the dim table"
    np.testing.assert_array_equal(lookup, expected)
    print("join oracle check: OK (lookup exact)")

    print("MESH SCALE RUN PASSED")


if __name__ == "__main__":
    main()
