"""Smoke run of the engine on NVIDIA GPUs, at the H2O db-benchmark's
groupby table of 1e8 rows (id1..id6 int64 keys, v1..v3 values: 7.2 GB).

    python chip_smoke.py               # one card: the main path
    python chip_smoke.py --multichip   # four cards: the mesh path only

Phases, in order; the first failure ends the run with a non-zero exit:

1. device: JAX's default device must be a GPU (no CPU fallback); prints
   the card's name and power limit from nvidia-smi;
2. main path on a device-resident table (``from_arrays(...).to_device()``):
   H2O q1 (small-grid sum), q3 (1e6 groups: sum + mean), q7 (1e6 groups:
   max + min), a 1000-bin binned mean, ``isin`` against 1e4 values and a
   join against a right table of n/100 rows, each checked against a numpy
   oracle;
3. streamed path: q1 again over memory-mapped host columns, through the
   executor's tile stager and transfer-ahead thread.

``--multichip`` runs only the mesh phase: q1 and q3 under
``parallel.distributed_executor()``, the shuffle groupby and the shuffle
join, each checked against the numpy oracle and the one-card result.

Integer results must match exactly; float results within rtol=1e-6,
atol=1e-7.  The last line of standard output is one JSON object naming the
device as JAX reports it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

RTOL, ATOL = 1e-6, 1e-7
N_ROWS = 100_000_000  # the H2O groupby table's 1e8 rows


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- device
def phase_device(expect_count=None):
    """Require a GPU; print what the run is measured on."""
    import jax
    from benchmarks.device import card_lines, require_gpu
    dev = require_gpu()
    if expect_count is not None and dev["count"] < expect_count:
        raise RuntimeError(f"needs {expect_count} GPUs, JAX sees {dev['count']}")
    log(f"device: platform={dev['platform']} kind={dev['kind']} count={dev['count']}")
    cards = card_lines()
    for line in cards:
        log(f"card: {line}")
    log(f"jax {jax.__version__}")
    for mod in ("pyarrow", "h5py", "pandas"):
        try:
            importlib.import_module(mod)
            log(f"module {mod}: importable")
        except ImportError:
            log(f"module {mod}: absent")
    dev["card"] = cards[0]
    return dev


# -------------------------------------------------------------------- oracles
def group_index(keys):
    """(sorted unique keys, inverse index) of an int64 key column."""
    lo, hi = int(keys.min()), int(keys.max())
    if hi - lo < 50_000_000:  # small ranges: counting instead of sorting
        present = np.bincount(keys - lo, minlength=hi - lo + 1) > 0
        rank = np.cumsum(present) - 1
        return np.flatnonzero(present) + lo, rank[keys - lo]
    return np.unique(keys, return_inverse=True)


def group_sum_int(inv, G, values):
    out = np.bincount(inv, weights=values, minlength=G)
    if np.abs(out).max(initial=0) >= 2 ** 53:
        raise ValueError("integer oracle sums past 2^53 are not exact in float64")
    return out.astype(np.int64)


def group_extremes_small_range(inv, G, values):
    """(per-group min, max) of integer values spanning < 64 distinct
    levels, from one bincount over (group, level)."""
    lo = int(values.min())
    width = int(values.max()) - lo + 1
    if width > 64:
        raise ValueError("value range too wide for the counting oracle")
    seen = np.bincount(inv.astype(np.int64) * width + (values - lo),
                       minlength=G * width).reshape(G, width) > 0
    levels = np.arange(width)
    mn = np.where(seen, levels, width).min(axis=1) + lo
    mx = np.where(seen, levels, -1).max(axis=1) + lo
    return mn, mx


def check_exact(name, got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)


def check_close(name, got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=RTOL, atol=ATOL, equal_nan=True, err_msg=name)


# ---------------------------------------------------------------------- table
def build_table(n, seed):
    from benchmarks.fixtures import h2o_arrays
    return h2o_arrays(n, k=100, seed=seed)


def join_right(n_right, key_span, seed):
    """A right table of unique keys drawn from 1..2*key_span, so about
    half of the left rows find a match."""
    rng = np.random.default_rng(seed + 1)
    keys = rng.permutation(2 * key_span)[:n_right].astype(np.int64) + 1
    return {"rk": keys, "w": rng.integers(0, 1000, n_right, dtype=np.int64),
            "z": rng.random(n_right)}


def isin_values(n_values, key_span, seed):
    rng = np.random.default_rng(seed + 2)
    return np.sort(rng.choice(2 * key_span, size=n_values, replace=False) + 1).astype(np.int64)


# ---------------------------------------------------------------- the queries
def _cols(out, names):
    return {c: out[c].to_numpy() for c in names}


def q1(vt, df):
    return _cols(df.groupby(["id1"], agg={"v1": "sum"}, sort=True), ["id1", "v1"])


def q3(vt, df):
    out = df.groupby(["id3"], agg={"v1": "sum", "v3": vt.agg.mean("v3")}, sort=True)
    return _cols(out, ["id3", "v1", "v3"])


def q7(vt, df):
    out = df.groupby(["id3"], agg={"max_v1": vt.agg.max("v1"),
                                   "min_v2": vt.agg.min("v2")}, sort=True)
    return _cols(out, ["id3", "max_v1", "min_v2"])


BINBY_SHAPE = 1000
# id4 in 1..100 lands mid-bin: (id4 - 0.45) * 10 is never near an edge
BINBY_LIMITS = [0.45, 100.45]


def binby_mean(vt, df):
    return np.asarray(df.mean("v3", binby="id4", shape=BINBY_SHAPE,
                              limits=BINBY_LIMITS))


def oracle_q1(t):
    keys, inv = group_index(t["id1"])
    return {"id1": keys, "v1": group_sum_int(inv, len(keys), t["v1"])}


def oracle_q3_q7(t):
    keys, inv = group_index(t["id3"])
    G = len(keys)
    counts = np.bincount(inv, minlength=G)
    mn_v2, _ = group_extremes_small_range(inv, G, t["v2"])
    _, mx_v1 = group_extremes_small_range(inv, G, t["v1"])
    q3o = {"id3": keys, "v1": group_sum_int(inv, G, t["v1"]),
           "v3": np.bincount(inv, weights=t["v3"], minlength=G) / counts}
    q7o = {"id3": keys, "max_v1": mx_v1, "min_v2": mn_v2}
    return q3o, q7o


def oracle_binby(t):
    lo, hi = BINBY_LIMITS
    b = np.floor((t["id4"] - lo) * (BINBY_SHAPE / (hi - lo))).astype(np.int64)
    s = np.bincount(b, weights=t["v3"], minlength=BINBY_SHAPE)
    c = np.bincount(b, minlength=BINBY_SHAPE)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(c > 0, s / c, np.nan)


def check_q(name, got, want, exact):
    for col, w in want.items():
        if col in exact:
            check_exact(f"{name}.{col}", got[col], w)
        else:
            check_close(f"{name}.{col}", got[col], w)


class Timer:
    """Cold (compile + first run) and warm wall time of each query, up to
    a materialised host result."""

    def __init__(self, n, card):
        self.n, self.card = n, card
        self.rows = []

    def run(self, name, fn, reps=2):
        t0 = time.perf_counter()
        out = fn()
        cold = time.perf_counter() - t0
        warm = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
            warm = dt if warm is None else min(warm, dt)
        log(f"{name}: compile+first {cold:.3f} s, warm {warm:.6f} s, "
            f"{self.n / warm:.6g} rows/s [{self.card}]")
        self.rows.append((name, cold, warm))
        return out


def phase_main(t, card, n_isin=10_000, seed=42):
    """Device-resident main path, every answer against its numpy oracle."""
    import vaex_tpu as vt
    from vaex_tpu import cache
    n = len(t["id1"])
    key_span = n // 100
    join_rows = max(key_span, 1)
    t0 = time.perf_counter()
    df = vt.from_arrays(**t).to_device()
    log(f"to_device: {time.perf_counter() - t0:.3f} s for {n} rows")
    timer = Timer(n, card)

    t0 = time.perf_counter()
    o1 = oracle_q1(t)
    o3, o7 = oracle_q3_q7(t)
    ob = oracle_binby(t)
    log(f"oracles: {time.perf_counter() - t0:.3f} s")

    with cache.off():
        check_q("q1", timer.run("q1", lambda: q1(vt, df)), o1, {"id1", "v1"})
        log("q1 matches the oracle")
        check_q("q3", timer.run("q3", lambda: q3(vt, df)), o3, {"id3", "v1"})
        log("q3 matches the oracle")
        check_q("q7", timer.run("q7", lambda: q7(vt, df)), o7,
                {"id3", "max_v1", "min_v2"})
        log("q7 matches the oracle")
        check_close("binby", timer.run("binby_mean_1000", lambda: binby_mean(vt, df)), ob)
        log("binby mean matches the oracle")

        vals = isin_values(min(n_isin, 2 * key_span), key_span, seed)
        sel = df["id6"].isin(vals)
        want_mask = np.isin(t["id6"], vals)

        def isin_query():
            return (int(df.count(selection=sel)), int(df.sum("v1", selection=sel)))
        got = timer.run(f"isin_{len(vals)}", isin_query)
        check_exact("isin", got, (int(want_mask.sum()), int(t["v1"][want_mask].sum())))
        log("isin matches the oracle")

        r = join_right(join_rows, key_span, seed)
        right = vt.from_arrays(**r)

        def join_query():
            j = df.join(right, left_on="id3", right_on="rk")
            return j["w"].to_numpy(), j["z"].to_numpy()
        w, z = timer.run(f"join_{n}x{join_rows}", join_query)
        pos = np.full(2 * key_span + 2, -1, np.int64)
        pos[r["rk"]] = np.arange(join_rows)
        row = pos[t["id3"]]
        hit = row >= 0
        check_exact("join.matched", ~np.ma.getmaskarray(w), hit)
        check_exact("join.w", np.ma.getdata(w)[hit], r["w"][row[hit]])
        check_close("join.z", np.ma.getdata(z)[hit], r["z"][row[hit]])
        log(f"join matches the oracle ({int(hit.sum())} of {n} rows matched)")

    import jax
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")
    return timer.rows


def phase_streamed(t, card, workdir):
    """q1 over memory-mapped host columns (no .to_device())."""
    import vaex_tpu as vt
    from vaex_tpu import cache
    cols = {}
    for name in ("id1", "v1"):
        path = os.path.join(workdir, f"{name}.npy")
        np.save(path, t[name])
        cols[name] = np.load(path, mmap_mode="r")
    df = vt.from_arrays(**cols)
    timer = Timer(len(t["id1"]), card)
    with cache.off():
        got = timer.run("q1_streamed", lambda: q1(vt, df))
    check_q("q1_streamed", got, oracle_q1(t), {"id1", "v1"})
    log("q1_streamed matches the oracle")
    return timer.rows


def phase_multichip(t, card, n_devices=4, seed=42):
    """q1/q3 under the distributed executor, the shuffle groupby and the
    shuffle join: each against the numpy oracle and the one-card result."""
    import vaex_tpu as vt
    from vaex_tpu import cache
    from vaex_tpu.parallel import data_mesh, distributed_executor
    from vaex_tpu.parallel.join import shuffle_join_lookup
    from vaex_tpu.parallel.shuffle import shuffle_groupby
    n = len(t["id1"])
    key_span = n // 100
    mesh = data_mesh(n_devices)
    log(f"mesh: {mesh.size} devices {[d.id for d in mesh.devices.ravel()]}")
    timer = Timer(n, card)
    o1 = oracle_q1(t)
    o3, _ = oracle_q3_q7(t)
    dist = vt.from_arrays(**t)
    dist.executor = distributed_executor(n_devices)
    t0 = time.perf_counter()
    dist = dist.to_device()  # each device receives its own rows
    log(f"to_device (sharded over {mesh.size} devices): "
        f"{time.perf_counter() - t0:.3f} s for {n} rows")
    queries = (("q1", q1, o1, {"id1", "v1"}), ("q3", q3, o3, {"id3", "v1"}))
    with cache.off():
        mesh_out = {}
        for name, fn, want, exact in queries:
            mesh_out[name] = got = timer.run(f"{name}_mesh", lambda: fn(vt, dist))
            check_q(f"{name}_mesh", got, want, exact)
            log(f"{name}_mesh matches the oracle")
        log_peaks(mesh, "after the mesh queries")
        del dist
        one = vt.from_arrays(**t).to_device()  # the one-card reference, device 0
        for name, fn, want, exact in queries:
            check_q(f"{name}_mesh_vs_one_card", mesh_out[name], fn(vt, one), exact)
            log(f"{name}_mesh matches the one-card result")
        del one

        keys, inv = group_index(t["id3"])
        G = len(keys)
        codes = np.zeros(int(keys.max()) + 1, np.int64)
        codes[keys] = np.arange(G)
        df_codes = vt.from_arrays(code=codes[t["id3"]].astype(np.int32), v1=t["v1"])
        got = timer.run("shuffle_groupby", lambda: shuffle_groupby(
            df_codes, "code", ["v1"], G, mesh))
        single = vt.from_arrays(code=codes[t["id3"]], v1=t["v1"]).sum(
            "v1", binby="code", limits=[-0.5, G - 0.5], shape=G)
        check_exact("shuffle_groupby.count", got["count"], np.bincount(inv, minlength=G))
        check_exact("shuffle_groupby.v1", got["v1"], group_sum_int(inv, G, t["v1"]))
        check_exact("shuffle_groupby_vs_one_card", got["v1"], np.asarray(single))
        log("shuffle_groupby matches the oracle and the one-card result")

        r = join_right(max(key_span, 1), key_span, seed)
        lookup, overflow, dups = timer.run("shuffle_join", lambda: shuffle_join_lookup(
            mesh, t["id3"], r["rk"]))
        if overflow or dups:
            raise AssertionError(f"shuffle join: overflow={overflow} dups={dups}")
        pos = np.full(2 * key_span + 2, -1, np.int64)
        pos[r["rk"]] = np.arange(len(r["rk"]))
        check_exact("shuffle_join.lookup", np.asarray(lookup), pos[t["id3"]])
        j = vt.from_arrays(id3=t["id3"]).join(vt.from_arrays(**r), left_on="id3",
                                                right_on="rk")
        check_exact("shuffle_join_vs_one_card", np.asarray(lookup) >= 0,
                    ~np.ma.getmaskarray(j["w"].to_numpy()))
        log("shuffle_join matches the oracle and the one-card result")
    log_peaks(mesh, "at the end")
    return timer.rows


def log_peaks(mesh, when):
    for d in mesh.devices.ravel():
        stats = d.memory_stats() or {}
        log(f"device {d.id} peak_bytes_in_use {when}: "
            f"{stats.get('peak_bytes_in_use', 'not reported')}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--multichip", action="store_true",
                        help="run only the four-card mesh phase")
    args = parser.parse_args(argv)
    n = N_ROWS

    dev = phase_device(expect_count=4 if args.multichip else None)
    t0 = time.perf_counter()
    t = build_table(n, args.seed)
    log(f"table: {n} rows x {len(t)} columns generated in "
        f"{time.perf_counter() - t0:.3f} s (seed {args.seed})")
    if args.multichip:
        phase_multichip(t, dev["card"], seed=args.seed)
    else:
        phase_main(t, dev["card"], seed=args.seed)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phase_streamed(t, dev["card"], workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"],
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
