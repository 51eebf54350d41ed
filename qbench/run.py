"""Run one benchmark cell of the query engine and print its result.

    python qbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``qbench/configs/<name>.json``: the table's rows, columns and
distributions, and the chips it lies on) and a traffic mix
(``qbench/traffic/<name>.json``: the queries, each of a kind in
``qbench/queries/<op>.py``).  Metrics are read by ``qbench/metrics/<name>.py``.
A new cell, configuration, mix or metric is new files and entries; nothing
here changes.

One process, one run:

1. Require a GPU, and as many as the cell asks for; a CPU is an error.
2. Make the table on the device from ``--seed`` (rows split over a mesh on
   four chips).
3. Warm up the mix's queries on that table (set-up ends here).
4. The window: one client in a closed loop, as an analyst who waits for
   each answer before asking the next.  The queries come in rounds, each
   round the whole mix in an order drawn from the seed.  Each query ends
   in host numpy arrays.  The engine's task-result cache is off, so every
   answer is computed; the per-table state the engine builds on first use
   (key bounds, narrowed key copies, compiled passes) persists, as it
   would in a session.  With ``--trace 1`` the window is a short traced
   stretch of the same loop instead.
5. After the window: the device's peak memory is read, the engine's table
   is dropped, and a seeded sample of the answers is compared with the
   plain reference (``qbench/queries``) computed from the same table.

The last line of standard output is the result, one JSON object; the
numbers compared and their limits are the last lines of standard error and
the last key of the result.
"""

import time

T_START = time.time()  # set-up is counted from here

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import glob  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANSWERS_KEPT = 4  # answers of each query kept for the comparison
COMPILE_EVENTS = ("/jax/core/compile/backend_compile_duration",
                  "/jax/compilation_cache/cache_retrieval_time_sec")


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def load_module(path):
    spec = importlib.util.spec_from_file_location(
        "qbench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root, workload):
    """The cell's entry, configuration, traffic, and the metrics it reports."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "qbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


class CompileCounter:
    """JAX's compile and compile-cache events while ``on``."""

    def __init__(self):
        self.on, self.n = False, 0

    def __call__(self, event, duration, **kwargs):
        if self.on and event in COMPILE_EVENTS:
            self.n += 1


class Sample:
    """Up to ``k`` answers of each query, a uniform sample drawn from the
    seed over all the answers the window produced (reservoir sampling)."""

    def __init__(self, rng, k=ANSWERS_KEPT):
        self.rng, self.k, self.seen, self.kept = rng, k, {}, {}

    def offer(self, name, answer):
        n = self.seen[name] = self.seen.get(name, 0) + 1
        kept = self.kept.setdefault(name, [])
        if len(kept) < self.k:
            kept.append(answer)
        else:
            j = int(self.rng.integers(n))
            if j < self.k:
                kept[j] = answer


def rounds(queries, rng):
    """Endless rounds; each is the whole mix in an order drawn from rng, so
    every seed runs the same queries in the same proportions."""
    while True:
        for i in rng.permutation(len(queries)):
            yield queries[int(i)]


def copy_bandwidth(device, nbytes=1 << 32, reps=10):
    """Bytes per second read plus written by a large device-to-device copy."""
    import jax
    import jax.numpy as jnp
    x = jax.device_put(jnp.zeros(nbytes // 8, jnp.float64), device)
    copy = jax.jit(lambda a: a + 1.0)
    jax.block_until_ready(copy(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        y = copy(x)
    jax.block_until_ready(y)
    return 2 * nbytes * reps / (time.perf_counter() - t0)


def open_cell(root, workload, seed, rows=None, require_device=True):
    """Resolve the cell, check its devices, make its table from the seed
    and hand it to the engine.  Returns (spec, device, columns, DataFrame,
    devices used)."""
    spec = resolve(root, workload)
    chips = spec["cell"]["chips"]
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(root, ".jax_cache"))
    sys.path.insert(0, root)
    import jax
    from qbench import device, table
    dev = device.require_gpu(chips) if require_device else device.describe()
    import vaex_tpu as vt
    from vaex_tpu.parallel import data_mesh, distributed_executor
    jax.config.update("jax_enable_x64", True)
    # every program of the run goes to the persistent cache, so a second
    # run of the cell compiles nothing
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    if chips > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        mesh = data_mesh(chips)
        devices = list(mesh.devices.ravel())
        sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    else:
        devices = jax.devices()[:1]
        sharding = jax.sharding.SingleDeviceSharding(devices[0])
    n = int(rows or spec["config"]["rows"])
    t0 = time.perf_counter()
    cols = table.make_table(spec["config"], seed, n, sharding)
    log(f"table: {n} rows x {len(cols)} columns on {len(devices)} device(s) "
        f"in {time.perf_counter() - t0:.3f} s")
    df = vt.from_dataset(vt.DatasetArrays(dict(cols)))
    if chips > 1:
        df.executor = distributed_executor(chips)
    return spec, dev, cols, df, devices


def run_cell(root, workload, seed, seconds, trace, rows=None, require_device=True):
    """One run; returns the result dict.  ``rows`` and ``require_device``
    exist for the CPU tests, which run a cell at a small size."""
    spec, dev, cols, df, devices = open_cell(root, workload, seed, rows, require_device)
    config, traffic = spec["config"], spec["traffic"]
    n = len(cols[next(iter(cols))])
    qdir = os.path.join(root, "qbench")
    import jax
    import numpy as np
    import vaex_tpu as vt
    from vaex_tpu import cache
    from qbench import compare, device, trace_reduce
    counter = CompileCounter()
    jax.monitoring.register_event_duration_secs_listener(counter)
    executor = df.executor

    queries = traffic["queries"]
    kinds = {q["op"]: load_module(os.path.join(qdir, "queries", q["op"] + ".py"))
             for q in queries}
    rng = np.random.default_rng(seed)
    sample = Sample(np.random.default_rng([seed, 1]))
    latencies, qlog, failed = [], [], 0
    with cache.off():
        t0 = time.perf_counter()
        for _ in range(traffic["warmup_rounds"]):
            for q in queries:
                kinds[q["op"]].program(vt, df, q)
        log(f"warm-up: {traffic['warmup_rounds']} rounds of {len(queries)} queries "
            f"in {time.perf_counter() - t0:.3f} s")

        trace_dir = tempfile.mkdtemp(prefix="qbench_trace_") if trace else None
        if trace:
            # the benchmark's spans and the device's kernels only: the
            # Python tracer, and the runtime's own host events, would slow
            # the host several times over
            options = jax.profiler.ProfileOptions()
            options.python_tracer_level = 0
            options.host_tracer_level = 1
            jax.profiler.start_trace(trace_dir, profiler_options=options)
            span = jax.profiler.TraceAnnotation
            stop_after = (traffic["trace_queries"], traffic["trace_seconds"])
        else:
            span = lambda name: contextlib.nullcontext()  # noqa: E731
            stop_after = (1, seconds)
        order = rounds(queries, rng)
        setup_s = time.time() - T_START
        counter.on = True
        w0 = time.perf_counter()
        with span(trace_reduce.WINDOW_SPAN):
            while True:
                q = next(order)
                p0 = executor.passes
                t0 = time.perf_counter()
                try:
                    with span(trace_reduce.QUERY_PREFIX + q["name"]):
                        answer = kinds[q["op"]].program(vt, df, q)
                except Exception:  # a query that raises is counted as failed
                    failed += 1
                    answer = None
                    log(f"query {q['name']} failed:\n{traceback.format_exc()}")
                t1 = time.perf_counter()
                latencies.append(t1 - t0)
                qlog.append({"name": q["name"], "passes": executor.passes - p0,
                             "ok": answer is not None})
                if answer is not None:
                    sample.offer(q["name"], answer)
                if len(qlog) >= stop_after[0] and t1 - w0 >= stop_after[1]:
                    break
        window_s = time.perf_counter() - w0
        counter.on = False
    reduced = None
    if trace:
        jax.profiler.stop_trace()
        paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
        reduced = trace_reduce.load(paths[0])
        shutil.rmtree(trace_dir, ignore_errors=True)
    log(f"window: {len(qlog)} queries in {window_s:.3f} s, {failed} failed")

    stats = [d.memory_stats() or {} for d in devices]
    peaks = [s["peak_bytes_in_use"] for s in stats if "peak_bytes_in_use" in s]
    peak = max(peaks) if peaks else None
    del df, executor
    gc.collect()

    # the plain reference, from the same table, after the window
    t0 = time.perf_counter()
    readings, want = [], {}
    for q in queries:
        mod = kinds[q["op"]]
        want[q["name"]] = mod.reference(cols, q, config, np.float64)
        for got in sample.kept.get(q["name"], []):
            readings.append(compare.compare(got, want[q["name"]], mod.kinds(q, config)))
    checks = compare.fold(readings)
    checks["failed"] = failed
    limits = dict(traffic["limits"], failed=0)
    correct = all(checks[k] <= limits[k] for k in checks)
    log(f"reference: {len(readings)} answers compared in {time.perf_counter() - t0:.3f} s")

    by_name = {q["name"]: q for q in queries}
    for x in qlog:
        q = by_name[x["name"]]
        x["hbm_bytes"] = kinds[q["op"]].hbm_bytes(q, config, n, want[q["name"]])
    peak_bw = None
    if trace:
        with open(os.path.join(qdir, "peaks.json")) as f:
            known = json.load(f)
        if dev["platform"] == "gpu":
            if dev["kind"] not in known:
                raise RuntimeError(f"no peak bandwidth for {dev['kind']!r} in peaks.json")
            peak_bw = known[dev["kind"]]["hbm_bytes_per_s"]
            del cols
            gc.collect()
            print(f"copy: {copy_bandwidth(devices[0]):.6g} B/s read+written by a "
                  f"4 GiB device-to-device copy; peak {peak_bw:.6g} B/s (peaks.json); "
                  f"card: {'; '.join(device.card_lines())}", flush=True)
    record = {"rows_done": sum(n for x in qlog if x["ok"]), "window_s": window_s,
              "latencies_s": latencies, "setup_s": setup_s, "peak_bytes": peak,
              "queries": qlog, "compiles_in_window": counter.n, "trace": reduced,
              "peak_hbm_bytes_per_s": peak_bw}
    metrics = {}
    for m in spec["per_layer"] if trace else spec["end_to_end"]:
        value = load_module(os.path.join(qdir, "metrics", m["name"] + ".py")).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev["memory_peak_bytes"] = peak
    result = {"correct": correct, "attempted": len(qlog), "failed": failed,
              "metrics": metrics, "device": dev}
    busy = trace_reduce.window_busy(reduced) if reduced else None
    if busy is not None:
        s, e = reduced["window"]
        dev["busy_s"], dev["window_s"] = busy / 1e9, (e - s) / 1e9
        result["breakdown"] = trace_reduce.breakdown(reduced)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in checks}
    for k in checks:
        log(f"check {k}: {checks[k]!r} (limit {limits[k]!r})")
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
