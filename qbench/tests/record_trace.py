"""Record the small trace the reduction tests read: a few ms of H2O q1 at
1e6 rows on one GPU, inside the benchmark's own window and query spans.

    python qbench/tests/record_trace.py qbench/tests/data/q1_1e6.xplane.pb

Prints the trace's planes and lines, so a reader can see which are devices
and how the kernels are named.
"""

import glob
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(out_path):
    sys.path.insert(0, ROOT)
    import jax
    import numpy as np
    from qbench import device, table, trace_reduce
    device.require_gpu()
    import vaex_tpu as vt
    from vaex_tpu import cache
    from qbench.run import load_module, resolve
    spec = resolve(ROOT, "h2o_1e8.small_g")
    q1 = spec["traffic"]["queries"][0]
    cols = table.make_table(spec["config"], 7, 1_000_000,
                            jax.sharding.SingleDeviceSharding(jax.devices()[0]))
    df = vt.from_dataset(vt.DatasetArrays(dict(cols)))
    groupby = load_module(os.path.join(ROOT, "qbench", "queries", "groupby.py"))
    tmp = tempfile.mkdtemp(prefix="qbench_fixture_")
    with cache.off():
        for _ in range(3):
            groupby.program(vt, df, q1)
        jax.profiler.start_trace(tmp)
        with jax.profiler.TraceAnnotation(trace_reduce.WINDOW_SPAN):
            for _ in range(3):
                with jax.profiler.TraceAnnotation(trace_reduce.QUERY_PREFIX + q1["name"]):
                    groupby.program(vt, df, q1)
        jax.profiler.stop_trace()
    path = glob.glob(os.path.join(tmp, "**", "*.xplane.pb"), recursive=True)[0]
    shutil.copy(path, out_path)
    shutil.rmtree(tmp, ignore_errors=True)
    from jax.profiler import ProfileData
    for plane in ProfileData.from_file(out_path).planes:
        print(f"plane {plane.name!r}")
        for line in plane.lines:
            events = list(line.events)
            print(f"  line {line.name!r}: {len(events)} events")
            for ev in events[:3]:
                print(f"    {ev.name[:80]!r} {ev.start_ns} {ev.duration_ns} "
                      f"{[(k, str(v)[:40]) for k, v in ev.stats][:8]}")
    reduced = trace_reduce.load(out_path)
    print({k: len(v["busy"]) for k, v in reduced["devices"].items()}, reduced["window"],
          reduced["queries"], np.round(trace_reduce.per_query(reduced), 0).tolist())
    print(trace_reduce.breakdown(reduced))


if __name__ == "__main__":
    main(sys.argv[1])
