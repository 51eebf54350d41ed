"""Each metric reader on a hand-made record."""

import os

import pytest

from qbench import trace_reduce
from qbench.run import load_module

METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics")


def read(name, record):
    return load_module(os.path.join(METRICS, name + ".py")).read(record)


def record(trace=True, devices=1):
    evs = {f"/device:GPU:{i}": [(0, 2e6, "fusion"), (12e6, 16e6, "fusion"),
                                (16e6, 17e6, "all-reduce.3" if devices > 1 else "fusion")]
           for i in range(devices)}
    spans = [("qbench.window", 0, 20e6), ("qbench.query.q1", 0, 10e6),
             ("qbench.query.q4", 10e6, 20e6)]
    return {"rows_done": 2_000, "window_s": 0.02, "latencies_s": [0.010] * 9 + [0.020],
            "setup_s": 12.5, "peak_bytes": 123, "compiles_in_window": 0,
            "queries": [{"name": "q1", "passes": 1, "hbm_bytes": 1.6e9},
                        {"name": "q4", "passes": 2, "hbm_bytes": 3.2e9}],
            "trace": trace_reduce.reduce(evs, spans) if trace else None,
            "peak_hbm_bytes_per_s": 3.2e12}


def test_end_to_end():
    r = record(trace=False)
    assert read("rows_per_s", r) == pytest.approx(1e5)
    assert read("latency_p90_ms", r) == pytest.approx(11.0)  # numpy's linear p90
    assert read("peak_device_bytes", r) == 123
    assert read("setup_s", r) == 12.5


def test_counts():
    r = record(trace=False)
    assert read("passes_per_query", r) == 1.5
    assert read("compiles_in_window", r) == 0


def test_trace_readers():
    r = record()
    # q1 busy 2 of 10 ms, q4 busy 5 of 10 ms
    assert read("device_ms_per_query", r) == pytest.approx(3.5)
    assert read("host_gap_ms_per_query", r) == pytest.approx(6.5)
    assert read("device_idle_pct", r) == pytest.approx(65.0)
    # 4.8e9 bytes at 3.2e12 B/s is 1.5 ms, against 7 ms busy
    assert read("query_hbm_roofline", r) == pytest.approx(100 * 1.5 / 7)
    assert read("collective_ms_per_query", r) is None  # one device: nothing to read


def test_trace_readers_on_four_devices():
    r = record(devices=4)
    assert read("collective_ms_per_query", r) == pytest.approx(0.5)
    assert read("device_ms_per_query", r) == pytest.approx(3.5)
    # four devices share the bytes: the share is a quarter of one device's
    assert read("query_hbm_roofline", r) == pytest.approx(100 * 1.5 / 7 / 4)


@pytest.mark.parametrize("name", ["device_ms_per_query", "host_gap_ms_per_query",
                                  "device_idle_pct", "query_hbm_roofline",
                                  "collective_ms_per_query"])
def test_trace_readers_without_trace(name):
    assert read(name, record(trace=False)) is None


def test_roofline_without_device_time():
    r = record()
    r["trace"] = trace_reduce.reduce({}, [("qbench.window", 0, 1), ("qbench.query.q1", 0, 1)])
    assert read("query_hbm_roofline", r) is None  # never 0 for a share
