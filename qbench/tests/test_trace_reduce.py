"""The reduction from trace to metrics: on a trace recorded on one H100
(``record_trace.py``: three H2O q1 queries at 1e6 rows) and on hand-made
events."""

import os

import pytest

from qbench import trace_reduce

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "q1_1e6.xplane.pb")


@pytest.fixture(scope="module")
def recorded():
    return trace_reduce.load(FIXTURE)


def test_recorded_spans_and_device(recorded):
    assert list(recorded["devices"]) == ["/device:GPU:0"]
    assert [q[0] for q in recorded["queries"]] == ["q1", "q1", "q1"]
    ws, we = recorded["window"]
    for _, s, e in recorded["queries"]:
        assert ws <= s < e <= we


def test_recorded_busy_union(recorded):
    dev = recorded["devices"]["/device:GPU:0"]
    busy = dev["busy"]
    assert all(a < b for a, b in busy)
    assert all(b1 <= a2 for (_, b1), (a2, _) in zip(busy, busy[1:]))  # disjoint, sorted
    union = sum(b - a for a, b in busy)
    assert 0 < union <= sum(dev["ops"].values())
    rows = trace_reduce.per_query(recorded)
    assert len(rows) == 3
    for span, covered in rows:
        assert 0 < covered < span


def test_recorded_breakdown(recorded):
    bd = trace_reduce.breakdown(recorded)
    ops = dict(bd["device_ops"])
    assert len(bd["device_ops"]) <= 10 and ops
    assert all(v > 0 for v in ops.values())
    # XLA runs the whole pass as a CUDA command buffer
    assert "command_buffer" in ops
    labels = {k for k, _ in bd["idle_gaps"]}
    assert labels <= {"query.q1", "between_queries"} and "query.q1" in labels
    ws, we = recorded["window"]
    idle = sum(v for _, v in bd["idle_gaps"])
    dev = recorded["devices"]["/device:GPU:0"]
    busy = trace_reduce.covered(dev["busy"], dev["busy_starts"], ws, we)
    assert idle * 1e9 + busy == pytest.approx(we - ws, rel=1e-9)


def test_recorded_has_no_collectives(recorded):
    assert recorded["devices"]["/device:GPU:0"]["collective"] == []


def hand_made():
    devices = {
        "/device:GPU:0": [(0, 10, "fusion"), (5, 20, "fusion"), (30, 40, "all-reduce.1"),
                          (100, 110, "fusion")],
        "/device:GPU:1": [(0, 20, "fusion"), (30, 50, "ncclDevKernel_AllReduce_Sum_f64"),
                          (100, 120, "fusion")],
        "/device:GPU:2": [],
    }
    spans = [("qbench.query.q1", 0, 60), ("qbench.window", -10, 200),
             ("qbench.query.q4", 90, 130), ("other", 0, 1)]
    return trace_reduce.reduce(devices, spans)


def test_hand_made_union_and_collectives():
    t = hand_made()
    assert set(t["devices"]) == {"/device:GPU:0", "/device:GPU:1"}  # no events: no device
    d0, d1 = t["devices"]["/device:GPU:0"], t["devices"]["/device:GPU:1"]
    assert d0["busy"] == [[0, 20], [30, 40], [100, 110]]
    assert d0["collective"] == [[30, 40]] and d1["collective"] == [[30, 50]]
    assert d0["ops"] == {"fusion": 35, "all-reduce.1": 10}
    assert t["window"] == [-10, 200]
    assert t["queries"] == [["q1", 0, 60], ["q4", 90, 130]]
    assert trace_reduce.per_query(t) == [(60, (30 + 40) / 2), (40, (10 + 20) / 2)]
    assert trace_reduce.per_query(t, key="collective") == [(60, 15.0), (40, 0.0)]


def test_hand_made_gaps_and_labels():
    t = hand_made()
    assert trace_reduce.gaps([[0, 20], [30, 40]], -10, 50) == [(-10, 0), (20, 30), (40, 50)]
    bd = trace_reduce.breakdown(t)
    idle = dict(bd["idle_gaps"])
    # a gap that runs from one query into the next is split at the spans:
    # device 0 idles 30 ns of q1 and 30 of q4, device 1 20 of each, and
    # both the 110 ns of the window outside the queries
    assert idle["query.q1"] == pytest.approx((30 + 20) / 2 / 1e9)
    assert idle["query.q4"] == pytest.approx((30 + 20) / 2 / 1e9)
    assert idle["between_queries"] == pytest.approx(110 / 1e9)
