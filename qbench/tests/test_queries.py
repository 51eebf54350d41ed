"""Each mix's queries through the engine against the plain reference at
1e5 rows, and the control (the reference in float32) against the limits."""

import json
import os

import pytest

from conftest import ROOT, SMALL_ROWS
from qbench import compare, control

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.fixture(scope="module", params=CELLS)
def readings(request):
    from qbench.run import resolve
    limits = resolve(ROOT, request.param)["traffic"]["limits"]
    rows = control.readings(ROOT, request.param, [11, 2**31 + 11], rows=SMALL_ROWS,
                            require_device=False)
    return limits, rows


def test_engine_within_limits(readings):
    limits, rows = readings
    for r in rows:
        assert compare.within(r["engine"], limits), r


def test_control_fails_a_limit(readings):
    limits, rows = readings
    for r in rows:
        assert not compare.within(r["control"], limits), r
        assert r["control"]["float_rel_err"] > limits["float_rel_err"]
