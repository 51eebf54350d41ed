"""A later change adds a configuration, a traffic mix, a metric and a cell
as new files and entries; the harness finds and runs them with no edit to
any file it has."""

import json
import os
import shutil

import pytest

from conftest import ROOT
from qbench.run import run_cell

NEW_METRIC = '''"""Median latency, in ms."""
import numpy as np


def read(record):
    return float(np.median(record["latencies_s"])) * 1e3
'''


@pytest.fixture
def extended(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "qbench"), root / "qbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: (root / "qbench" / p).read_bytes()
              for p in ("run.py", "compare.py", "table.py", "trace_reduce.py")}
    config = {"name": "tiny_h2o", "rows": 20_000, "chips": 1, "reduced": ["rows"],
              "columns": {"id1": {"dist": "uniform_int", "low": 1, "high": 7, "dtype": "int64"},
                          "v3": {"dist": "uniform_float", "low": 0.0, "high": 1.0,
                                 "dtype": "float64"}}}
    (root / "qbench" / "configs" / "tiny_h2o.json").write_text(json.dumps(config))
    traffic = {"name": "tiny_mix", "warmup_rounds": 1, "trace_queries": 2,
               "trace_seconds": 0.1,
               "queries": [{"name": "sum_v3", "op": "groupby", "by": ["id1"],
                            "aggs": {"v3": ["sum", "v3"]}},
                           {"name": "hist", "op": "binby", "stat": "mean", "column": "v3",
                            "by": "id1", "shape": 7, "limits": [0.5, 7.5]}],
               "limits": {"keys_off": 0, "exact_off": 0, "float_rel_err": 1e-9}}
    (root / "qbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(traffic))
    (root / "qbench" / "metrics" / "latency_p50_ms.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny_h2o", "source": "test", "reduced": ["rows"],
                             "file": "qbench/configs/tiny_h2o.json", "why": "test"})
    bench["workloads"].append({"name": "tiny.mix", "config": "tiny_h2o",
                               "traffic": "tiny_mix", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "latency_p50_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    yield root
    for p, data in before.items():
        assert (root / "qbench" / p).read_bytes() == data


def test_new_cell_runs_from_new_files(extended):
    r = run_cell(str(extended), "tiny.mix", 3, 0.2, False, require_device=False)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"rows_per_s", "latency_p90_ms", "setup_s", "latency_p50_ms"}
    assert r["metrics"]["latency_p50_ms"]["unit"] == "ms"


def test_existing_cells_do_not_report_the_new_metric(extended):
    r = run_cell(str(extended), "h2o_1e8.small_g", 3, 0.2, False, rows=20_000,
                 require_device=False)
    assert "latency_p50_ms" not in r["metrics"]
