"""``BENCHMARK.json``: its shape, the characters of its names and units,
and a file under ``qbench/`` for everything it names."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["qbench"]
    assert bench["command"] == ["python3", "qbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_name_has_its_file(bench):
    q = os.path.join(ROOT, "qbench")
    for c in bench["configs"]:
        assert c["file"].startswith("qbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        with open(os.path.join(q, "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        for query in traffic["queries"]:
            assert os.path.exists(os.path.join(q, "queries", query["op"] + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(q, "metrics", m["name"] + ".py")), m["name"]


def test_four_chip_cells_are_few(bench):
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
