"""The command fails, and prints no result, without a GPU, and for a name
it does not know."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "qbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def no_result(out):
    for line in out.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        return False
    return True


@pytest.mark.parametrize("workload", ["h2o_1e8.small_g", "no_such_cell"])
def test_fails_on_a_cpu(workload):
    p = run(ROOT, "--workload", workload, "--seed", "3000000019", "--seconds", "1",
            "--trace", "0")
    assert p.returncode != 0 and no_result(p.stdout)


def test_fails_with_the_benchmark_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "qbench"), tmp_path / "qbench")
    p = run(tmp_path, "--workload", "h2o_1e8.small_g", "--seed", "1", "--seconds", "1",
            "--trace", "1")
    assert p.returncode != 0 and no_result(p.stdout)
