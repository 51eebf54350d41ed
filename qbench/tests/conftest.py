"""CPU tests of the benchmark harness: ``python -m pytest qbench/tests``.

They run on JAX's CPU backend with four virtual devices (the mesh cell's
layout), set before JAX starts, and at small table sizes."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SMALL_ROWS = 100_000  # the tests' table: every mix's queries, at 1e5 rows
