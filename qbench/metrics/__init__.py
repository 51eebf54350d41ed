"""Metric readers, one file per metric of ``BENCHMARK.json``, named as the
metric.  Each has ``read(record)``, which returns the metric's value from
the run's record (see ``run.py``), or None where the record holds nothing
to read, and the harness then leaves the metric out of the result."""
