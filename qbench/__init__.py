"""Benchmark harness of the query engine: cells, traffic mixes, metric
readers and the plain reference that decides whether answers are correct.
See ``run.py``."""
