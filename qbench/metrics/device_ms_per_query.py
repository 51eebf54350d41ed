"""Per query, the time a device was busy inside its span (union of its
kernels, mean over the devices), averaged over the traced queries, in ms."""

from qbench.trace_reduce import per_query


def read(record):
    rows = per_query(record["trace"]) if record.get("trace") else []
    busy = sum(b for _, b in rows)
    return busy / len(rows) / 1e6 if busy else None
