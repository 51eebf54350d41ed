"""Per query, its span on the host less the time a device was busy inside
it (mean over the devices), averaged over the traced queries, in ms."""

from qbench.trace_reduce import per_query


def read(record):
    rows = per_query(record["trace"]) if record.get("trace") else []
    return sum(span - busy for span, busy in rows) / len(rows) / 1e6 if rows else None
