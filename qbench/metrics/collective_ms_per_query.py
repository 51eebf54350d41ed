"""Per query, the time a device spent in collectives (all-reduce and the
like; union of those kernels, mean over the devices), averaged over the
traced queries, in ms.  Nothing to read on one device."""

from qbench.trace_reduce import per_query


def read(record):
    trace = record.get("trace")
    if not trace or not any(d["collective"] for d in trace["devices"].values()):
        return None
    rows = per_query(trace, key="collective")
    return sum(c for _, c in rows) / len(rows) / 1e6 if rows else None
