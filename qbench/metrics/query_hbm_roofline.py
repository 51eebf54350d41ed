"""The traced queries' share of the HBM roofline: the bytes they must move
at least (each column read once, plus the answer; the query module's
``hbm_bytes``) over the peak bandwidth of the devices, against the time the
devices were busy inside the queries' spans."""

from qbench.trace_reduce import per_query


def read(record):
    trace, peak = record.get("trace"), record.get("peak_hbm_bytes_per_s")
    rows = per_query(trace) if trace else []
    busy_s = sum(b for _, b in rows) / 1e9 * len(trace["devices"]) if rows else 0.0
    if not busy_s or not peak:
        return None
    moved = sum(q["hbm_bytes"] for q in record["queries"])
    return 100.0 * moved / peak / busy_s
