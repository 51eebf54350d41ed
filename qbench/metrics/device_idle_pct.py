"""The share of the traced window in which a device ran nothing, mean over
the devices, in %."""

from qbench.trace_reduce import window_busy


def read(record):
    trace = record.get("trace")
    busy = window_busy(trace) if trace else None
    if busy is None:
        return None
    s, e = trace["window"]
    return 100.0 * (1.0 - busy / (e - s))
