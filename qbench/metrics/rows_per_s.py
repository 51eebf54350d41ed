"""Table rows scanned by the queries completed in the window, over the
window's whole length: every query scans the whole table."""


def read(record):
    return record["rows_done"] / record["window_s"] if record["rows_done"] else None
