"""Passes over the table the executor made per query (``executor.passes``),
mean over the window's queries."""


def read(record):
    q = record["queries"]
    return sum(x["passes"] for x in q) / len(q) if q else None
