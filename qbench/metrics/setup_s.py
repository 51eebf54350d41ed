"""Process start to the first timed query: imports, the table made on the
device, warm-up (and compilation, where the compile cache misses)."""


def read(record):
    return record["setup_s"]
