"""The device allocator's peak bytes in use, read right after the window,
on the fullest of the cell's devices."""


def read(record):
    return record["peak_bytes"]
