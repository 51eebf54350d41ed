"""90th percentile of the latency of every query in the window, in ms."""

import numpy as np


def read(record):
    lat = record["latencies_s"]
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
