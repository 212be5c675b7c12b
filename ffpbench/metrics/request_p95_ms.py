"""95th percentile (linear between order statistics) of the latency of all
requests of the window, from the call into the entry to the answer on the
host."""
import numpy as np


def read(record):
    lat = record["latencies_s"]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
