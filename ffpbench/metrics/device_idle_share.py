"""Percent of the traced window in which no kernel, copy or fill ran on the
card: 100 * (1 - union of the device records' intervals / window)."""
from ffpbench import trace


def read(record):
    tr = record.get("trace")
    if not tr or not tr["spans"]:
        return None
    w = trace.window(tr["spans"])
    dev = trace.in_window(tr["device"], w)
    if not dev or w[1] <= w[0]:
        return None
    busy = sum(b - a for a, b in trace.busy_intervals(dev, w))
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
