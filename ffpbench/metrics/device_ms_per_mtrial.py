"""Summed device time (kernels, copies, fills) of the traced window, in ms,
per 10^6 trials its requests decided."""
from ffpbench import trace


def read(record):
    tr = record.get("trace")
    if not tr or not tr["spans"] or not tr["trials"]:
        return None
    dev = trace.in_window(tr["device"], trace.window(tr["spans"]))
    if not dev:
        return None
    return sum(d[2] for d in dev) * 1e-3 / (tr["trials"] * 1e-6)
