"""Device records (kernels, copies and fills) of the traced window, over
the chunks its requests streamed."""
from ffpbench import trace


def read(record):
    tr = record.get("trace")
    if not tr or not tr["spans"] or not tr["chunks"]:
        return None
    dev = trace.in_window(tr["device"], trace.window(tr["spans"]))
    return len(dev) / tr["chunks"] if dev else None
