"""Trials completed in the window, each decided for every system, over the
window's wall seconds (first request's call to the last one's readout)."""


def read(record):
    if record["window_s"] <= 0:
        return None
    return record["trials"] / record["window_s"]
