"""Sketch readout (``StreamSummary.quantile`` and the counts to the host):
host clock around it, after a synchronise, averaged over the window's
requests of a ``--trace 1`` run."""


def read(record):
    r = record.get("readout_s")
    if not r:
        return None
    return 1e3 * sum(r) / len(r)
