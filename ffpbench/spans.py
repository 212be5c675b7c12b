"""The program's own spans (``repro_torch.tracing``) of a ``--trace 1``
run, for the per-layer readers that read them.

The program records spans only while a ``torch.profiler`` session records
in its process, so what ``tracing.records()`` holds once the window has
closed is the traced window's.  The first reader of a run takes those
records and empties the program's list (the run's record keeps them for
the other readers), so a process that runs several cells reads each its
own.  They are read only if they hold one ``repro_torch.stream`` root a
traced request; else, or where the program has no ``repro_torch.tracing``,
there is nothing to read (None).
"""
from __future__ import annotations

STREAM = "repro_torch.stream"


def of_run(record: dict):
    """The program's span records of the traced window, or None."""
    tr = record.get("trace")
    if not tr or not tr.get("requests"):
        return None
    if "program_spans" not in tr:
        try:
            from repro_torch import tracing
        except ImportError:
            return None
        tr["program_spans"] = tracing.records()
        tracing.clear()
    recs = tr["program_spans"]
    if sum(r.name == STREAM for r in recs) != tr["requests"]:
        return None
    return recs


def per_request(record: dict, name: str, host_ms: bool = False):
    """The spans named ``name`` per traced request: their count, or their
    summed host ms where ``host_ms``."""
    recs = of_run(record)
    if recs is None:
        return None
    mine = [r for r in recs if r.name == name]
    v = sum(r.host_ms for r in mine) if host_ms else len(mine)
    return v / record["trace"]["requests"]
