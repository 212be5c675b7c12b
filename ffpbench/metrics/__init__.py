"""Metric readers, one file a metric, named as in ``BENCHMARK.json``.

Each file defines ``read(record) -> float | None``.  ``record`` is the
run's record (``run.py``): the cell's shapes, set-up seconds, request
latencies, window seconds and trials, and in a ``--trace 1`` run the
readout seconds and the traced window (``trace.py``).  A reader that finds
nothing to read returns None, and the harness leaves the metric out.
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(name: str):
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"ffpbench.metrics.{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(name: str, record: dict):
    value = load(name).read(record)
    return None if value is None else float(value)
