"""What the program's spans (``repro_torch.tracing``) cost on the card's
host, and where each cell of ``BENCHMARK.json`` spends the card's time by
span.

    python3 tools/span_cost.py [--cells A,B] [--seed N] [--seconds 2] \\
        [--rounds 1]

Prints the card (``nvidia-smi`` name and power limit), then one JSON line:

- ``span_us``: a span's cost in microseconds from loops of 10^5 spans,
  off (no profiler) and on (under ``torch.profiler``, CPU and CUDA
  activities);
- per cell, after a warm-up request, a profiled window of ``--seconds``
  run four times a round in turns, each after a full garbage collection --
  spans on, spans patched to the no-op, patched, on.  ``on`` and
  ``patched`` list their trials per second (host clock over whole
  requests, each answered on the host as ``ffpbench/sut.py`` answers it).
  From the last window with spans on: ``spans_per_request``, and per span
  name its count and host ms a request and ``busy_ms_per_mtrial``: the
  device time of the kernels, copies and fills that the profiler's trace
  puts inside the span's range on the card (its ``gpu_user_annotation``:
  the work launched inside the span), each record going to the innermost
  range that holds its midpoint, so a span's value is its self time;
  ``none`` takes the work outside every span (the answer's copies to the
  host).
  ``device_ms_per_mtrial`` is all of the trace's device time.
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from ffpbench import keys, run, trace  # noqa: E402
from ffpbench.sut import Program  # noqa: E402
from repro_torch import tracing  # noqa: E402

LOOP = 100_000
PREFIX = "repro_torch."


def _profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def span_cost_us() -> dict:
    def loop():
        t = time.perf_counter()
        for _ in range(LOOP):
            with tracing.span("repro_torch.cost"):
                pass
        return (time.perf_counter() - t) / LOOP * 1e6

    out = {"off": loop()}
    tracing.clear()
    with _profiler():
        out["on"] = loop()
    assert len(tracing.records()) == LOOP and not tracing.dropped()
    tracing.clear()
    return out


def busy_us(events: list) -> collections.Counter:
    """Device microseconds of the trace's kernels, copies and fills by the
    innermost ``repro_torch.*`` range on the card holding each one's
    midpoint (``none`` outside them all).  The ranges of one stream nest:
    a span's range holds those of the spans inside it, and spans one after
    another have ranges one after another."""
    marks = []
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") == "X" and e.get("cat") == "gpu_user_annotation"
                and name.startswith(PREFIX)):
            a = float(e["ts"])
            marks += [(a, 1, name), (a + float(e["dur"]), 0, name)]
    for _, ts, dur, _ in trace.parse(events)["device"]:
        marks.append((ts + dur / 2, 2, dur))
    out, open_ = collections.Counter(), []
    for _, kind, x in sorted(marks, key=lambda m: m[:2]):
        if kind == 1:
            open_.append(x)
        elif kind == 0:
            del open_[len(open_) - 1 - open_[::-1].index(x)]
        else:
            out[open_[-1][len(PREFIX):] if open_ else "none"] += x
    return out


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)


def window(prog, seed: int, first: int, seconds: float, dev):
    """Requests from ``first`` on for ``seconds``, under the profiler:
    (requests, seconds, the profiler).  The garbage of earlier windows (the
    profiler's parsed events hold cycles) is collected first, so no window
    pays for another's."""
    gc.collect()
    torch.cuda.synchronize(dev)
    with _profiler() as prof:
        i, t0 = first, time.perf_counter()
        while True:
            prog.readout(prog.stream(keys.request_key(seed, i)))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        took = time.perf_counter() - t0
    return i - first, took, prof


def cell_cost(name: str, seed: int, seconds: float, rounds: int,
              dev) -> dict:
    cell = run.load_cell(name)
    trials = int(cell["traffic"]["trials_per_request"])
    prog = Program(cell["config"], cell["traffic"], dev)
    prog.readout(prog.stream(keys.warmup_key(seed)))
    real, first, out = tracing.span, 0, {"on": [], "patched": []}
    for mode in ("on", "patched", "patched", "on") * rounds:
        tracing.clear()
        if mode == "patched":
            tracing.span = lambda name: tracing._OFF
        try:
            n, took, prof = window(prog, seed, first, seconds, dev)
        finally:
            tracing.span = real
        first += n
        out[mode].append(n * trials / took)
        if mode == "on":
            recs = tracing.records()
            mtrials = n * trials * 1e-6
            busy = busy_us(_events(prof))
            per = collections.defaultdict(lambda: {"count": 0,
                                                   "host_ms": 0.0})
            for r in recs:
                p = per[r.name[len(PREFIX):]]
                p["count"] += 1 / n
                p["host_ms"] += r.host_ms / n
            for k, us in busy.items():
                per[k]["busy_ms_per_mtrial"] = us * 1e-3 / mtrials
            out["spans_per_request"] = len(recs) / n
            out["per_span"] = dict(sorted(per.items()))
            out["device_ms_per_mtrial"] = sum(busy.values()) * 1e-3 / mtrials
        del prof
    tracing.clear()
    prog.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 27)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    run._environment()
    if not torch.cuda.is_available():
        print("span_cost: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.set_num_threads(1)
    dev = torch.device("cuda:0")
    torch.zeros(1, device=dev)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = (args.cells.split(",") if args.cells
             else [w["name"] for w in bench["workloads"]])
    result = {"span_us": span_cost_us(),
              "cells": {n: cell_cost(n, args.seed, args.seconds, args.rounds,
                                     dev) for n in names}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
