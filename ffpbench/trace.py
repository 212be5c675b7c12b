"""The traced window: ``torch.profiler`` over the first requests of a
``--trace 1`` run, reduced to plain records that the per-layer metrics
read (``metrics/<name>.py``).

The harness marks its own spans with ``record_function``: ``ffpbench.stream``
around the entry call and ``ffpbench.readout`` around the readout.  Device
records are the kernels, copies and fills the trace holds (categories
``kernel``, ``gpu_memcpy``, ``gpu_memset``); all times are microseconds on
the trace's clock.  The idle-share and launch arithmetic follows
``chip_smoke.py``'s profile phase (busy = device time of every kernel, copy
and fill), with busy taken as the union of the records' intervals.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "ffpbench."
NAME_CHARS = 120          # a device operation's name in the breakdown


class Profiler:
    """Starts and stops ``torch.profiler`` and hands back the parsed trace."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> None:
        self._prof.stop()

    def records(self) -> Dict[str, list]:
        """{"device": [(name, start, dur, category)], "spans": [(name,
        start, dur)]}, from the exported trace (written to ``TMPDIR`` and
        removed)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        return parse(events)


def parse(events: list) -> Dict[str, list]:
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATEGORIES:
            device.append((name, float(e["ts"]), float(e["dur"]), cat))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((name, float(e["ts"]), float(e["dur"])))
    device.sort(key=lambda r: r[1])
    spans.sort(key=lambda r: r[1])
    return {"device": device, "spans": spans}


def window(spans: List[tuple]) -> Tuple[float, float]:
    """From the first entry call to the last readout's end."""
    return (min(s[1] for s in spans), max(s[1] + s[2] for s in spans))


def in_window(device: List[tuple], w: Tuple[float, float]) -> List[tuple]:
    return [d for d in device if d[1] < w[1] and d[1] + d[2] > w[0]]


def busy_intervals(device: List[tuple], w: Tuple[float, float]) -> list:
    """The union of the device records' intervals, clipped to ``w``."""
    out = []
    for _, ts, dur, _ in sorted(device, key=lambda r: r[1]):
        a, b = max(ts, w[0]), min(ts + dur, w[1])
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(busy: list, w: Tuple[float, float]) -> List[Tuple[float, float]]:
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def span_at(spans: List[tuple], t: float) -> str:
    """The harness span the host was in at ``t``, else ``harness``."""
    for name, ts, dur in spans:
        if ts <= t < ts + dur:
            return name
    return "harness"


def breakdown(rec: Dict[str, list], top: int = 10) -> dict:
    """The busiest device operations by summed seconds, and the longest
    idle gaps labelled by the host span they fell in."""
    w = window(rec["spans"])
    dev = in_window(rec["device"], w)
    by: Dict[str, float] = {}
    for name, _, dur, _ in dev:
        by[name] = by.get(name, 0.0) + dur * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps(busy_intervals(dev, w), w)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[span_at(rec["spans"], (a + b) / 2),
                           (b - a) * 1e-6] for a, b in gaps[:top]]}


def kernel_time(rec: Dict[str, list], pattern) -> Tuple[float, int]:
    """(microseconds, launches) of the window's kernels whose name matches
    ``pattern`` (a compiled regex), each with the fill that the card ran
    just before it (the kernel's own output zeroing)."""
    w = window(rec["spans"])
    dev = in_window(rec["device"], w)
    us, launches = 0.0, 0
    for i, (name, _, dur, cat) in enumerate(dev):
        if cat == "kernel" and pattern.search(name):
            us += dur
            launches += 1
            if i and dev[i - 1][3] == "gpu_memset":
                us += dev[i - 1][2]
    return us, launches


def peaks(kind: str) -> dict:
    """The published peaks of the card ``kind`` names (``peaks.json``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "peaks.json")) as fh:
        table = json.load(fh)
    for key, row in table.items():
        if key != "source" and key in kind:
            return row
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")
