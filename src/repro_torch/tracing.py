"""Spans on the request path, for an operator who runs the program under
``torch.profiler``.

``with span(name):`` marks one stage of a request.  A span records
exactly while a ``torch.profiler`` session records
(``torch.autograd._profiler_enabled()``: on the thread that started it,
and threads it hands its state to); otherwise ``span`` returns one shared
no-op context, and the check is all it costs.  While on, a span

- enters ``torch.profiler.record_function(name)``: it sits in the
  profiler's trace as a ``user_annotation`` event, on the clock of the
  kernels it launched;
- takes ``time.perf_counter_ns()`` at entry and at exit.

A span's work on the card is what the trace puts inside its range there
(the profiler's ``gpu_user_annotation`` event of the same name: the
kernels, copies and fills launched inside the span); the host clock of a
span does not time the card.

Finished spans are kept in memory, at most ``CAPACITY`` (later ones are
counted by ``dropped()``), as plain integers: a kept object the collector
tracks would advance its count, and so move the interpreter's garbage
collections into the window being traced.  ``records()`` returns them as
``Record`` tuples; ``clear()`` empties the list.  Each span knows its
parent (a stack a thread) and its root: every span of one request shares
the root's index.

The spans of a streamed request (``streaming.race_stream``,
``fast_path_stream``, ``classic_path_stream``):

  repro_torch.stream     the whole call: the request's root
  repro_torch.prepare    before the first chunk: checks, saturation depths,
                         the card layout, delay and offset placement, the
                         zero summary
  repro_torch.host_read  one device-to-host read, hence one synchronisation
                         (``engine.saturation_depths``,
                         ``streaming._card_layout``)
  repro_torch.place      the delay model placed on the table's device
                         (``latency.to_device``; a regime stream's delays
                         too)
  repro_torch.host_write one tensor of a delay model copied to another
                         device (``latency.to_device``), the mirror of
                         ``host_read``
  repro_torch.draws      all randomness of a chunk (``engine._draw_race``,
                         ``_fast_path_draws``, ``_classic_path_draws``)
  repro_torch.decide     a chunk's step from draws to decided outcomes: the
                         quorum kernels, the sorts and order statistics,
                         the masked saturation (draws made inside it are
                         its child spans)
  repro_torch.sketch     the chunk's reduction into the ``StreamSummary``
  repro_torch.readout    ``StreamSummary.quantile``'s device work
"""
from __future__ import annotations

import array
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

STREAM = "repro_torch.stream"
PREPARE = "repro_torch.prepare"
HOST_READ = "repro_torch.host_read"
PLACE = "repro_torch.place"
HOST_WRITE = "repro_torch.host_write"
DRAWS = "repro_torch.draws"
DECIDE = "repro_torch.decide"
SKETCH = "repro_torch.sketch"
READOUT = "repro_torch.readout"

CAPACITY = 100_000

_OFF = contextlib.nullcontext()
_IDS = itertools.count()
_LOCAL = threading.local()
_LOCK = threading.Lock()   # guards _DONE, _NAMES and _dropped
# finished spans, in the order they ended: _WIDTH integers each (the name's
# place in _NAMES, index, parent or -1, root, host start and end ns)
_DONE = array.array("q")
_WIDTH = 6
_NAMES: dict = {}
_dropped = 0


class Record(NamedTuple):
    """One finished span.  ``parent`` is None at a root; ``root`` is the
    index of the span's root (its own at a root)."""
    name: str
    index: int
    parent: Optional[int]
    root: int
    host_start_ns: int
    host_end_ns: int
    host_ms: float


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Span:
    __slots__ = ("name", "index", "parent", "root", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.index = next(_IDS)
        self.parent = st[-1].index if st else None
        self.root = st[0].index if st else self.index
        st.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        with _LOCK:
            if len(_DONE) < CAPACITY * _WIDTH:
                name = _NAMES.setdefault(self.name, len(_NAMES))
                _DONE.extend((name, self.index,
                              -1 if self.parent is None else self.parent,
                              self.root, self.t0, t1))
            else:
                _dropped += 1
        return False


def span(name: str):
    """A context marking one stage of a request; a shared no-op unless a
    ``torch.profiler`` session records."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """The finished spans, in the order they ended."""
    with _LOCK:
        done, names = _DONE.tolist(), list(_NAMES)
    out = []
    for i in range(0, len(done), _WIDTH):
        name, index, parent, root, t0, t1 = done[i:i + _WIDTH]
        out.append(Record(names[name], index, None if parent < 0 else parent,
                          root, t0, t1, (t1 - t0) * 1e-6))
    return out


def dropped() -> int:
    """Spans that ended after ``CAPACITY`` were kept."""
    return _dropped


def clear() -> None:
    global _dropped
    with _LOCK:
        del _DONE[:]
        _NAMES.clear()
        _dropped = 0
