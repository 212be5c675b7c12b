"""repro_torch.tracing: spans on the stream path record only under
``torch.profiler``, one draws / decide / sketch span a chunk in every
lowering, the reads to the host and the delay's copies to the table's
device counted, and the summary the same bits with tracing on and off."""
import collections
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.quorum import QuorumSpec
from repro_torch.montecarlo import engine, regimes, streaming

SYSTEMS = [QuorumSpec(5, 4, 2, 4), QuorumSpec(5, 3, 3, 4)]
N, TRIALS, CHUNK = 5, 2500, 1024            # 3 chunks, the last ragged
CHUNKS = -(-TRIALS // CHUNK)
FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided", "mean_ms",
          "max_ms", "hist")


def _table(kind):
    return engine.build_mask_table(SYSTEMS, device="cpu",
                                   specialize=kind == "card")


def _stream(path, table, **kw):
    kw = dict(n=N, trials=TRIALS, chunk=CHUNK, shard=False, **kw)
    if path == "race":
        return streaming.race_stream(3, table, [0.0, 0.2], k_proposers=2,
                                     **kw)
    return getattr(streaming, f"{path}_stream")(3, table, **kw)


def _traced(fn):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    recs = tracing.records()
    tracing.clear()
    return out, recs, prof


def test_off_without_a_profiler(monkeypatch):
    """No profiler: ``span`` is the shared no-op, enters no
    ``record_function`` and keeps nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracing.clear()
    assert tracing.span(tracing.DRAWS) is tracing.span(tracing.STREAM)
    s = _stream("race", _table("masked"))
    s.quantile([0.5, 0.99])
    assert tracing.records() == []


# (table, path, extra args, host reads, draws nested in decide)
CASES = [
    ("card", "race", {}, 2, False),             # race_card_hist
    ("masked", "race", {}, 6, False),           # stream_tally_decide_hist
    ("card", "fast_path", {}, 2, False),        # sorted prefix, shared cols
    ("masked", "fast_path", {}, 6, True),       # _chunk_outcomes + update
    ("card", "classic_path", {}, 2, False),
    ("card", "race", {"k_max": None}, 0, True),  # full-sort lowering
    ("masked", "race",
     {"regimes": regimes.MarkovRegimes(names=("only",), delays=(None,),
                                       transition=torch.ones((1, 1)))},
     6, True),                                  # the regime chunk loop
]


@pytest.mark.parametrize("kind,path,kw,reads,nested", CASES,
                         ids=[f"{c[0]}-{c[1]}-{i}" for i, c in
                              enumerate(CASES)])
def test_spans_of_a_stream(kind, path, kw, reads, nested):
    table = _table(kind)
    plain = _stream(path, table, **kw)
    traced, recs, _ = _traced(lambda: _stream(path, table, **kw))
    if "regimes" in kw:
        plain, traced = plain.by_regime, traced.by_regime
    for f in FIELDS:                                   # the same bits
        assert torch.equal(getattr(plain, f), getattr(traced, f)), f

    want = {tracing.STREAM: 1, tracing.PREPARE: 1, tracing.HOST_READ: reads,
            tracing.PLACE: 1, tracing.DRAWS: CHUNKS, tracing.DECIDE: CHUNKS,
            tracing.SKETCH: CHUNKS}
    assert collections.Counter(r.name for r in recs) == {
        k: v for k, v in want.items() if v}
    root = next(r for r in recs if r.name == tracing.STREAM)
    assert root.parent is None and all(r.root == root.index for r in recs)
    by = {r.index: r for r in recs}
    prep = next(r for r in recs if r.name == tracing.PREPARE)
    for r in recs:
        want = {tracing.STREAM: None, tracing.PREPARE: root.index,
                tracing.HOST_READ: prep.index, tracing.PLACE: prep.index,
                tracing.DECIDE: root.index,
                tracing.SKETCH: root.index}.get(r.name)
        if r.name == tracing.DRAWS:
            parent = by[r.parent].name
            assert parent == (tracing.DECIDE if nested else tracing.STREAM)
        else:
            assert r.parent == want, r
        assert 0 <= r.host_ms
        assert r.host_start_ns <= r.host_end_ns
    first = min(r.host_start_ns for r in recs if r.name == tracing.DRAWS)
    assert prep.host_end_ns <= first


def test_readout_span_and_the_profilers_trace(tmp_path):
    table = _table("card")
    (_, recs, prof) = _traced(
        lambda: _stream("race", table).quantile([0.5, 0.99]))
    assert sum(r.name == tracing.READOUT for r in recs) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {tracing.STREAM, tracing.PREPARE, tracing.HOST_READ,
            tracing.PLACE, tracing.DRAWS, tracing.DECIDE, tracing.SKETCH,
            tracing.READOUT} <= names


def test_capacity_drops_and_clear(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.span(f"s{i}"):
                pass
    assert [r.name for r in tracing.records()] == ["s0", "s1", "s2"]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def test_threads_keep_their_own_stacks_and_every_count(monkeypatch):
    """More threads than cores, a short switch interval: each thread's
    spans nest under its own root, and kept + dropped spans add up.  (A
    profiler records the thread that started it, so the threads enter the
    recording span directly.)"""
    import os
    import sys
    import threading

    threads, spans = 2 * (os.cpu_count() or 4), 200

    def work():
        for _ in range(spans // 2):
            with tracing._Span("outer"):
                with tracing._Span("inner"):
                    pass

    def run_all():
        tracing.clear()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in pool)
        return tracing.records()

    monkeypatch.setattr(tracing, "CAPACITY", threads * spans)
    recs = run_all()
    assert len(recs) == threads * spans and tracing.dropped() == 0
    by = {r.index: r for r in recs}
    for r in recs:
        if r.name == "inner":
            assert by[r.parent].name == "outer" and r.root == r.parent
        else:
            assert r.parent is None and r.root == r.index
    monkeypatch.setattr(tracing, "CAPACITY", spans)
    assert len(run_all()) == spans
    assert tracing.dropped() == (threads - 1) * spans
    tracing.clear()


def _range(name, ts, dur):
    return {"ph": "X", "cat": "gpu_user_annotation", "name": name,
            "ts": ts, "dur": dur}


def _op(ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur}


# (ranges on the card, device records, microseconds by span)
BUSY_CASES = [
    ([("repro_torch.stream", 0, 100), ("repro_torch.draws", 10, 30),
      ("repro_torch.decide", 40, 50), ("repro_torch.draws", 50, 10),
      ("repro_torch.sketch", 90, 9), ("ffpbench.stream", 0, 200)],
     [_op(5, 2), _op(12, 10), _op(30, 5), _op(41, 5), _op(52, 4),
      _op(70, 10, "gpu_memset"), _op(91, 5), _op(150, 10, "gpu_memcpy")],
     {"stream": 2, "draws": 19, "decide": 15, "sketch": 5, "none": 10}),
    # a root whose own work ends before its children's: the children's
    # ranges still take theirs
    ([("repro_torch.stream", 0, 20), ("repro_torch.draws", 10, 30)],
     [_op(2, 4), _op(12, 2), _op(30, 5), _op(45, 2)],
     {"stream": 4, "draws": 7, "none": 2}),
]


@pytest.mark.parametrize("ranges,ops,want", BUSY_CASES,
                         ids=["nested", "root-ends-first"])
def test_span_cost_busy_by_innermost_range(ranges, ops, want):
    """``tools/span_cost.py``: each device record goes to the innermost
    ``repro_torch.*`` range on the card holding its midpoint."""
    import importlib.util
    path = Path(__file__).resolve().parent.parent / "tools" / "span_cost.py"
    spec = importlib.util.spec_from_file_location("span_cost", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    events = [_range(*r) for r in ranges] + ops
    assert dict(mod.busy_us(events)) == want


def test_kept_spans_leave_the_collectors_count():
    """Spans kept while on are no objects the garbage collector tracks, so
    they do not bring its collections forward into the traced window."""
    import gc
    tracing.clear()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            before = gc.get_count()[0]
            for _ in range(2000):
                with tracing.span(tracing.DRAWS):
                    pass
            grew = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert len(tracing.records()) == 2000
    assert grew < 100, grew
    tracing.clear()


# ---------------------------------------------------------------------------
# The delay's placement: the benchmark deployment ``geo15_eu_down``'s WAN
# model with crashed acceptors (15 acceptors over five regions, one region
# down), built on the host as a user's ``delay_from_config`` builds it.
# ---------------------------------------------------------------------------

GEO_DELAY = json.loads((Path(__file__).resolve().parent.parent / "ffpbench"
                        / "configs" / "geo15_eu_down.json").read_text())[
    "delay"]


def _geo_requests(device, requests=2):
    from repro_torch.frontier import families
    from repro_torch.montecarlo import latency
    table = engine.build_mask_table(
        [m.masks(15) for m in families.grid_family(15)], device=device)
    delay = latency.delay_from_config(GEO_DELAY, 15)

    def run():
        return [streaming.race_stream(
            7 + r, table, [0.0, 0.5], delay, n=15, k_proposers=2,
            trials=2048, chunk=1024, shard=False) for r in range(requests)]
    return _traced(run)[1]


def _placements(recs):
    by = {r.index: r for r in recs}
    places = [r for r in recs if r.name == tracing.PLACE]
    for p in places:
        assert by[p.parent].name == tracing.PREPARE
    writes = [r for r in recs if r.name == tracing.HOST_WRITE]
    for w in writes:
        assert w.parent in {p.index for p in places}
    return places, writes


def test_placement_one_span_a_request_and_no_copy_on_its_device():
    recs = _geo_requests("cpu")
    places, writes = _placements(recs)
    roots = [r for r in recs if r.name == tracing.STREAM]
    assert len(roots) == 2
    assert sorted(p.root for p in places) == sorted(r.index for r in roots)
    assert writes == []


def test_placement_on_the_card_copies_four_tensors(cuda):
    recs = _geo_requests(cuda)
    places, writes = _placements(recs)
    assert len(places) == 2
    # oneway_ms, acceptor_region, proposer_region and crashed, a request
    assert len(writes) == 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("name", ["place_ms", "host_writes_per_request"])
def test_placement_readers_find_nothing_without_spans(name):
    """Without a trace, and where the program records no
    ``repro_torch.place`` (the spans of a program before it had one), the
    readers return None."""
    from ffpbench import metrics
    root = tracing.Record(tracing.STREAM, 0, None, 0, 0, 1000, 1e-3)
    read = tracing.Record(tracing.HOST_READ, 1, 0, 0, 0, 10, 1e-5)
    assert metrics.read(name, {"trace": None}) is None
    assert metrics.read(name, {"trace": {"requests": 1,
                                         "program_spans": [read, root]}}
                        ) is None
