"""The readers of the program's own spans (``spans.py`` and the two metrics
that use it): on synthetic ``repro_torch.tracing`` records, through a
traced tiny run of every cell on the CPU, and one short traced run on the
card (python -m pytest -q ffpbench/tests -m card)."""
import math
import sys

import pytest

from _ffpbench_cells import CELLS, SEED, tiny_cell
from ffpbench import metrics, run, spans
from repro_torch import tracing

HOST = ("prepare_ms", "host_reads_per_request")
TRIALS = 4_194_304


def _span(name, index, parent, root, host_ms):
    return tracing.Record(f"repro_torch.{name}", index, parent, root, 0,
                          int(host_ms * 1e6), host_ms)


def _requests():
    """Two requests: a race chunk of the card lowering (draws, then decide)
    and a materialized chunk (the draws inside the decide)."""
    return [
        _span("host_read", 2, 1, 0, 0.05),
        _span("host_read", 3, 1, 0, 0.05),
        _span("prepare", 1, 0, 0, 0.30),
        _span("draws", 4, 0, 0, 0.20),
        _span("decide", 5, 0, 0, 0.10),
        _span("sketch", 6, 0, 0, 0.10),
        _span("stream", 0, None, 0, 6.0),
        _span("readout", 7, None, 7, 0.10),
        _span("host_read", 10, 9, 8, 0.05),
        _span("host_read", 11, 9, 8, 0.05),
        _span("prepare", 9, 8, 8, 0.50),
        _span("draws", 13, 12, 8, 0.20),
        _span("decide", 12, 8, 8, 0.30),
        _span("sketch", 14, 8, 8, 0.10),
        _span("stream", 8, None, 8, 7.0),
        _span("readout", 15, None, 15, 0.10),
    ]


def _record(recs, requests=2):
    return {"cell": {"trials_per_request": TRIALS},
            "trace": {"requests": requests, "trials": requests * TRIALS,
                      "program_spans": recs}}


@pytest.mark.parametrize("name,want", [
    ("prepare_ms", (0.30 + 0.50) / 2),          # host reads included
    ("host_reads_per_request", 2.0),
])
def test_per_request_bases(name, want):
    assert metrics.read(name, _record(_requests())) == pytest.approx(want)


@pytest.mark.parametrize("record", [
    {"trace": None},
    _record([]),                                  # no records at all
    _record(_requests(), requests=3),             # a root short
    _record(_requests()[:8], requests=2),         # one request's spans
], ids=["no-trace", "no-records", "more-requests", "fewer-streams"])
def test_nothing_to_read(record):
    for name in HOST:
        assert metrics.read(name, record) is None


def test_a_program_without_spans(monkeypatch):
    """The parent's program has no ``repro_torch.tracing``: the readers
    find nothing and raise nothing."""
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    rec = {"trace": {"requests": 1, "trials": TRIALS}}
    assert spans.of_run(rec) is None
    for name in HOST:
        assert metrics.read(name, rec) is None


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_own_spans(name):
    """Through the harness on the CPU: the readers read the window's
    spans, the reads to the host are exact, and the program's list is left
    empty for the next run in the process."""
    tracing.clear()
    r = run.run_cell(tiny_cell(name), SEED, 0.0, True, "cpu")
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert got["host_reads_per_request"] == (
        2.0 if name.startswith("ffp_n11.") else 6.0)
    assert 0 < got["prepare_ms"] < 1e4
    assert tracing.records() == []


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.card
def test_span_metrics_on_the_card(card):
    cell = run.load_cell("ffp_n11.race_4m")
    r = run.run_cell(cell, SEED, 1.0, True, card)
    assert r["correct"], r["checks"]
    for name in HOST:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, name
    assert r["metrics"]["host_reads_per_request"]["value"] == 2.0
