"""The per-layer readers and their work counts, on synthetic records."""
import math

import pytest

from ffpbench import metrics, trace

CELL_CARD = {"name": "c", "pass": "race", "n": 11, "systems": 271,
             "k_proposers": 2, "chunk": 262144,
             "trials_per_request": 4194304, "chunks_per_request": 16,
             "bins": 1038, "rows": [(1, 1, 1)] * 271}
CELL_MASKED = dict(CELL_CARD, n=12, systems=2, chunk=1000,
                   rows=[(1, 1, 1), (12, 4, 3)])


def test_bins_of_the_default_precision():
    from ffpbench.reference import sketch_bins
    assert sketch_bins(0.01) == 1038


def test_race_card_work_from_shapes():
    mod = metrics.load("roofline.race_card_hist")
    nbytes, ops = mod.work(CELL_CARD)
    S, n, M, B = 262144, 11, 271, 1038
    assert nbytes == S * n * 12 + S + M * (4 * B + 20)
    assert ops == S * (n * 2 + 3 * n * 4) + S * M * 6


def test_masked_work_counts_each_systems_own_rows():
    mod = metrics.load("roofline.stream_tally_decide_hist")
    nbytes, ops = mod.work(CELL_MASKED)
    S, n = 1000, 12
    rows, fast = 3 + 19, 1 + 3
    assert nbytes == S * n * 12 + S + rows * (n + 1) * 4 + 2 * (4 * 1038 + 20)
    assert ops == S * 3 * n * 4 + S * (rows * 2 * n + 2 * fast * n + 2 * 6)


def _record(device, spans, cell=CELL_CARD, requests=1):
    return {"cell": cell, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "trace": {"device": device, "spans": spans, "requests": requests,
                      "chunks": requests * cell["chunks_per_request"],
                      "trials": requests * cell["trials_per_request"]}}


DEVICE = [("Memset (Device)", 10.0, 2.0, "gpu_memset"),
          ("void race_card_kernel<false>(CardArgs)", 12.0, 100.0, "kernel"),
          ("Memcpy DtoH", 150.0, 10.0, "gpu_memcpy"),
          ("void at::native::vectorized_elementwise_kernel<4>", 0.0, 5.0,
           "kernel"),
          ("late kernel", 300.0, 5.0, "kernel")]
SPANS = [("ffpbench.stream", 0.0, 140.0), ("ffpbench.readout", 140.0, 60.0)]


def test_window_idle_share_and_launches():
    rec = _record(DEVICE, SPANS)
    # window 0..200 us; busy 0-5, 10-112, 150-160 = 117 us
    assert metrics.read("device_idle_share", rec) == pytest.approx(
        100 * (1 - 117 / 200))
    assert metrics.read("launches_per_chunk", rec) == pytest.approx(4 / 16)
    assert metrics.read("device_ms_per_mtrial", rec) == pytest.approx(
        (2 + 100 + 10 + 5) * 1e-3 / 4.194304)


def test_roofline_takes_the_kernel_and_its_fill():
    rec = _record(DEVICE, SPANS)
    us, launches = trace.kernel_time(rec["trace"],
                                     metrics.load(
                                         "roofline.race_card_hist").KERNEL)
    assert (us, launches) == (102.0, 1)
    nbytes, ops = metrics.load("roofline.race_card_hist").work(CELL_CARD)
    least = max(nbytes / 3.35e12, ops / 67e12)
    assert metrics.read("roofline.race_card_hist", rec) == pytest.approx(
        100 * least / 102e-6)
    assert metrics.read("roofline.stream_tally_decide_hist", rec) is None


def test_readers_find_nothing_without_a_trace():
    rec = {"cell": CELL_CARD, "trace": None, "readout_s": [],
           "device": {"kind": "cpu"}}
    for name in ("device_idle_share", "launches_per_chunk",
                 "device_ms_per_mtrial", "readout_ms",
                 "roofline.race_card_hist",
                 "roofline.stream_tally_decide_hist"):
        assert metrics.read(name, rec) is None


def test_end_to_end_readers():
    rec = {"setup_s": 7.5, "latencies_s": [0.01 * i for i in range(1, 101)],
           "window_s": 2.0, "trials": 1000}
    assert metrics.read("trials_per_s", rec) == 500.0
    assert metrics.read("request_p95_ms", rec) == pytest.approx(950.5)
    assert metrics.read("setup_s", rec) == 7.5
    assert metrics.read("readout_ms", {"readout_s": [0.001, 0.003]}) == \
        pytest.approx(2.0)


def test_breakdown_labels_gaps_by_host_span():
    b = trace.breakdown({"device": DEVICE, "spans": SPANS})
    assert b["device_ops"][0] == ["void race_card_kernel<false>(CardArgs)",
                                  pytest.approx(100e-6)]
    assert len(b["device_ops"]) == 4           # the late kernel is outside
    labels = [g[0] for g in b["idle_gaps"]]
    assert labels[0] == "ffpbench.readout"     # 160..200 us, the longest
    assert sum(g[1] for g in b["idle_gaps"]) == pytest.approx(83e-6)
    assert all(math.isfinite(g[1]) for g in b["idle_gaps"])


def test_parse_keeps_device_records_and_harness_spans_only():
    ev = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 5, "dur": 1},
          {"ph": "X", "cat": "gpu_user_annotation",
           "name": "ffpbench.stream", "ts": 0, "dur": 9},
          {"ph": "X", "cat": "user_annotation", "name": "ffpbench.stream",
           "ts": 0, "dur": 9},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
           "dur": 1},
          {"ph": "i", "cat": "kernel", "name": "x", "ts": 3}]
    rec = trace.parse(ev)
    assert rec == {"device": [("k", 5.0, 1.0, "kernel")],
                   "spans": [("ffpbench.stream", 0.0, 9.0)]}
