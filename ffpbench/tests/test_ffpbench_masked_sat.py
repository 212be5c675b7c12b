"""The masked saturation's roofline reader, on synthetic records."""
import pytest

from ffpbench import metrics

CELL = {"name": "c", "pass": "fast_path", "n": 12, "systems": 3,
        "k_proposers": 1, "chunk": 1000, "trials_per_request": 8000,
        "chunks_per_request": 8, "bins": 1038,
        "rows": [(1, 1, 1), (9, 3, 3), (1, 1, 2)]}
SPANS = [("ffpbench.stream", 0.0, 140.0), ("ffpbench.readout", 140.0, 60.0)]


def _record(device):
    return {"cell": CELL, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "trace": {"device": device, "spans": SPANS, "requests": 1,
                      "chunks": 8, "trials": 8000}}


def test_work_counts_each_systems_own_fast_rows_at_l_equal_n():
    nbytes, ops = metrics.load("roofline.masked_sat").work(CELL)
    S, n, M, fast = 1000, 12, 3, 6
    assert nbytes == S * n * 12 + fast * (n + 1) * 4 + M * S * 4
    assert ops == S * (fast * n * 2 + M)


def test_reads_the_kernels_launches_in_the_window():
    device = [("void at::native::radix_sort", 0.0, 5.0, "kernel"),
              ("void masked_sat_kernel<true, true>(SatArgs)", 10.0, 4.0,
               "kernel"),
              ("void masked_sat_kernel<true, true>(SatArgs)", 50.0, 6.0,
               "kernel"),
              ("void masked_sat_kernel<true, true>(SatArgs)", 300.0, 6.0,
               "kernel")]
    nbytes, ops = metrics.load("roofline.masked_sat").work(CELL)
    least = max(nbytes / 3.35e12, ops / 67e12)
    assert metrics.read("roofline.masked_sat", _record(device)) == \
        pytest.approx(100 * 2 * least / 10e-6)


@pytest.mark.parametrize("device", [
    [], [("void at::native::tensor_kernel_scan_innermost_dim", 0.0, 50.0,
          "kernel")]], ids=["empty", "the scan"])
def test_finds_nothing_without_the_kernel(device):
    assert metrics.read("roofline.masked_sat", _record(device)) is None
    assert metrics.read("roofline.masked_sat",
                        dict(_record(device), trace=None)) is None
