"""The order statistics' roofline reader, on synthetic records."""
import pytest

from ffpbench import metrics

CELL = {"name": "ffp_n11.fast_4m", "pass": "fast_path", "n": 11,
        "systems": 271, "k_proposers": 1, "chunk": 2_097_152,
        "trials_per_request": 4_194_304, "chunks_per_request": 2,
        "bins": 1038, "rows": [(1, 1, 1)]}
SPANS = [("ffpbench.stream", 0.0, 14000.0),
         ("ffpbench.readout", 14000.0, 600.0)]


def _record(device):
    return {"cell": CELL, "device": {"kind": "NVIDIA H100 80GB HBM3"},
            "trace": {"device": device, "spans": SPANS, "requests": 1,
                      "chunks": 2, "trials": 4_194_304}}


def test_work_at_the_fast_4m_chunk():
    nbytes, ops = metrics.load("roofline.sorted_prefix").work(CELL)
    assert nbytes == 184_549_376
    assert ops == 2_097_152 * 38


@pytest.mark.parametrize("n,size", [(1, 0), (2, 1), (4, 5), (8, 19),
                                    (11, 38), (12, 42), (16, 63),
                                    (32, 191)])
def test_comparators_of_the_network(n, size):
    assert metrics.load("roofline.sorted_prefix").comparators(n) == size


def test_reads_100_at_the_bound():
    """Two launches in the window, each taking the least time: 100 %."""
    nbytes, ops = metrics.load("roofline.sorted_prefix").work(CELL)
    least_us = max(nbytes / 3.35e12, ops / 67e12) * 1e6
    device = [("void at::native::vectorized_elementwise_kernel", 0.0, 50.0,
               "kernel"),
              ("void sorted_prefix_kernel<11, false>(float const*, long "
               "long, int, int, float*, long long*)", 100.0, least_us,
               "kernel"),
              ("void sorted_prefix_kernel<11, false>(float const*, long "
               "long, int, int, float*, long long*)", 7000.0, least_us,
               "kernel"),
              ("void sorted_prefix_kernel<11, false>(float const*, long "
               "long, int, int, float*, long long*)", 20000.0, least_us,
               "kernel")]
    assert metrics.read("roofline.sorted_prefix", _record(device)) == \
        pytest.approx(100.0)


@pytest.mark.parametrize("device", [
    [], [("void at::native::radixSortKVInPlace<2, -1, 128, 32, float, "
          "long, unsigned int>", 0.0, 5000.0, "kernel")]],
    ids=["empty", "the radix sort"])
def test_finds_nothing_without_the_kernel(device):
    assert metrics.read("roofline.sorted_prefix", _record(device)) is None
    assert metrics.read("roofline.sorted_prefix",
                        dict(_record(device), trace=None)) is None
