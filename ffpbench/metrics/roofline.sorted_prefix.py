"""Share of its roofline that the decide layer's order statistics reach:
``sorted_prefix_kernel`` launches (``kernels/quorum_tally``), one a chunk.

Least time a chunk = max(bytes / HBM bandwidth, operations / f32 peak).
The work is the layer's, from the cell's shapes, whatever kernel does it,
with a prefix of all n values a trial (exact where the fast depth is n, as
in ``ffp_n11``; a shallower depth would write fewer):
- bytes: the chunk's path times, S x n float32, read once, and their
  ascending prefix, S x n float32, written once;
- operations: the compare-exchanges of a sorting network on n values a
  trial (Batcher's odd-even merge sort cut to n, 38 at n = 11); they never
  bind.
"""
import re

from ffpbench import trace

KERNEL = re.compile(r"\bsorted_prefix_kernel\b")


def comparators(n: int) -> int:
    """Batcher's odd-even merge sort for the next power of two, with every
    comparator that touches a position >= n dropped."""
    size, p = 0, 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                size += sum(1 for i in range(min(k, n - j - k))
                            if (i + j) // (2 * p) == (i + j + k) // (2 * p))
            k //= 2
        p *= 2
    return size


def work(cell: dict) -> tuple:
    S, n = cell["chunk"], cell["n"]
    return S * n * 4 * 2, S * comparators(n)


def read(record):
    tr = record.get("trace")
    if not tr or not tr["spans"]:
        return None
    us, launches = trace.kernel_time(tr, KERNEL)
    if not launches or us <= 0:
        return None
    pk = trace.peaks(record["device"]["kind"])
    nbytes, ops = work(record["cell"])
    least = max(nbytes / pk["hbm_bytes_per_s"], ops / pk["f32_flops_per_s"])
    return 100.0 * launches * least / (us * 1e-6)
