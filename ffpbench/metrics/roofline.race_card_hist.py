"""Share of its roofline that the cardinality race decide reaches:
``race_card_kernel`` launches and their fills (``kernels/quorum_tally``).

Least time a chunk = max(bytes / HBM bandwidth, operations / f32 peak).
The work is the layer's, from the cell's shapes, whatever kernel does it:
- bytes: its inputs once -- the chunk's votes (int32), 2b arrivals and
  classic legs (float32), S x n each, and the validity byte a trial -- and
  its outputs once, each system's chunk summary (B int32 buckets and five
  4-byte counts and statistics);
- operations: the tally (n K a trial), three order statistics over n
  arrivals (3 n ceil(log2 n) a trial), and per trial and system the fast
  test, the recovery sum, the select and the bucket (6).
"""
import math
import re

from ffpbench import trace

KERNEL = re.compile(r"\brace_card_kernel\b")


def work(cell: dict) -> tuple:
    S, n, K = cell["chunk"], cell["n"], cell["k_proposers"]
    M, B = cell["systems"], cell["bins"]
    nbytes = S * n * 4 * 3 + S + M * (B * 4 + 5 * 4)
    ops = S * (n * K + 3 * n * math.ceil(math.log2(n))) + S * M * 6
    return nbytes, ops


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
