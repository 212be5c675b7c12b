"""Share of its roofline that the masked race decide reaches: the fused
``stream_kernel`` launches of ``stream_tally_decide_hist`` and their fills
(``kernels/quorum_tally``).

Least time a chunk = max(bytes / HBM bandwidth, operations / f32 peak).
The work is the layer's, from the cell's shapes, whatever kernel does it:
- bytes: its inputs once -- the chunk's votes (int32), 2b arrivals and
  classic legs (float32), S x n each, the validity byte a trial and the
  systems' quorum rows (n + 1 4-byte words a row) -- and its outputs once,
  each system's chunk summary (B int32 buckets and five 4-byte counts and
  statistics);
- operations: per trial, the arrivals ordered (3 n ceil(log2 n)); per
  trial and system, each quorum row's weight prefix over the ordered
  arrivals (2 n a row: add and compare) for phase 1, classic phase 2 and
  the winner's fast phase 2, the fast-quorum tally of each value over the
  fast rows (n a row and value), and the decide and bucket (6).
"""
import math
import re

from ffpbench import trace

KERNEL = re.compile(r"\bstream_kernel\s*<")


def work(cell: dict) -> tuple:
    S, n, K = cell["chunk"], cell["n"], cell["k_proposers"]
    M, B = cell["systems"], cell["bins"]
    rows = cell["rows"]                              # [(G1, G2c, G2f)]
    n_rows = sum(sum(r) for r in rows)
    fast_rows = sum(r[2] for r in rows)
    nbytes = (S * n * 4 * 3 + S + n_rows * (n + 1) * 4
              + M * (B * 4 + 5 * 4))
    ops = (S * 3 * n * math.ceil(math.log2(n))
           + S * (n_rows * 2 * n + K * fast_rows * n + M * 6))
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
