"""Share of its roofline that the masked fast-path saturation reaches:
``masked_sat_kernel`` launches (``kernels/quorum_tally``), one a chunk.

Least time a chunk = max(bytes / HBM bandwidth, operations / f32 peak).
The work is the layer's, from the cell's shapes, whatever kernel does it,
with L = n sorted positions a trial (exact where the table's saturation
depth is n, as in ``mixed_n12.fast_512k``; a shallower depth would need
fewer):
- bytes: its inputs once -- the chunk's presorted arrivals (float32) and
  their acceptor ids (int64), S x L each, and the systems' fast quorum rows
  (n + 1 4-byte words a row) -- and its output once, each system's
  saturation time a trial (float32);
- operations: per trial, each fast row's running sum along the order (an
  add and a compare a position) and a minimum a system.
"""
import re

from ffpbench import trace

KERNEL = re.compile(r"\bmasked_sat_kernel\b")


def work(cell: dict) -> tuple:
    S, n, M = cell["chunk"], cell["n"], cell["systems"]
    L = n
    fast_rows = sum(r[2] for r in cell["rows"])
    nbytes = S * L * (4 + 8) + fast_rows * (n + 1) * 4 + M * S * 4
    ops = S * (fast_rows * L * 2 + M)
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
