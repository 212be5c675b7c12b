"""Hopper kernels for the quorum tally, bound with ctypes.

``csrc/quorum_tally.cu`` holds eight CUDA C++ kernels for ``sm_90a``; its
header says which TPU kernel each replaces, what bounds it on the card and
what its design does about that.  ``LIB`` (``kernels/_build.py``) compiles
the source with ``nvcc`` on first use into ``build/`` beside this file
(git-ignored) and loads it.  Nothing is compiled or loaded at import: this
module imports on a machine without CUDA.

Every wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES[name]`` when it launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.sketch import sketch_gamma

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quorum_tally.cu"

# The longest row sorted_prefix's networks sort (its C source's SP_MAX_N).
SORTED_PREFIX_MAX_N = 32

# Device memory the blocks of a launch work in together, where a block's
# tile does not fit in its shared memory (stream_tally_decide_hist,
# race_card_hist, masked_tally at large n): fewer blocks then, but at
# least one.
MAX_SCRATCH_BYTES = 2 ** 30

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)

# Each C entry point: (argument types, result type).  A plan entry point's
# last argument is the array it writes the plan into.
SIGNATURES = {
    "qt_tally_votes": ([_P, _I, _I, _I, _P, _P], _I),
    "qt_tally_decide": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _P], _I),
    "qt_masked_plan": ([_I, _I, _I, _L * 5], _I),
    "qt_masked_tally": ([_P, _P, _P] + [_I] * 7 + [_P, _L, _P, _P], _I),
    "qt_stream_plan": ([_I] * 6 + [_I * 6], _I),
    "qt_stream_tally_decide_hist": (
        [_P] * 11 + [_I] * 10 + [_F, _I, _F] + [_I] * 5 + [_P] * 10, _I),
    "qt_card_plan": ([_I] * 5 + [_L * 7], _I),
    "qt_race_card_hist": (
        [_P] * 5 + [_I] * 7 + [_F, _I, _F] + [_I] * 6 + [_P, _L, _L]
        + [_P] * 11, _I),
    "qt_sat_plan": ([_I] * 4 + [_L * 6], _I),
    "qt_masked_sat": ([_P] * 5 + [_L] * 4 + [_I] * 9 + [_F] + [_I] * 3
                      + [_P], _I),
    "qt_sorted_prefix": ([_P, _L, _I, _I, _I, _P, _P, _P], _I),
    "qt_col_plan": ([_I, _I, _L * 7], _I),
    "qt_col_sketch": ([_P, _P, _I, _I, _I, _F, _F] + [_I] * 7 + [_L]
                      + [_P] * 7, _I),
}

LIB = _build.Library(SOURCE, "quorum_tally", SIGNATURES, (
    "tally_votes", "tally_decide", "masked_tally", "stream_tally_decide_hist",
    "race_card_hist", "masked_sat", "sorted_prefix", "col_sketch"))
LAUNCHES = LIB.LAUNCHES
reset_launches = LIB.reset_launches
build = LIB.build

_STREAM_REFUSED = ("32 trials' K={1} rows of n={0} acceptors exceed the 1 "
                   "GiB of device memory a block may stage them in")


def _require_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got one on "
                         f"{t.device}; ops.py routes CPU tensors to ref.py")


def _check_sizes(n: int, n_values: int) -> None:
    if n < 1:
        raise ValueError(f"the quorum-tally kernels take n >= 1 acceptors, "
                         f"got n={n}")
    if not 1 <= n_values < 2 ** 30:
        raise ValueError(f"the quorum-tally kernels take 1 <= K < 2^30 "
                         f"values, got K={n_values}")


def tally_votes(votes: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, n) int32 votes (< 0 = no vote) -> (S, K) int32 counts, for any
    n and K (K compares a vote up to K = 8, else one pass over each row
    per 8 values)."""
    if votes.dim() != 2:
        raise ValueError(f"votes must be (S, n), got {tuple(votes.shape)}")
    S, n = votes.shape
    _require_cuda(votes)
    if not 1 <= n_values < 2 ** 30:
        raise ValueError(f"tally_votes takes 1 <= K < 2^30 values, got "
                         f"K={n_values}")
    dev = votes.device
    _build.check(votes, "votes", torch.int32, (S, n), dev)
    counts = torch.empty((S, n_values), dtype=torch.int32, device=dev)
    if S:
        LIB.launch("tally_votes", "qt_tally_votes", dev, votes.data_ptr(),
                   S, n, n_values, counts.data_ptr())
    return counts


def tally_decide(votes: torch.Tensor, n_values: int, q) -> tuple:
    """(S, n) int32 votes (< 0 = no vote), int threshold q ->
    (counts (S, K) int32, winner (S,) int32, max_count (S,) int32,
    reached (S,) bool), for any n and K."""
    if votes.dim() != 2:
        raise ValueError(f"votes must be (S, n), got {tuple(votes.shape)}")
    S, n = votes.shape
    _require_cuda(votes)
    _check_sizes(n, n_values)
    dev = votes.device
    _build.check(votes, "votes", torch.int32, (S, n), dev)
    counts = torch.empty((S, n_values), dtype=torch.int32, device=dev)
    winner = torch.empty((S,), dtype=torch.int32, device=dev)
    max_count = torch.empty((S,), dtype=torch.int32, device=dev)
    reached = torch.empty((S,), dtype=torch.bool, device=dev)
    if S:
        LIB.launch("tally_decide", "qt_tally_decide", dev, votes.data_ptr(),
                   S, n, n_values, int(q), counts.data_ptr(),
                   winner.data_ptr(), max_count.data_ptr(),
                   reached.data_ptr())
    return counts, winner, max_count, reached


def masked_tally(votes: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, n) int32 votes x (G, n) f32 weights, (G,) f32 thresholds ->
    (S, G) int32 lowest satisfying value id, else -1, for any S, n, G and
    K, in one launch."""
    if votes.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"votes (S, n) and weights (G, n) expected, got "
                         f"{tuple(votes.shape)} / {tuple(weights.shape)}")
    S, n = votes.shape
    G = weights.shape[0]
    _require_cuda(votes)
    _check_sizes(n, n_values)
    dev = votes.device
    _build.check(votes, "votes", torch.int32, (S, n), dev)
    _build.check(weights, "weights", torch.float32, (G, n), dev)
    _build.check(thresholds, "thresholds", torch.float32, (G,), dev)
    if G >= 2 ** 31:
        raise ValueError(f"masked_tally takes G < 2^31 rows, got {G}")
    out = torch.empty((S, G), dtype=torch.int32, device=dev)
    if S and G:
        # (rows a chunk, shared memory, blocks the card holds at once,
        # device-memory bytes a block works in, 0 where it works in shared
        # memory, trials a tile)
        rc, smem, blocks, region, tile = LIB.plan(
            "masked_tally", "qt_masked_plan", dev, (n, G, n_values))
        nbx = max(1, min(-(-S // tile) * -(-G // rc), blocks))
        scratch = None
        if region:  # the blocks work in device memory: at most 1 GiB of it
            nbx = max(1, min(nbx, MAX_SCRATCH_BYTES // region))
            scratch = torch.empty(nbx * region, dtype=torch.uint8,
                                  device=dev)
        LIB.launch("masked_tally", "qt_masked_tally", dev, votes.data_ptr(),
                   weights.data_ptr(), thresholds.data_ptr(), S, n, G,
                   n_values, rc, smem, nbx,
                   None if scratch is None else scratch.data_ptr(), region,
                   out.data_ptr())
    return out


@functools.lru_cache(maxsize=None)
def _log_gamma(precision: float) -> float:
    return math.log(sketch_gamma(precision))


def stream_tally_decide_hist(votes: torch.Tensor, val_arr: torch.Tensor,
                             arrive: torch.Tensor, classic: torch.Tensor,
                             w1: torch.Tensor, t1: torch.Tensor,
                             w2c: torch.Tensor, t2c: torch.Tensor,
                             w2f: torch.Tensor, t2f: torch.Tensor,
                             valid: torch.Tensor, *, n_values: int,
                             k_sat: tuple, precision: float, bins: int,
                             undecided_ms: float):
    """Fused masked tally + selection + decide + sketch over one raw chunk
    (shapes and semantics of ``ref.stream_tally_decide_hist``) in one
    launch, after one fill of the histogram.  The outputs are views of one
    buffer; counts and histogram are exact, and ``sum_ms`` reduces per-block
    partials in a fixed order, so it is the same bit for bit from call to
    call."""
    if votes.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"votes (S, n) and masks (M, G, n) expected, got "
                         f"{tuple(votes.shape)} / {tuple(w1.shape)}")
    S, n = votes.shape
    K = n_values
    M, G1 = w1.shape[:2]
    G2c, G2f = w2c.shape[1], w2f.shape[1]
    _require_cuda(votes)
    _check_sizes(n, K)
    dev = votes.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (votes, "votes", torch.int32, (S, n)),
            (val_arr, "val_arr", f32, (S, K, n)),
            (arrive, "arrive", f32, (S, n)),
            (classic, "classic", f32, (S, n)), (w1, "w1", f32, (M, G1, n)),
            (t1, "t1", f32, (M, G1)), (w2c, "w2c", f32, (M, G2c, n)),
            (t2c, "t2c", f32, (M, G2c)), (w2f, "w2f", f32, (M, G2f, n)),
            (t2f, "t2f", f32, (M, G2f)), (valid, "valid", torch.bool, (S,))):
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            _build.check(t, name, dtype, shape, dev)
    ref.check_stream(S, n, k_sat)
    ks = tuple(int(k) for k in k_sat)
    if not 1 <= M <= 65535:
        raise ValueError(f"stream kernel takes 1 <= M <= 65535 systems, "
                         f"got {M}")
    if max(G1, G2c, G2f) > 65535:
        raise ValueError(f"stream kernel takes at most 65535 quorum rows a "
                         f"phase, got {(G1, G2c, G2f)}")
    # (systems a block, threads, shared memory, blocks the card holds at
    # once, masks resident in shared memory, device-memory bytes a block
    # stages its tile in)
    mg, threads, smem, blocks, res, big = LIB.plan(
        "stream_tally_decide_hist", "qt_stream_plan", dev,
        (n, K, M, G1, G2c, G2f), _STREAM_REFUSED)
    groups = -(-M // mg)
    nbx = max(1, min(-(-S // 32), blocks // groups))
    scratch = None
    if big:  # the tiles staged in device memory: at most 1 GiB of it
        nbx = max(1, min(nbx, MAX_SCRATCH_BYTES // (groups * big)))
        scratch = torch.empty(groups * nbx * big, dtype=torch.uint8,
                              device=dev)
    # one buffer: hist (M, bins) and a ticket per system group (zeroed by
    # the C entry point);
    # n_fast, n_recovery, n_undecided (M,) each; f32 sum_ms, max_ms and the
    # per-block partial sums and maxima; the per-block partial counts.
    nz = M * bins + groups
    nf = 2 * M + 2 * M * nbx
    buf = torch.empty(nz + 3 * M + nf + 3 * M * nbx, dtype=torch.int32,
                      device=dev)
    zero, n_fast, n_rec, n_und, fl, _ = buf.split(
        [nz, M, M, M, nf, 3 * M * nbx])
    hist = zero[:M * bins].view(M, bins)
    sum_ms, max_ms, _ = fl.view(f32).split([M, M, 2 * M * nbx])
    if S:
        p = buf.data_ptr()
        LIB.launch(
            "stream_tally_decide_hist", "qt_stream_tally_decide_hist", dev,
            votes.data_ptr(), val_arr.data_ptr(), arrive.data_ptr(),
            classic.data_ptr(), w1.data_ptr(), t1.data_ptr(),
            w2c.data_ptr(), t2c.data_ptr(), w2f.data_ptr(), t2f.data_ptr(),
            valid.data_ptr(), S, n, K, M, G1, G2c, G2f, ks[0], ks[1], ks[2],
            _log_gamma(precision), bins, float(undecided_ms), mg, threads,
            smem, nbx, res, None if scratch is None else scratch.data_ptr(),
            p, p + 4 * nz, p + 4 * M * bins, p + 4 * (nz + 3 * M),
            p + 4 * (nz + 4 * M), p + 4 * (nz + 5 * M),
            p + 4 * (nz + 5 * M + M * nbx), p + 4 * (nz + 3 * M + nf))
    else:
        buf[:nz + 4 * M].zero_()
        max_ms.fill_(-math.inf)
    return hist, {"n_fast": n_fast, "n_recovery": n_rec,
                  "n_undecided": n_und, "sum_ms": sum_ms, "max_ms": max_ms}


def race_card_hist(votes: torch.Tensor, arrive: torch.Tensor,
                   classic: torch.Tensor, valid: torch.Tensor,
                   pairs: torch.Tensor, *, n_values: int, k_sat: tuple,
                   precision: float, bins: int, undecided_ms: float):
    """The cardinality race chunk in one launch, after one fill: tally,
    first-max decide, order statistics and the fcap-slot histograms, sums
    and maxima (shapes and semantics of ``ref.race_card_hist``; pairs
    (P, 2) int32).  The outputs are views of one buffer; integers and
    maxima are exact, and the sums reduce per-block partials in a fixed
    order, so they are the same bit for bit from call to call."""
    if votes.dim() != 2 or pairs.dim() != 2 or pairs.shape[-1] != 2:
        raise ValueError(f"votes (C, n) and pairs (P, 2) expected, got "
                         f"{tuple(votes.shape)} / {tuple(pairs.shape)}")
    S, n = votes.shape
    P = pairs.shape[0]
    K = n_values
    _require_cuda(votes)
    _check_sizes(n, K)
    dev = votes.device
    for t, name, dtype, shape in (
            (votes, "votes", torch.int32, (S, n)),
            (arrive, "arrive", torch.float32, (S, n)),
            (classic, "classic", torch.float32, (S, n)),
            (valid, "valid", torch.bool, (S,)),
            (pairs, "pairs", torch.int32, (P, 2))):
        _build.check(t, name, dtype, shape, dev)
    ref.check_stream(S, n, k_sat)
    ks = tuple(int(k) for k in k_sat)
    if bins < 1:
        raise ValueError(f"race_card_hist takes bins >= 1, got {bins}")
    k1, kr, k2f = ks
    # the pairs are checked on the host once per tensor, version and depths
    # (a chunk loop passes the same tensor every chunk), not at every call
    mark = (pairs._version, k1, kr)
    if getattr(pairs, "_race_card_checked", None) != mark:
        ref.check_pairs(pairs, k1, kr)
        pairs._race_card_checked = mark
    V, Q = k2f + 1, P + k2f
    cells = V * Q
    # (column groups, column threads a group, threads, shared memory,
    # blocks the card holds at once, device-memory bytes a block works in,
    # 0 where it works in shared memory, trials a tile)
    G, q32, threads, smem, blocks, region, tile = LIB.plan(
        "race_card_hist", "qt_card_plan", dev, (n, P) + ks)
    nbx = max(1, min(-(-S // tile), blocks))
    scratch = None
    if region:  # the blocks work in device memory: at most 1 GiB of it
        nbx = max(1, min(nbx, MAX_SCRATCH_BYTES // region))
        scratch = torch.empty(nbx * region, dtype=torch.uint8, device=dev)
    gb = math.isqrt(nbx - 1) + 1                # blocks a reduction group
    ngrp = -(-nbx // gb)
    # one buffer: FH, RH, the slot counts and the tickets (zeroed by the C
    # entry point); then Fsum, Fmax, Rsum, Rmax and the per-block and
    # per-group partials (a sum and a max a cell); each region starts on 16
    # bytes.
    sizes = [k2f * V * bins, P * V * (bins + 1), V, ngrp + 1, k2f * V,
             k2f * V, P * V, P * V, 2 * nbx * cells, 2 * ngrp * cells]
    at = [0]
    for n_words in sizes:
        at.append(at[-1] + -(-n_words // 4) * 4)
    buf = torch.empty(at[-1], dtype=torch.int32, device=dev)

    def region_of(i, *shape, dtype=torch.int32):
        return buf[at[i]:at[i] + sizes[i]].view(dtype).view(*shape)

    p0 = buf.data_ptr()
    LIB.launch("race_card_hist", "qt_race_card_hist", dev, votes.data_ptr(),
               arrive.data_ptr(), classic.data_ptr(), valid.data_ptr(),
               pairs.data_ptr(), S, n, K, P, k1, kr, k2f,
               _log_gamma(precision), bins, float(undecided_ms), G, q32,
               threads, smem, nbx, gb,
               None if scratch is None else scratch.data_ptr(), region,
               4 * at[4], *(p0 + 4 * o for o in at[:len(sizes)]))
    f32 = torch.float32
    return (region_of(0, k2f, V, bins), region_of(4, k2f, V, dtype=f32),
            region_of(5, k2f, V, dtype=f32), region_of(2, V),
            region_of(1, P, V, bins + 1), region_of(6, P, V, dtype=f32),
            region_of(7, P, V, dtype=f32))


def masked_sat(sorted_x: torch.Tensor, perm: torch.Tensor, w: torch.Tensor,
               t: torch.Tensor, *, big: float) -> torch.Tensor:
    """(M, S) f32 earliest instant some quorum row of each system saturates
    (shapes and semantics of ``ref.masked_sat``), in one launch and no
    fill.  ``sorted_x`` and ``perm`` are read as the sort left them: any
    row and system strides (a prefix of a wider sort, an expanded shared
    order), the last axis contiguous."""
    ref.check_masked_sat(sorted_x, perm, w, t)
    _require_cuda(sorted_x)
    M, G, n = w.shape
    S, L = sorted_x.shape[-2:]
    dev = sorted_x.device
    _build.check(w, "w", torch.float32, (M, G, n), dev)
    _build.check(t, "t", torch.float32, (M, G), dev)
    if perm.device != dev:
        raise ValueError(f"perm lies on {perm.device}, expected {dev}")
    if sorted_x.stride(-1) != 1 or perm.stride(-1) != 1:
        raise ValueError("masked_sat reads sorted_x and perm contiguous "
                         "along their last axis")
    if S >= 2 ** 31 or M >= 2 ** 31 or G >= 2 ** 31:
        raise ValueError(f"masked_sat takes S, M, G < 2^31, got "
                         f"{(S, M, G)}")
    out = torch.empty((M, S), dtype=torch.float32, device=dev)
    if not (S and M):
        return out
    # (systems a block, shared memory, blocks the card holds at once, rows
    # resident in shared memory, orders held in registers, trials a tile)
    mg, smem, blocks, res, reg, tile = LIB.plan(
        "masked_sat", "qt_sat_plan", dev, (n, L, M, G))
    gy = -(-M // mg)
    gx = max(1, min(-(-S // tile), blocks // gy))
    per = sorted_x.dim() == 3
    xs, ps = sorted_x.stride(-2), perm.stride(-2)
    xm = sorted_x.stride(0) if per else 0
    pm = perm.stride(0) if per else 0
    vec = perm.data_ptr() % 16 == 0 and ps % 2 == 0 and pm % 2 == 0
    LIB.launch("masked_sat", "qt_masked_sat", dev, sorted_x.data_ptr(),
               perm.data_ptr(), w.data_ptr(), t.data_ptr(), out.data_ptr(),
               xs, xm, ps, pm, S, L, n, M, G, mg, gx, gy, smem, float(big),
               int(res), int(reg), int(vec))
    return out


def sorted_prefix(x: torch.Tensor, k: int, *, order: bool) -> tuple:
    """The k smallest values of each row of ``x``'s last axis, ascending,
    ties to the lower position (shapes and semantics of
    ``ref.sorted_prefix``): contiguous (..., k) float32 values and, with
    ``order``, their positions as (..., k) int64, else None.  Rows of 1 to
    ``SORTED_PREFIX_MAX_N`` contiguous f32, in one launch and no fill."""
    _require_cuda(x)
    ref.check_sorted_prefix(x, k)
    n = x.shape[-1]
    if n > SORTED_PREFIX_MAX_N:
        raise ValueError(f"sorted_prefix sorts rows of at most "
                         f"{SORTED_PREFIX_MAX_N}, got n={n}")
    if not x.is_contiguous():
        raise ValueError("sorted_prefix reads x contiguous")
    dev = x.device
    shape = tuple(x.shape[:-1]) + (k,)
    vals = torch.empty(shape, dtype=torch.float32, device=dev)
    ids = torch.empty(shape, dtype=torch.int64, device=dev) if order else None
    S = x.numel() // n
    if S:
        LIB.launch("sorted_prefix", "qt_sorted_prefix", dev, x.data_ptr(),
                   S, n, k, int(x.data_ptr() % 16 == 0), vals.data_ptr(),
                   None if ids is None else ids.data_ptr())
    return vals, ids


def col_sketch(cols: torch.Tensor, valid: torch.Tensor, *, precision: float,
               bins: int, undecided_ms: float) -> tuple:
    """The column sketch of one chunk (shapes and semantics of
    ``ref.col_sketch``): cols (S, Kc) contiguous f32, valid (S,) bool, any
    S and Kc, in one launch after one fill.  The outputs are views of one
    buffer; histograms, counts and maxima are exact, and the sums reduce
    per-block partials in a fixed order, so they are the same bit for bit
    from call to call."""
    if cols.dim() != 2:
        raise ValueError(f"cols must be (S, Kc), got {tuple(cols.shape)}")
    _require_cuda(cols)
    S, Kc = cols.shape
    dev = cols.device
    _build.check(cols, "cols", torch.float32, (S, Kc), dev)
    _build.check(valid, "valid", torch.bool, (S,), dev)
    if not 1 <= Kc <= 65535 or S >= 2 ** 31:
        raise ValueError(f"col_sketch takes 1 <= Kc <= 65535 columns and "
                         f"S < 2^31 trials, got Kc={Kc}, S={S}")
    if bins < 1:
        raise ValueError(f"col_sketch takes bins >= 1, got {bins}")
    # (columns a block, warps a column, trials a tile, row stride of the
    # staged tile, shared memory, blocks the card holds at once,
    # histograms in device memory)
    cg, r, tile, P, smem, blocks, glob = LIB.plan(
        "col_sketch", "qt_col_plan", dev, (Kc, bins))
    groups = -(-Kc // cg)
    nbx = max(1, min(-(-S // tile), blocks // groups))
    H = bins + 1
    # one buffer: the histograms, the valid count and a ticket a column
    # group (zeroed by the C entry point); then the sums, the maxima and
    # the per-block partials (a sum and a max a column, 8-byte aligned).
    nz = Kc * H + 1 + groups
    at = nz + nz % 2
    buf = torch.empty(at + 2 * Kc + 2 * nbx * Kc, dtype=torch.int32,
                      device=dev)
    p = buf.data_ptr()
    LIB.launch("col_sketch", "qt_col_sketch", dev, cols.data_ptr(),
               valid.data_ptr(), S, Kc, bins, _log_gamma(precision),
               float(undecided_ms), cg, r, tile, P, smem, glob, nbx, 4 * nz,
               p, p + 4 * Kc * H, p + 4 * (Kc * H + 1), p + 4 * at,
               p + 4 * (at + Kc), p + 4 * (at + 2 * Kc))
    f32 = torch.float32
    return (buf[:Kc * H].view(Kc, H), buf[at:at + Kc].view(f32),
            buf[at + Kc:at + 2 * Kc].view(f32), buf[Kc * H])
