"""Hopper kernels for the quorum tally, bound with ctypes.

``csrc/quorum_tally.cu`` holds seven CUDA C++ kernels for ``sm_90a``; its
header says which TPU kernel each replaces, what bounds it on the card and
what its design does about that.  ``build()`` compiles the source with
``nvcc`` on first use into ``build/`` beside this file (git-ignored,
``kernels/_build.py``), and ``ctypes`` loads it.  Nothing is
compiled or loaded at import: this module imports on a machine without CUDA.

Every wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES[name]`` when it launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

from . import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quorum_tally.cu"

# The longest row sorted_prefix's networks sort (its C source's SP_MAX_N).
SORTED_PREFIX_MAX_N = 32

# Device memory the blocks of a launch work in together, where a block's
# tile does not fit in its shared memory (stream_tally_decide_hist,
# race_card_hist, masked_tally at large n): fewer blocks then, but at
# least one.
MAX_SCRATCH_BYTES = 2 ** 30

LAUNCHES: Dict[str, int] = {"tally_votes": 0, "tally_decide": 0,
                            "masked_tally": 0, "stream_tally_decide_hist": 0,
                            "race_card_hist": 0, "masked_sat": 0,
                            "sorted_prefix": 0}

_lib = None
_lib_lock = threading.Lock()
_MASKED_PLANS: Dict[tuple, tuple] = {}
_STREAM_PLANS: Dict[tuple, tuple] = {}
_CARD_PLANS: Dict[tuple, tuple] = {}
_SAT_PLANS: Dict[tuple, tuple] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Tuple[Path, str]:
    """Compile ``csrc/quorum_tally.cu`` unless an up-to-date library exists.
    Returns (library path, compiler log; empty when nothing was built)."""
    return _build.build(SOURCE, "quorum_tally")


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` with its C entry points' argument types."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L = ctypes.c_longlong
    lib.qt_tally_votes.argtypes = [P, I, I, I, P, P]
    lib.qt_tally_decide.argtypes = [P, I, I, I, I, P, P, P, P, P]
    lib.qt_masked_plan.argtypes = [I, I, I, ctypes.POINTER(L)]
    lib.qt_masked_tally.argtypes = [P, P, P] + [I] * 7 + [P, L, P, P]
    lib.qt_stream_plan.argtypes = [I] * 6 + [ctypes.POINTER(I)]
    lib.qt_stream_tally_decide_hist.argtypes = (
        [P] * 11 + [I] * 10 + [F, I, F] + [I] * 5 + [P] * 10)
    lib.qt_card_plan.argtypes = [I] * 5 + [ctypes.POINTER(L)]
    lib.qt_race_card_hist.argtypes = (
        [P] * 5 + [I] * 7 + [F, I, F] + [I] * 6 + [P, L, L] + [P] * 11)
    lib.qt_sat_plan.argtypes = [I] * 4 + [ctypes.POINTER(L)]
    lib.qt_masked_sat.argtypes = ([P] * 5 + [L] * 4 + [I] * 9 + [F]
                                  + [I] * 3 + [P])
    lib.qt_sorted_prefix.argtypes = [P, L, I, I, I, P, P, P]
    for f in ("qt_tally_votes", "qt_tally_decide", "qt_masked_plan",
              "qt_masked_tally", "qt_stream_plan",
              "qt_stream_tally_decide_hist", "qt_card_plan",
              "qt_race_card_hist", "qt_sat_plan", "qt_masked_sat",
              "qt_sorted_prefix"):
        getattr(lib, f).restype = I
    return lib


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(build()[0])
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


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
    _check(votes, "votes", torch.int32, (S, n), dev)
    counts = torch.empty((S, n_values), dtype=torch.int32, device=dev)
    if S:
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.qt_tally_votes(votes.data_ptr(), S, n, n_values,
                                     counts.data_ptr(), _stream(dev))
        _raise_on(err, "tally_votes")
        LAUNCHES["tally_votes"] += 1
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
    _check(votes, "votes", torch.int32, (S, n), dev)
    counts = torch.empty((S, n_values), dtype=torch.int32, device=dev)
    winner = torch.empty((S,), dtype=torch.int32, device=dev)
    max_count = torch.empty((S,), dtype=torch.int32, device=dev)
    reached = torch.empty((S,), dtype=torch.bool, device=dev)
    if S:
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.qt_tally_decide(
                votes.data_ptr(), S, n, n_values, int(q), counts.data_ptr(),
                winner.data_ptr(), max_count.data_ptr(), reached.data_ptr(),
                _stream(dev))
        _raise_on(err, "tally_decide")
        LAUNCHES["tally_decide"] += 1
    return counts, winner, max_count, reached


def _masked_plan(lib, dev, n: int, G: int, K: int) -> tuple:
    """(rows a chunk, shared memory, blocks the card holds at once,
    device-memory bytes a block works in, 0 where it works in shared
    memory, trials a tile) for a shape, from ``qt_masked_plan`` once per
    device and shape."""
    key = (dev.index, n, G, K)
    plan = _MASKED_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 5)()
        with torch.cuda.device(dev):
            err = lib.qt_masked_plan(n, G, K, out)
        _raise_on(err, "masked_tally plan")
        plan = _MASKED_PLANS[key] = tuple(out)
    return plan


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
    _check(votes, "votes", torch.int32, (S, n), dev)
    _check(weights, "weights", torch.float32, (G, n), dev)
    _check(thresholds, "thresholds", torch.float32, (G,), dev)
    if G >= 2 ** 31:
        raise ValueError(f"masked_tally takes G < 2^31 rows, got {G}")
    out = torch.empty((S, G), dtype=torch.int32, device=dev)
    if S and G:
        lib = _load()
        rc, smem, blocks, region, tile = _masked_plan(lib, dev, n, G,
                                                      n_values)
        nbx = max(1, min(-(-S // tile) * -(-G // rc), blocks))
        scratch = None
        if region:  # the blocks work in device memory: at most 1 GiB of it
            nbx = max(1, min(nbx, MAX_SCRATCH_BYTES // region))
            scratch = torch.empty(nbx * region, dtype=torch.uint8,
                                  device=dev)
        with torch.cuda.device(dev):
            err = lib.qt_masked_tally(
                votes.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
                S, n, G, n_values, rc, smem, nbx,
                None if scratch is None else scratch.data_ptr(), region,
                out.data_ptr(), _stream(dev))
        _raise_on(err, "masked_tally")
        LAUNCHES["masked_tally"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _log_gamma(precision: float) -> float:
    from repro_torch.montecarlo.streaming import sketch_gamma
    return math.log(sketch_gamma(precision))


def _stream_plan(lib, dev, n: int, K: int, M: int, G: tuple) -> tuple:
    """(systems a block, threads, shared memory, blocks the card holds at
    once, masks resident in shared memory, device-memory bytes a block
    stages its tile in) for a shape, from ``qt_stream_plan`` once per
    device and shape."""
    key = (dev.index, n, K, M, G)
    plan = _STREAM_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(dev):
            err = lib.qt_stream_plan(n, K, M, *G, out)
        if err == -1:
            raise ValueError(f"32 trials' K={K} rows of n={n} acceptors "
                             f"exceed the 1 GiB of device memory a block "
                             f"may stage them in")
        _raise_on(err, "stream_tally_decide_hist plan")
        plan = _STREAM_PLANS[key] = tuple(out)
    return plan


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
            _check(t, name, dtype, shape, dev)
    ref.check_stream(S, n, k_sat)
    ks = tuple(int(k) for k in k_sat)
    if not 1 <= M <= 65535:
        raise ValueError(f"stream kernel takes 1 <= M <= 65535 systems, "
                         f"got {M}")
    if max(G1, G2c, G2f) > 65535:
        raise ValueError(f"stream kernel takes at most 65535 quorum rows a "
                         f"phase, got {(G1, G2c, G2f)}")
    lib = _load()
    mg, threads, smem, blocks, res, big = _stream_plan(lib, dev, n, K, M,
                                                       (G1, G2c, G2f))
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
        with torch.cuda.device(dev):
            err = lib.qt_stream_tally_decide_hist(
                votes.data_ptr(), val_arr.data_ptr(), arrive.data_ptr(),
                classic.data_ptr(), w1.data_ptr(), t1.data_ptr(),
                w2c.data_ptr(), t2c.data_ptr(), w2f.data_ptr(),
                t2f.data_ptr(), valid.data_ptr(), S, n, K, M, G1, G2c, G2f,
                ks[0], ks[1], ks[2], _log_gamma(precision), bins,
                float(undecided_ms), mg, threads, smem, nbx, res,
                None if scratch is None else scratch.data_ptr(), p,
                p + 4 * nz, p + 4 * M * bins, p + 4 * (nz + 3 * M),
                p + 4 * (nz + 4 * M), p + 4 * (nz + 5 * M),
                p + 4 * (nz + 5 * M + M * nbx), p + 4 * (nz + 3 * M + nf),
                _stream(dev))
        _raise_on(err, "stream_tally_decide_hist")
        LAUNCHES["stream_tally_decide_hist"] += 1
    else:
        buf[:nz + 4 * M].zero_()
        max_ms.fill_(-math.inf)
    return hist, {"n_fast": n_fast, "n_recovery": n_rec,
                  "n_undecided": n_und, "sum_ms": sum_ms, "max_ms": max_ms}


def _card_plan(lib, dev, n: int, P: int, ks: tuple) -> tuple:
    """(column groups, column threads a group, threads, shared memory,
    blocks the card holds at once, device-memory bytes a block works in, 0
    where it works in shared memory, trials a tile) for a shape, from
    ``qt_card_plan`` once per device and shape."""
    key = (dev.index, n, P, ks)
    plan = _CARD_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 7)()
        with torch.cuda.device(dev):
            err = lib.qt_card_plan(n, P, *ks, out)
        _raise_on(err, "race_card_hist plan")
        plan = _CARD_PLANS[key] = tuple(out)
    return plan


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
        _check(t, name, dtype, shape, dev)
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
    lib = _load()
    G, q32, threads, smem, blocks, region, tile = _card_plan(lib, dev, n,
                                                             P, ks)
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
    with torch.cuda.device(dev):
        err = lib.qt_race_card_hist(
            votes.data_ptr(), arrive.data_ptr(), classic.data_ptr(),
            valid.data_ptr(), pairs.data_ptr(), S, n, K, P, k1, kr, k2f,
            _log_gamma(precision), bins, float(undecided_ms), G, q32,
            threads, smem, nbx, gb,
            None if scratch is None else scratch.data_ptr(), region,
            4 * at[4], *(p0 + 4 * o for o in at[:len(sizes)]), _stream(dev))
    _raise_on(err, "race_card_hist")
    LAUNCHES["race_card_hist"] += 1
    f32 = torch.float32
    return (region_of(0, k2f, V, bins), region_of(4, k2f, V, dtype=f32),
            region_of(5, k2f, V, dtype=f32), region_of(2, V),
            region_of(1, P, V, bins + 1), region_of(6, P, V, dtype=f32),
            region_of(7, P, V, dtype=f32))


def _sat_plan(lib, dev, n: int, L: int, M: int, G: int) -> tuple:
    """(systems a block, shared memory, blocks the card holds at once, rows
    resident in shared memory, orders held in registers, trials a tile) for
    a shape, from ``qt_sat_plan`` once per device and shape."""
    key = (dev.index, n, L, M, G)
    plan = _SAT_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 6)()
        with torch.cuda.device(dev):
            err = lib.qt_sat_plan(n, L, M, G, out)
        _raise_on(err, "masked_sat plan")
        plan = _SAT_PLANS[key] = tuple(out)
    return plan


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
    _check(w, "w", torch.float32, (M, G, n), dev)
    _check(t, "t", torch.float32, (M, G), dev)
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
    lib = _load()
    mg, smem, blocks, res, reg, tile = _sat_plan(lib, dev, n, L, M, G)
    gy = -(-M // mg)
    gx = max(1, min(-(-S // tile), blocks // gy))
    per = sorted_x.dim() == 3
    xs, ps = sorted_x.stride(-2), perm.stride(-2)
    xm = sorted_x.stride(0) if per else 0
    pm = perm.stride(0) if per else 0
    vec = perm.data_ptr() % 16 == 0 and ps % 2 == 0 and pm % 2 == 0
    with torch.cuda.device(dev):
        err = lib.qt_masked_sat(
            sorted_x.data_ptr(), perm.data_ptr(), w.data_ptr(), t.data_ptr(),
            out.data_ptr(), xs, xm, ps, pm, S, L, n, M, G, mg, gx, gy, smem,
            float(big), int(res), int(reg), int(vec), _stream(dev))
    _raise_on(err, "masked_sat")
    LAUNCHES["masked_sat"] += 1
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
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.qt_sorted_prefix(
                x.data_ptr(), S, n, k, int(x.data_ptr() % 16 == 0),
                vals.data_ptr(), None if ids is None else ids.data_ptr(),
                _stream(dev))
        _raise_on(err, "sorted_prefix")
        LAUNCHES["sorted_prefix"] += 1
    return vals, ids
