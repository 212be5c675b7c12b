"""Plain PyTorch versions of the quorum-tally kernels.

Each function computes exactly what its CUDA kernel in ``kernel.py``
computes, in eager torch.  The CPU path runs them (``ops.py`` picks them for
CPU tensors), the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds the kernels against them on the card.  Nothing on
the card's main path calls them.

Conventions shared with the JAX oracles: ties go to the lowest index (a
stable sort in place of ``lax.top_k``, first hit for ``argmax``), outputs
are int32, and float sums are plain f32 adds (elementwise products and
reductions), except ``race_card_hist``'s per-slot sums, one-hot products
as the JAX package takes them, which need TF32 off (torch's default).
"""
from __future__ import annotations

import math

import torch

from repro_torch.sketch import bucket_index, occurrences


def tally_votes(votes: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, n) votes (< 0 = no vote) -> (S, n_values) int32 counts."""
    vals = torch.arange(n_values, device=votes.device, dtype=votes.dtype)
    return (votes[..., None] == vals).sum(dim=-2).to(torch.int32)


def quorum_reached(votes: torch.Tensor, n_values: int, q: int
                   ) -> torch.Tensor:
    """(S,) bool: some value gathered >= q votes."""
    return (tally_votes(votes, n_values) >= q).any(dim=-1)


def tally_decide(votes: torch.Tensor, n_values: int, q) -> tuple:
    """Plain version of the fused tally+decide kernel.

    Returns (counts (S, V) int32, winner (S,) int32 argmax count with
    first-max tie-break, max_count (S,) int32, reached (S,) bool
    max count >= q)."""
    counts = tally_votes(votes, n_values)
    winner = torch.argmax(counts, dim=-1).to(torch.int32)
    max_count = counts.amax(dim=-1)
    return counts, winner, max_count, max_count >= q


def masked_tally(votes: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, n_values: int) -> torch.Tensor:
    """Plain version of the masked-tally kernel: per-quorum satisfied value.

    votes (S, n) int32 (< 0 = no vote); weights (G, n) f32; thresholds (G,)
    f32.  Returns (S, G) int32: the smallest value id whose voters' weight
    reaches ``thresholds[g]``, else -1 (always -1 on padding rows, whose
    zero weights never reach ``PAD_THRESHOLD``)."""
    vals = torch.arange(n_values, device=votes.device, dtype=votes.dtype)
    hit = (votes[:, None, :] == vals[None, :, None]).to(weights.dtype)
    wsum = (hit[:, :, None, :] * weights[None, None, :, :]).sum(dim=-1)
    sat = wsum >= thresholds                                # (S, V, G)
    first = torch.argmax(sat.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(sat.any(dim=1), first, torch.full_like(first, -1))


def _prefix_sat(x: torch.Tensor, w: torch.Tensor, t: torch.Tensor, k: int,
                big: float) -> torch.Tensor:
    """Earliest instant some quorum row of each system saturates, from the
    k smallest *unsorted* arrivals.

    x (S, n) shared by every system, or (M, S, n) one block per system;
    w (M, G, n) weights; t (M, G) thresholds.  Row g saturates at the first
    position of the stable ascending order at which its cumulative weight
    reaches t[g]; rows that do not within k positions get ``big``.  Exact
    whenever k >= ``engine.saturation_depths``.  Returns (M, S) f32."""
    k = min(int(k), x.shape[-1])
    srt, idx = torch.sort(x, dim=-1, stable=True)
    return masked_sat(srt[..., :k], idx[..., :k], w, t, big=big)


def sorted_prefix(x: torch.Tensor, k: int, *, order: bool) -> tuple:
    """The k smallest values of each row of ``x``'s last axis, ascending,
    ties to the lower position: ``torch.sort(stable=True)`` and its first k.
    Returns (values, their positions as int64 where ``order``, else
    None)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    if k < x.shape[-1]:
        vals, idx = vals[..., :k], idx[..., :k]
    return vals, (idx if order else None)


def check_sorted_prefix(x: torch.Tensor, k: int) -> None:
    """What sorted_prefix refuses, with ``ValueError``: other than f32 rows
    of at least one value, and k outside [1, n]."""
    if x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"sorted_prefix takes f32 rows, got dtype "
                         f"{x.dtype} and shape {tuple(x.shape)}")
    if not 1 <= k <= x.shape[-1]:
        raise ValueError(f"sorted_prefix takes 1 <= k <= n={x.shape[-1]}, "
                         f"got k={k}")


def masked_sat(sorted_x: torch.Tensor, perm: torch.Tensor, w: torch.Tensor,
               t: torch.Tensor, *, big: float) -> torch.Tensor:
    """Earliest instant some quorum row of each system saturates.

    ``sorted_x``/``perm`` (S, L) shared by all systems or (M, S, L) one block
    per system: ascending arrivals and their acceptor ids; ``w`` (M, G, n),
    ``t`` (M, G).  Row g saturates at the first sorted position whose
    cumulative weight reaches t[g]; its time is the arrival there (the LOST
    sentinel when that arrival never happened).  Unreached rows give ``big``.
    Returns the min over rows, (M, S)."""
    M, G, n = w.shape
    if sorted_x.dim() == 2:
        sorted_x = sorted_x.expand(M, -1, -1)
        perm = perm.expand(M, -1, -1)
    S, L = sorted_x.shape[1:]
    w_perm = torch.gather(w[:, :, None, :].expand(M, G, S, n), 3,
                          perm[:, None].expand(M, G, S, L))
    csum = torch.cumsum(w_perm, dim=-1)
    ok = csum >= t[:, :, None, None]
    idx = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
    reached = ok[..., -1]
    tt = torch.gather(sorted_x[:, None].expand(M, G, S, L), 3, idx)[..., 0]
    return torch.where(reached, tt, torch.full_like(tt, big)).amin(dim=1)


def check_masked_sat(sorted_x: torch.Tensor, perm: torch.Tensor,
                     w: torch.Tensor, t: torch.Tensor) -> None:
    """What masked_sat refuses, with ``ValueError``: weights not (M, G, n)
    with G >= 1, thresholds not (M, G), arrivals not (S, L) or (M, S, L)
    with 1 <= L <= n, ids not of the arrivals' shape, and any dtype but
    f32 arrivals, weights and thresholds and int64 ids (a sort's)."""
    if w.dim() != 3 or t.dim() != 2 or tuple(t.shape) != tuple(w.shape[:2]):
        raise ValueError(f"masked_sat takes weights (M, G, n) and thresholds "
                         f"(M, G), got {tuple(w.shape)} / {tuple(t.shape)}")
    M, G, n = w.shape
    if G < 1:
        raise ValueError("masked_sat takes G >= 1 quorum rows a system")
    if (sorted_x.dim() not in (2, 3) or perm.shape != sorted_x.shape
            or (sorted_x.dim() == 3 and sorted_x.shape[0] != M)):
        raise ValueError(f"masked_sat takes arrivals and ids (S, L) or "
                         f"(M={M}, S, L) of one shape, got "
                         f"{tuple(sorted_x.shape)} / {tuple(perm.shape)}")
    if not 1 <= sorted_x.shape[-1] <= n:
        raise ValueError(f"masked_sat takes 1 <= L <= n={n} sorted "
                         f"positions, got L={sorted_x.shape[-1]}")
    for x, name, dtype in ((sorted_x, "sorted_x", torch.float32),
                           (perm, "perm", torch.int64),
                           (w, "w", torch.float32), (t, "t", torch.float32)):
        if x.dtype != dtype:
            raise ValueError(f"masked_sat: {name} has dtype {x.dtype}, "
                             f"expected {dtype}")


def check_stream(S: int, n: int, k_sat: tuple) -> None:
    """What the stream kernels refuse, as JAX's does, with ``ValueError``: a
    chunk of 2^24 trials or more (f32 counts would no longer be exact) and a
    ``k_sat`` component outside [1, n]."""
    if S >= 2 ** 24:
        raise ValueError(f"chunk of {S} trials overflows exact f32 counts; "
                         f"stream smaller chunks")
    if len(k_sat) != 3 or not all(1 <= int(k) <= n for k in k_sat):
        raise ValueError(f"k_sat {k_sat} out of range for n={n}")


def check_pairs(pairs: torch.Tensor, k1: int, k_rec: int) -> None:
    """What race_card_hist refuses, with ``ValueError``: a recovery pair
    (q1, q_rec) outside [1, k1] x [1, k_rec]."""
    if pairs.numel():
        lo, hi = (x.tolist() for x in pairs.aminmax(dim=0))
        if min(lo) < 1 or hi[0] > k1 or hi[1] > k_rec:
            raise ValueError(f"recovery pairs span {lo}..{hi}, outside "
                             f"[1, {k1}] x [1, {k_rec}]")


def race_card_hist(votes: torch.Tensor, arrive: torch.Tensor,
                   classic: torch.Tensor, valid: torch.Tensor,
                   pairs: torch.Tensor, *, n_values: int, k_sat: tuple,
                   precision: float, bins: int, undecided_ms: float):
    """Plain version of the cardinality race chunk's fused kernel: tally,
    first-max decide, the order statistics and the chunk's fcap-slot
    histograms, sums and maxima over the valid trials.

    votes (C, n) int32 (< 0 = no vote); arrive / classic (C, n) f32 raw
    draws; valid (C,) bool; pairs (P, 2) int32 recovery pairs (q1, q_rec),
    each within ``k_sat`` = (k1, k_rec, k2f), k_rec the recovery-commit
    depth.  The winner's 2b arrivals are ``arrive`` where the trial voted
    the winner, else BIG = 2 * ``undecided_ms``.  A trial's slot is its fast
    capacity ``fcap = min(max count, #winner arrivals < undecided_ms among
    its k2f first)``, one of V = k2f + 1.

    Returns ``(FH, Fsum, Fmax, cnt, RH, Rsum, Rmax)``: FH (k2f, V, bins)
    int32 counts of the j-th winner arrival's bucket per slot, Fsum / Fmax
    (k2f, V) f32 their sum and max (-inf where empty), all three only for
    j < v (the cells the epilogue reads; zero and -inf elsewhere); cnt (V,)
    int32 trials per slot; RH (P, V, bins + 1) int32 counts of each pair's
    recovery latency ``t_rec = sorted_arrive[q1-1] + sorted_classic[q_rec-1]``
    per slot and bucket, bucket ``bins`` when ``t_rec >= undecided_ms``; Rsum
    / Rmax (P, V) f32 the decided ones' sum and max."""
    check_stream(*votes.shape, k_sat)
    k1, k_rec, k2f = (int(k) for k in k_sat)
    check_pairs(pairs, k1, k_rec)
    dev = votes.device
    _, winner, max_cnt, _ = tally_decide(votes, n_values, 0)
    win_row = torch.where(votes == winner[:, None], arrive,
                          2.0 * undecided_ms)
    win = torch.sort(win_row, dim=-1, stable=True)[0][:, :k2f]
    sa = torch.sort(arrive, dim=-1, stable=True)[0][:, :k1]
    sc = torch.sort(classic, dim=-1, stable=True)[0][:, :k_rec]
    C = win.shape[0]
    P = pairs.shape[0]
    V = k2f + 1                                          # fcap slots 0..k2f
    nfin = (win < undecided_ms).sum(dim=-1)
    fcap = torch.minimum(max_cnt.long(), nfin)
    vkey = torch.where(valid, fcap, V)                   # V = padding slot
    oh = (vkey[:, None] == torch.arange(V, device=dev)[None, :]).to(
        torch.float32)                                   # (C, V)
    below = (torch.arange(k2f, device=dev)[:, None]
             < torch.arange(V, device=dev)[None, :])     # (k2f, V): j < v

    # fast side: the winner's j-th arrival, per slot.
    bwin = bucket_index(win, precision).long()
    fkey = (torch.arange(k2f, device=dev)[None, :] * (V + 1)
            + vkey[:, None]) * bins + bwin
    FH = occurrences(fkey, k2f * (V + 1) * bins).reshape(
        k2f, V + 1, bins)[:, :V]
    FH = torch.where(below[:, :, None], FH, 0)
    Fsum = torch.where(below, win.T @ oh, 0.0)
    Fmax = torch.full((V + 1, k2f), -math.inf, device=dev).scatter_reduce_(
        0, vkey[:, None].expand(C, k2f), win, "amax")[:V].T
    Fmax = torch.where(below, Fmax, -math.inf)
    cnt = occurrences(vkey, V + 1)[:V]

    # recovery side: each (q1, q_rec) pair's latency, per slot.
    t_rec = (sa[:, pairs[:, 0].long() - 1]
             + sc[:, pairs[:, 1].long() - 1])            # (C, P)
    dec = t_rec < undecided_ms
    brec = torch.where(dec, bucket_index(t_rec, precision).long(), bins)
    rkey = (torch.arange(P, device=dev)[None, :] * (V + 1)
            + vkey[:, None]) * (bins + 1) + brec
    RH = occurrences(rkey, P * (V + 1) * (bins + 1)).reshape(
        P, V + 1, bins + 1)[:, :V]
    Rsum = torch.where(dec, t_rec, 0.0).T @ oh
    Rmax = torch.full((V + 1, P), -math.inf, device=dev).scatter_reduce_(
        0, vkey[:, None].expand(C, P), torch.where(dec, t_rec, -math.inf),
        "amax")[:V].T
    return FH, Fsum, Fmax, cnt, RH, Rsum, Rmax


def stream_decide(votes: torch.Tensor, val_arr: torch.Tensor,
                  arrive: torch.Tensor, classic: torch.Tensor,
                  w1: torch.Tensor, t1: torch.Tensor,
                  w2c: torch.Tensor, t2c: torch.Tensor,
                  w2f: torch.Tensor, t2f: torch.Tensor,
                  valid: torch.Tensor, *, n_values: int, k_sat: tuple,
                  undecided_ms: float) -> dict:
    """Per-trial half of ``stream_tally_decide_hist``: (M, S) ``latency_ms``
    and the valid-gated ``fast`` / ``recovery`` / ``undecided`` bits."""
    M, G, n = w2f.shape
    S = votes.shape[0]
    k1, k2c, k2f = k_sat
    big = 2.0 * undecided_ms
    per_q = masked_tally(votes, w2f.reshape(M * G, n), t2f.reshape(M * G),
                         n_values).reshape(S, M, G)
    best = torch.where(per_q < 0, torch.full_like(per_q, n_values),
                       per_q).amin(dim=-1).T                  # (M, S)
    reached = best < n_values
    widx = best.clamp(0, n_values - 1).long()
    win_x = torch.gather(val_arr[None].expand(M, S, n_values, n), 2,
                         widx[:, :, None, None].expand(M, S, 1, n))[:, :, 0]
    t_fast = _prefix_sat(win_x, w2f, t2f, k2f, big)
    t_rec = (_prefix_sat(arrive, w1, t1, k1, big)
             + _prefix_sat(classic, w2c, t2c, k2c, big))
    fast_ok = reached & (t_fast < undecided_ms)
    lat = torch.where(fast_ok, t_fast, t_rec)
    und = lat >= undecided_ms
    v = valid[None, :]
    return {"latency_ms": lat, "fast": fast_ok & v,
            "recovery": ~fast_ok & ~und & v, "undecided": und & v}


def stream_tally_decide_hist(votes: torch.Tensor, val_arr: torch.Tensor,
                             arrive: torch.Tensor, classic: torch.Tensor,
                             w1: torch.Tensor, t1: torch.Tensor,
                             w2c: torch.Tensor, t2c: torch.Tensor,
                             w2f: torch.Tensor, t2f: torch.Tensor,
                             valid: torch.Tensor, *, n_values: int,
                             k_sat: tuple, precision: float, bins: int,
                             undecided_ms: float):
    """Plain version of the fused streaming kernel over one chunk of *raw*
    (unsorted) trials: masked tally + top-k saturation + decide + DDSketch
    histogram, reduced over the chunk.

    votes (S, n) int32; val_arr (S, K, n) f32; arrive / classic (S, n) f32;
    w*/t* (M, G, n) / (M, G) masks per phase; valid (S,) bool; k_sat
    (k1, k2c, k2f) selection depths.  Returns ``(hist, stats)``: hist
    (M, bins) int32 over decided valid trials, stats ``n_fast`` /
    ``n_recovery`` / ``n_undecided`` (M,) int32, ``sum_ms`` (M,) f32 and
    ``max_ms`` (M,) f32 (-inf when nothing decided).  Refuses what the
    kernels refuse (``check_stream``)."""
    check_stream(*votes.shape, k_sat)
    d = stream_decide(votes, val_arr, arrive, classic, w1, t1, w2c, t2c, w2f,
                      t2f, valid, n_values=n_values, k_sat=k_sat,
                      undecided_ms=undecided_ms)
    lat, fast, rec = d["latency_ms"], d["fast"], d["recovery"]
    decided = fast | rec
    idx = bucket_index(lat, precision).long()
    hist = torch.zeros((lat.shape[0], bins), dtype=torch.int32,
                       device=votes.device)
    hist.scatter_add_(1, idx, decided.to(torch.int32))
    stats = {
        "n_fast": fast.sum(dim=-1).to(torch.int32),
        "n_recovery": rec.sum(dim=-1).to(torch.int32),
        "n_undecided": d["undecided"].sum(dim=-1).to(torch.int32),
        "sum_ms": torch.where(decided, lat, torch.zeros_like(lat)).sum(dim=-1),
        "max_ms": torch.where(decided, lat,
                              torch.full_like(lat, -torch.inf)).amax(dim=-1),
    }
    return hist, stats
