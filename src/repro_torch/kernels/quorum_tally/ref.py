"""Plain PyTorch versions of the quorum-tally kernels.

Each function computes exactly what its CUDA kernel in ``kernel.py``
computes, in eager torch.  The CPU path runs them (``ops.py`` picks them for
CPU tensors), the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds the kernels against them on the card.  Nothing on
the card's main path calls them.

Conventions shared with the JAX oracles: ties go to the lowest index (a
stable sort in place of ``lax.top_k``, first hit for ``argmax``), outputs
are int32, and float sums are plain f32 adds (elementwise products and
reductions, never a matrix product that TF32 could round).
"""
from __future__ import annotations

import torch


def tally_votes(votes: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, n) votes (< 0 = no vote) -> (S, n_values) int32 counts."""
    vals = torch.arange(n_values, device=votes.device, dtype=votes.dtype)
    return (votes[..., None] == vals).sum(dim=-2).to(torch.int32)


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
    M, G, n = w.shape
    k = min(int(k), x.shape[-1])
    srt, idx = torch.sort(x, dim=-1, stable=True)
    srt, idx = srt[..., :k], idx[..., :k]
    if x.dim() == 2:
        srt = srt.expand(M, -1, -1)
        idx = idx.expand(M, -1, -1)
    S = srt.shape[1]
    wp = torch.gather(w[:, :, None, :].expand(M, G, S, n), 3,
                      idx[:, None].expand(M, G, S, k))
    csum = torch.cumsum(wp, dim=-1)
    ok = csum >= t[:, :, None, None]                        # (M, G, S, k)
    first = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
    reached = ok[..., -1]
    tt = torch.gather(srt[:, None].expand(M, G, S, k), 3, first)[..., 0]
    return torch.where(reached, tt, torch.full_like(tt, big)).amin(dim=1)


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
    ``max_ms`` (M,) f32 (-inf when nothing decided)."""
    from repro_torch.montecarlo.streaming import bucket_index
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
