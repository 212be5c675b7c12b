"""K-proposer conflict-race engine over mask-encoded quorum systems
(``repro.montecarlo.engine`` in PyTorch).

Every entry point scores a batch of M quorum systems from one set of draws
(common random numbers).  The batch is a mask table (``build_mask_table``):
per-phase (M, G, n) float32 weights and (M, G) thresholds; an
all-cardinality table also carries ``"q"``, the (M, 3) int32 thresholds,
and then each masked saturation collapses to a k-th order statistic of the
presorted arrivals.  The two lowerings are bit-identical on cardinality
systems.

All randomness goes through three draw functions -- ``_draw_race``,
``_fast_path_draws`` and ``_classic_path_draws`` -- each taking a
``torch.Generator`` and returning plain tensors.  Everything after them is
deterministic, so a test can substitute the JAX package's draws and compare
the rest exactly.  The vote tallies go through ``kernels.quorum_tally.ops``:
on CUDA tensors the hand-written kernels, on CPU tensors their plain
versions.

All clocks are ms from proposer 0's submission.  Delays >= ``LOST_MS`` never
arrive; latencies >= ``UNDECIDED_MS`` mean "never decided".
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.quorum import QuorumMasks
from repro_torch.kernels.quorum_tally import ops as qt_ops

from . import latency as lat_mod
from . import rng
from .latency import LOST_MS, default_delay

BIG = LOST_MS
UNDECIDED_MS = LOST_MS / 2

MASK_KEYS = ("p1_w", "p1_t", "p2c_w", "p2c_t", "p2f_w", "p2f_t")

RECOVERY_MODES = ("coordinated", "uncoordinated")


# ---------------------------------------------------------------------------
# Mask tables.
# ---------------------------------------------------------------------------

def _sys_label(system, masks: QuorumMasks) -> str:
    label = getattr(masks, "label", "") or getattr(system, "label", "")
    return label or type(system).__name__


def build_mask_table(systems: Sequence, *, specialize: bool = True,
                     device=None) -> Dict[str, torch.Tensor]:
    """Batch M quorum systems into one mask table on ``device``.

    ``systems`` may mix anything with ``to_masks()`` and raw
    ``QuorumMasks``; all must share one n.  Each phase is padded to the max
    row count with never-satisfied rows.  When every system is
    cardinality-encodable the table also carries ``"q"`` (M, 3) int32,
    unless ``specialize=False``."""
    dev = device_mod.resolve(device)
    if not len(systems):
        raise ValueError("mask table needs at least one quorum system")
    masks = [s if isinstance(s, QuorumMasks) else s.to_masks()
             for s in systems]
    n = masks[0].n
    for i, m in enumerate(masks):
        if m.n != n:
            raise ValueError(
                f"mask table mixes cluster sizes: system {i} "
                f"({_sys_label(systems[i], m)}) has n={m.n} but system 0 "
                f"({_sys_label(systems[0], masks[0])}) has n={n}; "
                f"use QuorumMasks.embed() or rebuild the systems on one n")
    g1 = max(m.groups[0] for m in masks)
    g2c = max(m.groups[1] for m in masks)
    g2f = max(m.groups[2] for m in masks)
    padded = [m.pad_groups(g1, g2c, g2f) for m in masks]
    table = {k: np.stack([np.asarray(getattr(m, k), np.float32)
                          for m in padded]) for k in MASK_KEYS}
    if specialize:
        qs = [m.cardinality_q() for m in masks]
        if all(q is not None for q in qs):
            table["q"] = np.asarray(qs, np.int32)
    return table_from_numpy(table, device=dev)


def table_from_numpy(d: Dict, device=None) -> Dict[str, torch.Tensor]:
    """A mask table from ``{key: array}`` -- e.g. the JAX package's
    ``build_mask_table`` through ``np.asarray`` -- including ``"q"``."""
    dev = device_mod.resolve(device)
    out = {k: torch.from_numpy(np.array(d[k], np.float32)).to(dev)
           for k in MASK_KEYS}
    if "q" in d:
        out["q"] = torch.from_numpy(np.array(d["q"], np.int32)).to(dev)
    return out


def _check_mask_table(table, n: int) -> None:
    if not isinstance(table, dict):
        raise TypeError(f"expected a build_mask_table() dict, got "
                        f"{type(table).__name__}")
    missing = [k for k in MASK_KEYS if k not in table]
    if missing:
        raise ValueError(f"mask table missing entries {missing}; "
                         f"build with build_mask_table()")
    m_rows = table["p1_w"].shape[0] if table["p1_w"].dim() == 3 else -1
    for ph in ("p1", "p2c", "p2f"):
        w, t = table[ph + "_w"], table[ph + "_t"]
        if w.dim() != 3 or w.shape[-1] != n or t.shape != w.shape[:2]:
            raise ValueError(
                f"mask table phase {ph}: weights {tuple(w.shape)} / "
                f"thresholds {tuple(t.shape)} not (M, G, n={n}) / (M, G)")
    if "q" in table and tuple(table["q"].shape) != (m_rows, 3):
        raise ValueError(
            f"mask table 'q' specialization has shape "
            f"{tuple(table['q'].shape)}, expected ({m_rows}, 3)")


def _check_recovery(recovery: str) -> None:
    if recovery not in RECOVERY_MODES:
        raise ValueError(f"unknown recovery rule {recovery!r}; "
                         f"pick one of {RECOVERY_MODES}")


def saturation_depths(table: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    """Max prefix depths ``(k1, k2c, k2f)`` at which any quorum of the table
    can saturate: for a row with weights w and threshold t, the adversarial
    arrival order is ascending by weight, so the deepest first saturation is
    ``#{prefix sums of sorted(w) < t} + 1``; rows that cannot saturate at
    all are excluded.  Cardinality tables reduce to the column maxima of
    ``q``.  Host-side."""
    n = int(table["p1_w"].shape[-1])

    def depth(w, t):
        w = w.detach().cpu().numpy().astype(np.float64)
        t = t.detach().cpu().numpy().astype(np.float64)
        cs = np.cumsum(np.sort(w, axis=-1), axis=-1)
        saturable = cs[..., -1] >= t
        k_row = (cs < t[..., None]).sum(axis=-1) + 1
        k_row = np.where(saturable, k_row, 0)
        return int(k_row.max()) if k_row.size else 0

    if "q" in table:
        q = table["q"].detach().cpu().numpy()
        ks = (int(q[:, 0].max()), int(q[:, 1].max()), int(q[:, 2].max()))
    else:
        ks = (depth(table["p1_w"], table["p1_t"]),
              depth(table["p2c_w"], table["p2c_t"]),
              depth(table["p2f_w"], table["p2f_t"]))
    return tuple(min(n, max(1, k)) for k in ks)


# ---------------------------------------------------------------------------
# Sorted prefixes and order statistics.
# ---------------------------------------------------------------------------

def _topk_ascending(x: torch.Tensor, k: Optional[int]):
    """Smallest-k ascending prefix of a stable sort over the last axis and
    the matching permutation prefix (ties toward the lower index, the order
    of ``lax.top_k`` on the negated values).  ``k`` None (or >= n) keeps
    the full sort."""
    vals, perm = torch.sort(x, dim=-1, stable=True)
    if k is not None and k < x.shape[-1]:
        vals, perm = vals[..., :k], perm[..., :k]
    return vals, perm


def _sorted_prefix(x: torch.Tensor, k: Optional[int]) -> torch.Tensor:
    return _topk_ascending(x, k)[0]


def _kth(sorted_x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k-th order statistics (1-indexed) of a presorted (S, L) block for each
    of the (M,) thresholds ``k`` -> (M, S)."""
    idx = (k.long() - 1).clamp(0, sorted_x.shape[-1] - 1)
    return sorted_x[:, idx].T


def _counts_winner(votes: torch.Tensor, k_proposers: int):
    """(S, n) votes -> ((S, K) counts, (S,) winner, (S,) max count) through
    the fused tally+decide kernel.  Its threshold is a placeholder (0): the
    per-system thresholds are applied by ``_decide``."""
    counts, winner, max_cnt, _ = qt_ops.tally_decide(votes, k_proposers, 0)
    return counts, winner, max_cnt


# ---------------------------------------------------------------------------
# Draws: all randomness of the engine.
# ---------------------------------------------------------------------------

def _draw_race(gen: torch.Generator, offsets: torch.Tensor, delay, *, n: int,
               k_proposers: int, samples: int,
               recovery: str = "coordinated") -> Dict[str, torch.Tensor]:
    """Raw race draws: vote structure and unsorted arrivals.

    votes (S, n) int32 (-1 = no vote), arrive (S, n) phase-1 2b arrivals at
    the learner, val_arr (S, K, n) per-value 2b arrivals (BIG where the
    acceptor voted otherwise), classic (S, n) recovery-commit leg.  Both
    recovery legs are always drawn, so coordinated draws are identical
    across rules."""
    K = k_proposers
    d_prop = delay.sample_hops(gen, (samples, n, K), lat_mod.PROPOSAL)
    arrival = offsets.to(d_prop.dtype).expand(K) + d_prop
    # each acceptor votes for the first proposal to arrive (first index on
    # ties); no arrival at all means no vote.
    votes = torch.argmin(arrival, dim=-1).to(torch.int32)
    vote_time = arrival.amin(dim=-1)
    voted = vote_time < UNDECIDED_MS
    votes = torch.where(voted, votes, torch.full_like(votes, -1))

    d_ret = delay.sample_hops(gen, (samples, n), lat_mod.TO_LEARNER)
    big = torch.full_like(d_ret, BIG)
    arrive = torch.where(voted, vote_time + d_ret, big)
    arrive = torch.where(arrive < UNDECIDED_MS, arrive, big)

    vals = torch.arange(K, device=votes.device, dtype=torch.int32)
    val_arr = torch.where(votes[:, None, :] == vals[None, :, None],
                          arrive[:, None, :], BIG)

    d_2a = delay.sample_hops(gen, (samples, n), lat_mod.FROM_COORDINATOR)
    d_2b = delay.sample_hops(gen, (samples, n), lat_mod.TO_COORDINATOR)
    classic = d_2b if recovery == "uncoordinated" else d_2a + d_2b
    classic = torch.where(classic < UNDECIDED_MS, classic, big)
    return {"votes": votes, "arrive": arrive, "val_arr": val_arr,
            "classic": classic}


def _fast_path_draws(gen: torch.Generator, delay, n: int,
                     samples: int) -> torch.Tensor:
    """(S, n) conflict-free client -> acceptor -> learner path times."""
    d1 = delay.sample_hops(gen, (samples, n, 1), lat_mod.PROPOSAL)[..., 0]
    d2 = delay.sample_hops(gen, (samples, n), lat_mod.TO_LEARNER)
    path = d1 + d2
    return torch.where(path < UNDECIDED_MS, path, torch.full_like(path, BIG))


def _classic_path_draws(gen: torch.Generator, delay, n: int, samples: int):
    """((S,) client->leader hop, (S, n) leader round-trip times)."""
    d0 = delay.sample_hops(gen, (samples,), lat_mod.CLIENT_TO_LEADER)
    d1 = delay.sample_hops(gen, (samples, n), lat_mod.FROM_COORDINATOR)
    d2 = delay.sample_hops(gen, (samples, n), lat_mod.TO_COORDINATOR)
    path = d1 + d2
    return d0, torch.where(path < UNDECIDED_MS, path,
                           torch.full_like(path, BIG))


def _sample_race(gen: torch.Generator, offsets: torch.Tensor, delay, *,
                 n: int, k_proposers: int, samples: int, card: bool,
                 k_sat: Optional[Tuple[int, int, int]] = None,
                 recovery: str = "coordinated") -> Dict[str, torch.Tensor]:
    """Draw one race per sample and presort everything system-independent.

    ``card`` (cardinality tables): vote counts, winner and max count from
    the tally kernel, sorted prefixes only.  Otherwise (masked tables): the
    permutations ride along for the masked saturations.  ``k_sat`` cuts the
    presorts to prefixes of those depths (bit-identical to the full sort
    when it covers ``saturation_depths``).  Under uncoordinated recovery
    the classic presort deepens to the k2f prefix."""
    raw = _draw_race(gen, offsets, delay, n=n, k_proposers=k_proposers,
                     samples=samples, recovery=recovery)
    k1, k2c, k2f = k_sat if k_sat is not None else (None, None, None)
    if recovery == "uncoordinated":
        k2c = k2f
    out = {"votes": raw["votes"]}
    sv, pv = _topk_ascending(raw["val_arr"], k2f)
    sa, pa = _topk_ascending(raw["arrive"], k1)
    sc, pc = _topk_ascending(raw["classic"], k2c)
    out.update(sorted_val_arrive=sv, sorted_arrive=sa, sorted_classic=sc)
    if card:
        counts, winner, max_cnt = _counts_winner(raw["votes"], k_proposers)
        out.update(counts=counts, winner=winner, max_cnt=max_cnt)
    else:
        out.update(perm_val_arrive=pv, perm_arrive=pa, perm_classic=pc)
    return out


# ---------------------------------------------------------------------------
# Cardinality specialization: k-th order statistic gathers.
# ---------------------------------------------------------------------------

def _win_sorted(draws: Dict) -> torch.Tensor:
    """(S, L) presorted 2b arrivals of each sample's winning value, shared by
    every cardinality system."""
    sv = draws["sorted_val_arrive"]
    idx = draws["winner"].long()[:, None, None].expand(-1, 1, sv.shape[-1])
    return torch.gather(sv, 1, idx)[:, 0, :]


def _decide(draws: Dict, win_sorted: torch.Tensor, q: torch.Tensor,
            rec_col: int) -> Dict[str, torch.Tensor]:
    """Apply the (M, 3) threshold table to presorted draws -> (M, S)
    outcomes.  ``rec_col`` picks the recovery-commit threshold: q2c (1)
    under coordinated recovery, q2f (2) under uncoordinated."""
    q1, q_rec, q2f = q[:, 0], q[:, rec_col], q[:, 2]
    t_fast = _kth(win_sorted, q2f)
    # a fast commit needs q2f votes AND the q2f-th winner 2b to arrive.
    fast_ok = (draws["max_cnt"][None, :] >= q2f[:, None]) \
        & (t_fast < UNDECIDED_MS)
    t_recover = (_kth(draws["sorted_arrive"], q1)
                 + _kth(draws["sorted_classic"], q_rec))
    latency = torch.where(fast_ok, t_fast, t_recover)
    undecided = latency >= UNDECIDED_MS
    winner = draws["winner"][None, :].expand_as(fast_ok)
    return {"fast_winner": torch.where(fast_ok, winner,
                                       torch.full_like(winner, -1)),
            "reached_fast": fast_ok,
            "recovery": ~fast_ok & ~undecided,
            "undecided": undecided,
            "latency_ms": latency}


# ---------------------------------------------------------------------------
# General path: masked saturations.
# ---------------------------------------------------------------------------

def _sat_time(sorted_x: torch.Tensor, perm: torch.Tensor, w: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Earliest instant some quorum row of each system saturates.

    ``sorted_x``/``perm`` (S, L) shared by all systems or (M, S, L) one block
    per system: ascending arrivals and their acceptor ids; ``w`` (M, G, n),
    ``t`` (M, G).  Row g saturates at the first sorted position whose
    cumulative weight reaches t[g]; its time is the arrival there (the LOST
    sentinel when that arrival never happened).  Unreached rows give BIG.
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
    return torch.where(reached, tt, torch.full_like(tt, BIG)).amin(dim=1)


def _masked_vote_winner(votes: torch.Tensor, table: Dict[str, torch.Tensor],
                        k_proposers: int):
    """Which value (if any) gathered a full masked phase-2f quorum of
    round-1 votes, per system: all G fast rows of all M systems go through
    the masked-tally kernel in one flattened pass.  Returns winner (M, S)
    int32 (-1 when none) and reached (M, S) bool."""
    M, Gf, n = table["p2f_w"].shape
    per_q = qt_ops.masked_tally(votes, table["p2f_w"].reshape(M * Gf, n),
                                table["p2f_t"].reshape(M * Gf), k_proposers)
    per_q = per_q.reshape(votes.shape[0], M, Gf)
    nohit = torch.full_like(per_q, k_proposers)
    best = torch.where(per_q < 0, nohit, per_q).amin(dim=-1).T   # (M, S)
    reached = best < k_proposers
    winner = torch.where(reached, best, torch.full_like(best, -1))
    return winner.to(torch.int32), reached


def _decide_masked(draws: Dict, table: Dict[str, torch.Tensor],
                   winner: torch.Tensor, reached_votes: torch.Tensor,
                   rec_phase: str = "p2c") -> Dict[str, torch.Tensor]:
    """``_decide`` with each order-statistic gather replaced by a masked
    saturation over each system's rows; (M, S) outcomes."""
    sv, pv = draws["sorted_val_arrive"], draws["perm_val_arrive"]
    S, K, L = sv.shape
    M = winner.shape[0]
    widx = winner.long().clamp(0, K - 1)[:, :, None, None].expand(M, S, 1, L)
    win_sorted = torch.gather(sv[None].expand(M, S, K, L), 2, widx)[:, :, 0]
    win_perm = torch.gather(pv[None].expand(M, S, K, L), 2, widx)[:, :, 0]
    t_fast = _sat_time(win_sorted, win_perm, table["p2f_w"], table["p2f_t"])
    fast_ok = reached_votes & (t_fast < UNDECIDED_MS)
    t_detect = _sat_time(draws["sorted_arrive"], draws["perm_arrive"],
                         table["p1_w"], table["p1_t"])
    t_recover = t_detect + _sat_time(draws["sorted_classic"],
                                     draws["perm_classic"],
                                     table[rec_phase + "_w"],
                                     table[rec_phase + "_t"])
    latency = torch.where(fast_ok, t_fast, t_recover)
    undecided = latency >= UNDECIDED_MS
    return {"fast_winner": torch.where(fast_ok, winner,
                                       torch.full_like(winner, -1)),
            "reached_fast": fast_ok,
            "recovery": ~fast_ok & ~undecided,
            "undecided": undecided,
            "latency_ms": latency}


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

def _table_device(table) -> torch.device:
    return table["p1_w"].device


def _offsets(offsets, device) -> torch.Tensor:
    if offsets is None:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    return torch.as_tensor(offsets, dtype=torch.float32).to(device)


def _race_outcomes(gen: torch.Generator, table: Dict[str, torch.Tensor],
                   offsets: torch.Tensor, delay, *, n: int, k_proposers: int,
                   samples: int, k_sat: Optional[Tuple[int, int, int]] = None,
                   recovery: str = "coordinated") -> Dict[str, torch.Tensor]:
    """One race evaluation: sample + presort once, decide every system."""
    if delay is None:
        delay = default_delay()
    card = "q" in table
    draws = _sample_race(gen, offsets, delay, n=n, k_proposers=k_proposers,
                         samples=samples, card=card, k_sat=k_sat,
                         recovery=recovery)
    if card:
        rec_col = 1 if recovery == "coordinated" else 2
        return _decide(draws, _win_sorted(draws), table["q"], rec_col)
    winner, reached = _masked_vote_winner(draws["votes"], table, k_proposers)
    rec_phase = "p2c" if recovery == "coordinated" else "p2f"
    return _decide_masked(draws, table, winner, reached, rec_phase)


def race(key: int, table, offsets, delay=None, *, n: int, k_proposers: int,
         samples: int, recovery: str = "coordinated"
         ) -> Dict[str, torch.Tensor]:
    """K proposals race for one instance, scored under the M systems of
    ``table`` on the table's device from the draws of ``rng`` key ``key``.

    Returns (M, S) tensors: ``fast_winner`` (proposer id on a fast commit,
    else -1), ``reached_fast``, ``recovery``, ``undecided`` and
    ``latency_ms``.  ``recovery`` is "coordinated" (classic q2c round trip)
    or "uncoordinated" (q2f one-way round-2 votes)."""
    _check_mask_table(table, n)
    _check_recovery(recovery)
    dev = _table_device(table)
    return _race_outcomes(rng.generator(key, dev), table,
                          _offsets(offsets, dev), delay, n=n,
                          k_proposers=k_proposers, samples=samples,
                          recovery=recovery)


def _fast_path_outcomes(gen: torch.Generator, table, delay, *, n: int,
                        samples: int,
                        k_sat: Optional[Tuple[int, int, int]] = None
                        ) -> torch.Tensor:
    if delay is None:
        delay = default_delay()
    k2f = k_sat[2] if k_sat is not None else None
    path = _fast_path_draws(gen, delay, n, samples)
    srt, perm = _topk_ascending(path, k2f)
    if "q" in table:
        return _kth(srt, table["q"][:, 2])
    return _sat_time(srt, perm, table["p2f_w"], table["p2f_t"])


def fast_path(key: int, table, delay=None, *, n: int,
              samples: int) -> torch.Tensor:
    """(M, S) conflict-free fast-path commit latencies: each system's
    phase-2f saturation over client -> acceptor -> learner paths."""
    _check_mask_table(table, n)
    return _fast_path_outcomes(rng.generator(key, _table_device(table)),
                               table, delay, n=n, samples=samples)


def _classic_path_outcomes(gen: torch.Generator, table, delay, *, n: int,
                           samples: int,
                           k_sat: Optional[Tuple[int, int, int]] = None
                           ) -> torch.Tensor:
    if delay is None:
        delay = default_delay()
    k2c = k_sat[1] if k_sat is not None else None
    d0, path = _classic_path_draws(gen, delay, n, samples)
    srt, perm = _topk_ascending(path, k2c)
    if "q" in table:
        return d0[None, :] + _kth(srt, table["q"][:, 1])
    return d0[None, :] + _sat_time(srt, perm, table["p2c_w"], table["p2c_t"])


def classic_path(key: int, table, delay=None, *, n: int,
                 samples: int) -> torch.Tensor:
    """(M, S) leader-relayed classic commit latencies (phase-2c saturation
    after the client -> leader hop)."""
    _check_mask_table(table, n)
    return _classic_path_outcomes(rng.generator(key, _table_device(table)),
                                  table, delay, n=n, samples=samples)


# ---------------------------------------------------------------------------
# Summaries.
# ---------------------------------------------------------------------------

def summarize(out, dim: int = -1) -> Dict[str, torch.Tensor]:
    """Latency quantiles over the sample axis of (S,) or (M, S) results.

    For an outcome dict, undecided instances are excluded from the latency
    statistics and reported as ``undecided_rate`` beside the fast and
    recovery rates."""
    if isinstance(out, dict):
        lat = torch.where(out["undecided"], torch.nan, out["latency_ms"])
        extra = {
            "fast_rate": out["reached_fast"].float().mean(dim=dim),
            "recovery_rate": out["recovery"].float().mean(dim=dim),
            "undecided_rate": out["undecided"].float().mean(dim=dim),
        }
    else:
        lat, extra = out, {}
    probs = torch.tensor([0.5, 0.95, 0.99, 0.999, 0.9999],
                         dtype=lat.dtype, device=lat.device)
    q = torch.nanquantile(lat, probs, dim=dim)
    mx = torch.where(torch.isnan(lat), -torch.inf, lat).amax(dim=dim)
    return {
        "mean_ms": torch.nanmean(lat, dim=dim),
        "p50_ms": q[0], "p95_ms": q[1], "p99_ms": q[2],
        "p999_ms": q[3], "p9999_ms": q[4],
        "max_ms": torch.where(torch.isneginf(mx), torch.nan, mx),
        **extra,
    }
