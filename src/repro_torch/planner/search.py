"""Successive-halving search over quorum-system families
(``repro.planner.search`` in PyTorch; DESIGN.md §11).

Exhaustive enumeration (``benchmarks.quorum_sweep``) scores every family
member at the full trial budget; that dies combinatorially past n ~ 20 for
weighted/grid families.  This module spends the budget where it matters:

  rung 0        score the WHOLE candidate batch cheaply (e.g. 10^5 streamed
                trials) and prune every system that is dominated *beyond
                what the cheap measurement can resolve*;
  rung 1..k-1   re-score the survivors at geometrically growing budgets,
                pruning again with correspondingly tighter margins;
  final rung    score the remaining systems at the full budget and return
                their exact Pareto frontier (``frontier.pareto``) — by the
                soundness argument below, it equals the frontier of the
                full exhaustive sweep.

The schedule (``Rung`` / ``default_schedule``) is plain data and the
control flow (``successive_halving``) takes an injected ``scorer``, so the
halving logic is testable without ever touching the engine; the
engine-backed scorer lives behind ``planner.cache.EngineCache``.

Pruning soundness.  A rung prunes candidate i only when some candidate j
*margin-dominates* it: j is weakly better on every exact axis (the
integral fault-tolerance budgets, which are trial-independent) and better
by more than the rung's noise margin on EVERY stochastic axis.  The margin
covers both the sketch's quantization cell and the Monte-Carlo noise at
the rung's trial count (``quantile_margin_cells`` / ``rate_margin``), so
margin-dominance at a cheap rung implies dominance at the full budget:

  * a pruned system is full-budget-dominated by the candidate that pruned
    it; following the (transitive, acyclic) chain of pruners lands on a
    survivor, so every pruned system is dominated by some survivor;
  * hence no member of the full-budget Pareto set is ever pruned, and the
    Pareto set *of the survivors* equals the Pareto set of the full space
    (tested against the direct sweep in tests/test_torch_planner.py).

Within-margin ties — systems the cheap rung cannot tell apart, including
the bit-exact ties common-random-number scoring produces for structurally
identical columns — are never split: both ride to the next rung, where a
tighter margin (or the final exact frontier) separates them.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.frontier.pareto import Axis, _REL_MIN, pareto_mask

# Margin multiplier: 1.0 = one sketch quantization cell plus ~1 sigma of
# Monte-Carlo noise per stochastic axis.  Common random numbers mean both
# estimates in a comparison share their trials, so the *difference* noise
# is far below the independent-estimate bound — empirically the n=11
# acceptance frontier survives intact down to slack 0.5 (2x headroom).
DEFAULT_SLACK = 1.0
# A quantile estimate is considered fully resolved once this many trials
# land past it; below that the pruning margin widens like 1/sqrt(tail).
_TAIL_RESOLVED = 50.0


# ---------------------------------------------------------------------------
# Plain-data schedule.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rung:
    """One successive-halving rung: a trial budget and a pruning slack.

    ``slack`` scales the per-axis noise margin (in measurement cells /
    sigma units) a competitor must clear on *every* stochastic axis to
    prune a candidate here.  The final rung's slack is irrelevant — it
    computes the exact frontier instead of pruning.
    """

    trials: int
    slack: float = DEFAULT_SLACK

    def __post_init__(self) -> None:
        if self.trials < 1:
            raise ValueError(f"rung trials must be >= 1, got {self.trials}")
        if self.slack <= 0:
            raise ValueError(f"rung slack must be > 0, got {self.slack}")


@dataclass(frozen=True)
class RungReport:
    """What one rung did (plain data, serializable)."""

    trials: int
    n_scored: int
    n_survivors: int
    wall_s: float = 0.0
    engine_compiles: int = 0

    def to_dict(self) -> Dict[str, float]:
        return {"trials": self.trials, "n_scored": self.n_scored,
                "n_survivors": self.n_survivors, "wall_s": self.wall_s,
                "engine_compiles": self.engine_compiles}


def default_schedule(final_trials: int, *, eta: int = 10,
                     min_trials: int = 10_000,
                     slack: float = DEFAULT_SLACK) -> Tuple[Rung, ...]:
    """Geometric rungs ``final/eta^k, ..., final/eta, final`` (ascending),
    stopping once another division would drop below ``min_trials``."""
    if final_trials < 1:
        raise ValueError(f"final_trials must be >= 1, got {final_trials}")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    trials = [final_trials]
    while trials[-1] // eta >= max(min_trials, 1):
        trials.append(trials[-1] // eta)
    return tuple(Rung(t, slack) for t in reversed(trials))


# ---------------------------------------------------------------------------
# Noise margins: how far apart two estimates must be before a cheap rung
# may call them "really different".
# ---------------------------------------------------------------------------

# Stochastic-axis semantics of the standard frontier (score.AXIS_NAMES):
# quantile axes carry the tail mass that determines their effective sample
# count; rate axes are binomial.  Axes not listed here (the integral
# fault-tolerance budgets) are exact and trial-independent.
STOCHASTIC_AXES: Dict[str, Tuple[str, float]] = {
    "fast_p50_ms": ("quantile", 0.5),
    "race_p999_ms": ("quantile", 0.001),
    "p_recovery": ("rate", 0.0),
}


def quantile_margin_cells(slack: float, trials: int, tail: float) -> float:
    """Pruning margin for a sketch-quantile axis, in log-gamma cells.

    One cell is the sketch's own relative error; on top of that the
    quantile estimate wobbles with the number of trials that land in the
    deciding tail (~ ``trials * tail``), widening like 1/sqrt(tail_n)
    until ``_TAIL_RESOLVED`` trials resolve the quantile to cell accuracy.
    """
    tail_n = max(float(trials) * tail, 1.0)
    return slack * (1.0 + math.sqrt(_TAIL_RESOLVED / tail_n))


def rate_margin(slack: float, trials: int) -> float:
    """Pruning margin for a binomial rate axis: slack x 3 sigma at the
    rung's trial count (worst-case p = 1/2 variance)."""
    return slack * 3.0 * math.sqrt(0.25 / max(trials, 1))


def _orient(values: np.ndarray, axes: Sequence[Axis]) -> np.ndarray:
    """(M, A) raw -> oriented "larger is better" float64; relative
    (sketch-valued) axes move to log-gamma space so margins are in cells;
    NaN (nothing decided) orients to -inf, i.e. worst."""
    v = np.asarray(values, np.float64)
    if v.ndim != 2 or v.shape[1] != len(axes):
        raise ValueError(f"values {v.shape} inconsistent with "
                         f"{len(axes)} axes")
    out = np.empty_like(v)
    with np.errstate(invalid="ignore", divide="ignore"):
        for a, ax in enumerate(axes):
            col = v[:, a]
            if ax.relative:
                gamma = (1.0 + ax.eps) / (1.0 - ax.eps)
                col = np.log(np.maximum(col, _REL_MIN)) / math.log(gamma)
            oriented = col if ax.maximize else -col
            out[:, a] = np.where(np.isnan(v[:, a]), -np.inf, oriented)
    return out


def prune_survivors(values: np.ndarray, axes: Sequence[Axis], rung: Rung,
                    ) -> np.ndarray:
    """(M,) bool: True = candidate survives this rung.

    Candidate i is pruned iff some j margin-dominates it:

      exact axes        (eps == 0, trial-independent)  j >= i
      stochastic axes   j better than i by more than the rung margin —
                        ``quantile_margin_cells`` cells on sketch axes,
                        ``rate_margin`` on rate axes — on EVERY one, with
                        at least one strictly-better finite comparison
                        (two systems that both never decide tie at -inf
                        and can prune nothing).

    Margin-dominance is irreflexive and asymmetric (the margin is strict
    somewhere), so duplicates and within-margin ties always survive
    together; pure numpy, O(M^2 A).
    """
    o = _orient(values, axes)
    m = o.shape[0]
    if m <= 1:
        return np.ones(m, bool)
    margins = np.zeros(len(axes))
    for a, ax in enumerate(axes):
        kind = STOCHASTIC_AXES.get(ax.name)
        if kind is None and ax.eps == 0.0:
            margins[a] = 0.0                       # exact axis
        elif kind is not None and kind[0] == "rate":
            margins[a] = rate_margin(rung.slack, rung.trials)
        elif kind is not None and kind[0] == "quantile":
            margins[a] = quantile_margin_cells(rung.slack, rung.trials,
                                               kind[1])
        else:
            # unknown stochastic axis: eps-scaled fallback margin
            margins[a] = rung.slack * max(ax.eps, 1.0 if ax.relative else 0.0)
    stoch = np.array([ax.name in STOCHASTIC_AXES or ax.eps > 0
                      for ax in axes])

    # [j, i, a]: does j clear the bar against i on axis a?
    with np.errstate(invalid="ignore"):
        diff = o[:, None, :] - o[None, :, :]       # j - i, (M, M, A)
        ok_exact = (o[:, None, ~stoch] >= o[None, :, ~stoch]).all(-1)
        # -inf vs -inf gives diff NaN: a tie, not a margin win — but it
        # must not veto domination either (both-never-decided axes carry
        # no information).  Treat NaN diff as "bar met, not strict".
        beyond = np.where(np.isnan(diff[:, :, stoch]), True,
                          diff[:, :, stoch] > margins[stoch][None, None, :])
        strict = np.where(np.isnan(diff[:, :, stoch]), False,
                          diff[:, :, stoch] > margins[stoch][None, None, :])
    dominated = (ok_exact & beyond.all(-1) & strict.any(-1)).any(axis=0)
    return ~dominated


# ---------------------------------------------------------------------------
# The halving loop (scorer injected — no engine in this file).
# ---------------------------------------------------------------------------

@dataclass
class SearchResult:
    """Outcome of one successive-halving search.

    ``frontier``           final-rung ``FrontierResult`` over the
                           survivors; its mask is the exact Pareto set of
                           the whole starting space (soundness argument in
                           the module docstring)
    ``members``            surviving candidates, aligned with
                           ``frontier.labels`` rows
    ``rungs``              per-rung reports (plain data)
    ``scored_trials``      sum over rungs of n_scored x trials (per engine
                           pass — fast and race scale identically)
    ``exhaustive_trials``  what the direct sweep would have cost:
                           n_candidates x final trials
    """

    frontier: object                       # FrontierResult
    members: List
    rungs: Tuple[RungReport, ...]
    scored_trials: int
    exhaustive_trials: int

    @property
    def budget_fraction(self) -> float:
        return self.scored_trials / max(self.exhaustive_trials, 1)

    @property
    def frontier_labels(self) -> Tuple[str, ...]:
        return self.frontier.frontier_labels

    def to_dict(self) -> Dict[str, float]:
        out = {"n_candidates": float(self.rungs[0].n_scored),
               "n_survivors": float(self.rungs[-1].n_scored),
               "n_frontier": float(len(self.frontier.frontier_indices)),
               "scored_trials": float(self.scored_trials),
               "exhaustive_trials": float(self.exhaustive_trials),
               "budget_fraction": float(self.budget_fraction),
               "engine_compiles": float(sum(r.engine_compiles
                                            for r in self.rungs))}
        for i, r in enumerate(self.rungs):
            for k, v in r.to_dict().items():
                out[f"rung{i}.{k}"] = float(v)
        return out


Scorer = Callable[[Sequence, int], object]


def successive_halving(candidates: Sequence, schedule: Sequence[Rung],
                       scorer: Scorer) -> SearchResult:
    """Run the rung schedule over ``candidates`` with an injected scorer.

    ``scorer(members, trials)`` returns a ``FrontierResult``-shaped object
    (``.values`` (M, A), ``.axes``, ``.mask``, ``.labels``) whose per-row
    scores must not depend on which other members share the batch (the
    streamed engine guarantees this via common random numbers); the last
    rung's result — restricted to survivors — is returned as the search's
    frontier.  Plain control flow: loops, numpy, no tensors.
    """
    schedule = tuple(schedule)
    if not schedule:
        raise ValueError("schedule needs at least one rung")
    if any(a.trials >= b.trials for a, b in zip(schedule, schedule[1:])):
        raise ValueError(
            f"rung trials must be strictly ascending, got "
            f"{tuple(r.trials for r in schedule)}")
    alive = list(candidates)
    if not alive:
        raise ValueError("successive_halving needs at least one candidate")
    n0 = len(alive)
    reports: List[RungReport] = []
    scored = 0
    result = None
    for idx, rung in enumerate(schedule):
        t0 = time.perf_counter()
        result = scorer(alive, rung.trials)
        wall = time.perf_counter() - t0
        scored += len(alive) * rung.trials
        compiles = int(getattr(result, "engine_compiles", 0) or 0)
        if idx + 1 == len(schedule):
            keep = np.asarray(result.mask, bool)    # exact final frontier
            n_surv = len(alive)                     # nothing pruned here
        else:
            keep = prune_survivors(np.asarray(result.values), result.axes,
                                   rung)
            n_surv = int(keep.sum())
        reports.append(RungReport(trials=rung.trials, n_scored=len(alive),
                                  n_survivors=n_surv, wall_s=wall,
                                  engine_compiles=compiles))
        if idx + 1 < len(schedule):
            alive = [mbr for mbr, k in zip(alive, keep) if k]
    return SearchResult(frontier=result, members=alive,
                        rungs=tuple(reports), scored_trials=scored,
                        exhaustive_trials=n0 * schedule[-1].trials)


# ---------------------------------------------------------------------------
# Engine-backed front door.
# ---------------------------------------------------------------------------

def search(systems: Sequence, *, final_trials: int = 1_000_000,
           schedule: Optional[Sequence[Rung]] = None,
           n: Optional[int] = None, k_proposers: int = 2,
           delta_ms: Optional[float] = None, delay=None,
           chunk: Optional[int] = None, precision: Optional[float] = None,
           shard=False, k_max="auto", seed: int = 0,
           slack: float = DEFAULT_SLACK, regimes=None,
           recovery: str = "coordinated", cache=None,
           device=None) -> SearchResult:
    """Successive-halving search through the streamed scorer, on
    ``device`` (``None`` = the CUDA card; ``"cpu"`` runs the kernels'
    plain versions).

    ``systems`` is any mix of ``frontier.families.Member``, quorum
    systems, or raw masks (the same front door as ``score_systems``); the
    scorer runs every rung through ``planner.cache.EngineCache`` so repeat
    table geometries reuse the kernels' launch plans (pass ``cache`` to
    share the pool across searches — the planner service does).  All rungs
    score with the SAME seed/chunk/precision, so the final rung's
    per-system values are those of a direct ``score_systems`` call over
    the full space at ``final_trials`` — the search changes *which*
    systems get the full budget, never their scores.
    """
    from repro_torch.frontier import score as fscore
    from .cache import EngineCache

    if schedule is None:
        schedule = default_schedule(final_trials, slack=slack)
    cache = cache if cache is not None else EngineCache()
    kwargs = dict(
        n=n, k_proposers=k_proposers,
        delta_ms=(delta_ms if delta_ms is not None
                  else fscore.DEFAULT_DELTA_MS),
        delay=delay,
        chunk=chunk if chunk is not None else fscore.DEFAULT_CHUNK,
        precision=precision, shard=shard, k_max=k_max, seed=seed,
        regimes=regimes, recovery=recovery, device=device)
    scorer = lambda members, trials: cache.score(members, trials=trials,
                                                 **kwargs)
    return successive_halving(list(systems), schedule, scorer)
