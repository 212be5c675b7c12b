"""Streamed scorer: one mask batch, two stream passes, six frontier axes
(``repro.frontier.score`` in PyTorch).

``score_systems`` streams a family batch through one ``fast_path_stream``
pass and one ``race_stream`` pass -- every system sees the same draws --
and reduces the per-system axes to a Pareto frontier:

  fast_p50_ms    conflict-free fast-path median            (minimize)
  race_p999_ms   p99.9 commit latency under a K-way race   (minimize)
  p_recovery     P(recovery | race)                        (minimize)
  ft_fast / ft_phase1 / ft_classic   per-phase crash budgets (maximize)

Latency axes carry the sketch's relative ``precision`` as their dominance
epsilon and the rate axis a 3-sigma binomial epsilon at the trial count.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.quorum import QuorumMasks, QuorumSpec
from repro_torch.montecarlo import engine, rng, streaming

from .families import Member
from .pareto import Axis, FrontierResult, pareto_mask

DEFAULT_TRIALS = 1_000_000
DEFAULT_DELTA_MS = 0.2
DEFAULT_CHUNK = 8_192

AXIS_NAMES = ("fast_p50_ms", "race_p999_ms", "p_recovery", "ft_fast",
              "ft_phase1", "ft_classic")


def default_axes(precision: float = streaming.DEFAULT_PRECISION,
                 trials: int = DEFAULT_TRIALS) -> Tuple[Axis, ...]:
    """The standard six-axis frontier: sketch precision on latencies,
    3-sigma binomial noise on the recovery rate, exact crash budgets."""
    rate_eps = 3.0 * math.sqrt(0.25 / max(trials, 1))
    return (Axis("fast_p50_ms", maximize=False, eps=precision,
                 relative=True),
            Axis("race_p999_ms", maximize=False, eps=precision,
                 relative=True),
            Axis("p_recovery", maximize=False, eps=rate_eps),
            Axis("ft_fast", maximize=True),
            Axis("ft_phase1", maximize=True),
            Axis("ft_classic", maximize=True))


def _as_masks(systems: Sequence, n: Optional[int]
              ) -> Tuple[List[QuorumMasks], List, int]:
    """Members / systems / raw masks -> (masks on one n, native systems, n)."""
    native, masks = [], []
    for s in systems:
        if isinstance(s, Member):
            native.append(s.system)
            masks.append(s.masks())
        elif isinstance(s, QuorumMasks):
            native.append(s)
            masks.append(s)
        else:
            native.append(s)
            masks.append(s.to_masks())
    target = max(m.n for m in masks) if n is None else n
    masks = [m if m.n == target else m.embed(target) for m in masks]
    return masks, native, target


def _fault_tolerance(system, masks: QuorumMasks) -> Dict[str, int]:
    """Arithmetic for cardinality specs, brute force over the masks
    otherwise."""
    if isinstance(system, QuorumSpec):
        return system.fault_tolerance()
    return masks.fault_tolerance()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def score_systems(systems: Sequence, *,
                  trials: int = DEFAULT_TRIALS,
                  n: Optional[int] = None,
                  k_proposers: int = 2,
                  delta_ms: float = DEFAULT_DELTA_MS,
                  delay=None,
                  chunk: int = DEFAULT_CHUNK,
                  precision: float = streaming.DEFAULT_PRECISION,
                  shard=True,
                  k_max="auto",
                  seed: int = 0,
                  regimes=None,
                  recovery: str = "coordinated",
                  axes: Optional[Sequence[Axis]] = None,
                  device=None) -> FrontierResult:
    """Score a family batch on ``device`` (``None`` = the CUDA card) and
    return its Pareto frontier.

    ``systems`` mixes ``families.Member``, quorum systems and raw
    ``QuorumMasks``; smaller systems embed into the largest n present (or
    ``n``).  The batch streams through ``fast_path_stream`` and
    ``race_stream`` at ``trials`` trials each, on the keys of passes
    ``FAST_PASS`` / ``RACE_PASS`` under ``rng.root(seed)``, their trials
    split over the trial mesh by ``shard``.  ``shard`` and ``k_max`` as in
    ``race_stream``; ``regimes`` (a ``MarkovRegimes`` or its config)
    modulates both passes through failure epochs, and the axes then read
    the regime-merged totals; ``recovery`` picks the collision-recovery
    rule the race pass prices.  ``wall_s`` of the result holds each pass's
    wall time."""
    dev = device_mod.resolve(device)
    masks, native, n = _as_masks(systems, n)
    labels = tuple(m.label or f"system{i}" for i, m in enumerate(masks))
    table = engine.build_mask_table(masks, device=dev)
    axes = tuple(axes) if axes is not None else default_axes(precision,
                                                             trials)
    key = rng.root(seed)
    k_fast = rng.derive(key, rng.PASS_DOMAIN, rng.FAST_PASS)
    k_race = rng.derive(key, rng.PASS_DOMAIN, rng.RACE_PASS)
    offsets = delta_ms * torch.arange(k_proposers, dtype=torch.float32,
                                      device=dev)

    t0 = time.perf_counter()
    fast = streaming.fast_path_stream(k_fast, table, delay, n=n,
                                      trials=trials, chunk=chunk,
                                      precision=precision, shard=shard,
                                      k_max=k_max, regimes=regimes)
    _sync(dev)
    t1 = time.perf_counter()
    race = streaming.race_stream(k_race, table, offsets, delay, n=n,
                                 k_proposers=k_proposers, trials=trials,
                                 chunk=chunk, precision=precision,
                                 shard=shard, k_max=k_max, regimes=regimes,
                                 recovery=recovery)
    _sync(dev)
    t2 = time.perf_counter()

    fast_p50 = fast.quantile(0.5).double().cpu().numpy()
    race_p999 = race.quantile(0.999).double().cpu().numpy()
    p_rec = (race.n_recovery.double().cpu().numpy()
             / np.maximum(race.n_trials.double().cpu().numpy(), 1.0))
    ft = [_fault_tolerance(s, m) for s, m in zip(native, masks)]
    values = np.stack([
        fast_p50,
        race_p999,
        p_rec,
        np.array([f["steady_state_fast"] for f in ft], np.float64),
        np.array([f["phase1"] for f in ft], np.float64),
        np.array([f["phase2_classic"] for f in ft], np.float64),
    ], axis=1)
    return FrontierResult(labels=labels, axes=axes, values=values,
                          mask=pareto_mask(values, axes),
                          streams={"fast": fast, "race": race},
                          wall_s={"fast": t1 - t0, "race": t2 - t1})
