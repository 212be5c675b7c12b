"""Named scenario builders (``repro.montecarlo.scenarios``): a scenario
bundles race geometry (how many proposers, at what offsets) with a delay
model and runs itself over a mask table (``engine.build_mask_table``) in one
engine call.

  conflict_free      one proposer, pure fast-path order statistics
  k_way_race         K proposers staggered by delta
  mixed_workload     a fraction of commands race, the rest are clean
  wan                geo-distributed acceptors (multi-region delay table)
  lossy_acceptors    i.i.d. message loss on every hop
  grid_wan           a 3xC grid whose rows are the WAN regions
                     (returns scenario + masks)
  weighted_acceptors weighted voting with optional crashes
                     (returns scenario + masks)

Where the JAX package splits a scenario's key in two (the racing and the
conflict-free fractions), the port takes keys ``RACE_SPLIT`` and
``FREE_SPLIT`` of ``rng.SPLIT_DOMAIN``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.quorum import (ExplicitQuorumSystem, QuorumMasks,
                                     WeightedQuorumSystem)

from . import engine, rng, streaming
from .latency import (CrashedDelay, LossyDelay, WanDelay, crash_mask,
                      default_delay)


@dataclass(frozen=True)
class RunSpec:
    """Execution knobs of a scenario run, carried by the scenario
    (``scenario.with_spec(trials=10**7, faults=(0, 3)).stream(key, table)``).

    ``samples`` sizes materializing runs (``run``/``summary``), ``trials``
    streamed ones; ``chunk``/``precision`` default to the streaming
    module's when None.  ``shard`` splits a streamed run's trials over the
    trial mesh (``streaming.race_stream``).  ``faults`` crashes those
    acceptor ids for the run; ``regimes`` Markov-modulates a streamed run;
    ``recovery`` picks the collision-recovery rule
    (``engine.RECOVERY_MODES``).  The device picks every kernel, so there
    is no kernel switch."""

    samples: int = 20000
    trials: int = 1_000_000
    chunk: Optional[int] = None
    precision: Optional[float] = None
    shard: object = True
    k_max: object = "auto"
    faults: Tuple[int, ...] = ()
    regimes: Optional[object] = None
    recovery: str = "coordinated"

    def merged(self, **overrides) -> "RunSpec":
        """This spec with every non-None override applied."""
        kw = {k: v for k, v in overrides.items() if v is not None}
        return replace(self, **kw) if kw else self


@dataclass(frozen=True, eq=False)
class Scenario:
    """A runnable workload: K proposers at ``offsets_ms`` under ``delay``.

    ``conflict_frac`` < 1 mixes in conflict-free commands: the reported
    latency distribution is the blend.  ``spec`` carries the execution
    knobs (``RunSpec``)."""

    name: str
    n: int
    k_proposers: int
    offsets_ms: torch.Tensor            # (K,) f32
    delay: object
    conflict_frac: float = 1.0
    spec: RunSpec = RunSpec()

    def with_spec(self, spec: Optional[RunSpec] = None, **kw) -> "Scenario":
        """Override fields of the current spec (``with_spec(trials=...)``)
        or replace it (``with_spec(RunSpec(...))``, then the overrides)."""
        base = self.spec if spec is None else spec
        if kw:
            base = replace(base, **kw)
        return replace(self, spec=base)

    def with_faults(self, crashed: Sequence[int]) -> "Scenario":
        """Crash these acceptors: every hop touching one is lost."""
        if not len(tuple(crashed)):
            return self
        return replace(self, delay=CrashedDelay(
            self.delay, crash_mask(self.n, crashed)))

    def run(self, key: int, table) -> Dict[str, torch.Tensor]:
        """Evaluate every system of ``table`` over ``spec.samples``
        instances on the table's device: (M, S) ``latency_ms`` and the race
        outcome flags."""
        return self._run(key, table, self.spec)

    def _run(self, key: int, table, spec: RunSpec) -> Dict[str, torch.Tensor]:
        scen = self.with_faults(spec.faults)
        samples = spec.samples
        m = table["p1_w"].shape[0]
        if self.k_proposers == 1 or self.conflict_frac == 0.0:
            lat = engine.fast_path(key, table, scen.delay, n=self.n,
                                   samples=samples)
            undecided = lat >= engine.UNDECIDED_MS
            return {"latency_ms": lat, "reached_fast": ~undecided,
                    "recovery": torch.zeros((m, samples), dtype=torch.bool,
                                            device=lat.device),
                    "undecided": undecided,
                    "fast_winner": torch.where(undecided, -1, 0).to(
                        torch.int32)}

        k_race = rng.derive(key, rng.SPLIT_DOMAIN, rng.RACE_SPLIT)
        k_free = rng.derive(key, rng.SPLIT_DOMAIN, rng.FREE_SPLIT)
        n_conf = max(1, int(round(samples * self.conflict_frac)))
        out = engine.race(k_race, table, self.offsets_ms, scen.delay,
                          n=self.n, k_proposers=self.k_proposers,
                          samples=n_conf, recovery=spec.recovery)
        n_free = samples - n_conf
        if n_free > 0:
            scen_free = Scenario(self.name, self.n, 1, self.offsets_ms[:1],
                                 scen.delay)
            free = scen_free._run(k_free, table,
                                  replace(spec, samples=n_free, faults=()))
            out = {k: torch.cat([free[k], out[k]], dim=-1) for k in out}
        return out

    def summary(self, key: int, table) -> Dict[str, torch.Tensor]:
        """Per-system latency quantiles and outcome rates, each (M,);
        quantiles over decided instances only (``engine.summarize``)."""
        return engine.summarize(self._run(key, table, self.spec))

    def stream(self, key: int, table):
        """Streamed evaluation of ``spec.trials`` instances into a
        ``StreamSummary`` (a ``RegimeStreamSummary`` under
        ``spec.regimes``).  A mixed workload streams its racing and
        conflict-free fractions separately and merges the two."""
        return self._stream(key, table, self.spec)

    def _stream(self, key: int, table, spec: RunSpec):
        scen = self.with_faults(spec.faults)
        trials = spec.trials
        kw = dict(
            chunk=(streaming.DEFAULT_CHUNK if spec.chunk is None
                   else spec.chunk),
            precision=(streaming.DEFAULT_PRECISION if spec.precision is None
                       else spec.precision),
            shard=spec.shard, k_max=spec.k_max, regimes=spec.regimes)
        if self.k_proposers == 1 or self.conflict_frac == 0.0:
            return streaming.fast_path_stream(key, table, scen.delay,
                                              n=self.n, trials=trials, **kw)
        k_race = rng.derive(key, rng.SPLIT_DOMAIN, rng.RACE_SPLIT)
        k_free = rng.derive(key, rng.SPLIT_DOMAIN, rng.FREE_SPLIT)
        n_conf = max(1, int(round(trials * self.conflict_frac)))
        state = streaming.race_stream(k_race, table, self.offsets_ms,
                                      scen.delay, n=self.n,
                                      k_proposers=self.k_proposers,
                                      trials=n_conf, recovery=spec.recovery,
                                      **kw)
        if trials - n_conf > 0:
            free = streaming.fast_path_stream(k_free, table, scen.delay,
                                              n=self.n,
                                              trials=trials - n_conf, **kw)
            state = state.merge(free)
        return state


# ---------------------------------------------------------------------------
# Builders.
# ---------------------------------------------------------------------------

def _offsets(k: int, delta_ms: float) -> torch.Tensor:
    return delta_ms * torch.arange(k, dtype=torch.float32)


def conflict_free(n: int = 11, delay=None) -> Scenario:
    """A steady conflict-free stream: latency is the q2f-th order statistic
    of client -> acceptor -> learner paths."""
    return Scenario("conflict_free", n, 1, torch.zeros((1,)),
                    delay if delay is not None else default_delay())


def k_way_race(k: int, delta_ms: float = 0.5, n: int = 11,
               delay=None) -> Scenario:
    """K proposals race for one instance; proposer i submits at i * delta."""
    if k < 2:
        raise ValueError("a race needs at least 2 proposers")
    return Scenario(f"{k}_way_race", n, k, _offsets(k, delta_ms),
                    delay if delay is not None else default_delay())


def mixed_workload(conflict_frac: float = 0.10, delta_ms: float = 0.5,
                   k: int = 2, n: int = 11, delay=None) -> Scenario:
    """``conflict_frac`` of commands race (K-way, delta apart), the rest
    commit conflict-free."""
    base = k_way_race(k, delta_ms, n, delay)
    return replace(base, name="mixed_workload", conflict_frac=conflict_frac)


def wan(n: int = 11, k: int = 2, inter_region_ms: float = 30.0,
        n_regions: int = 3, delta_ms: float = 0.5) -> Scenario:
    """Acceptors round-robin across ``n_regions`` regions
    ``inter_region_ms`` apart (one-way), proposers in distinct regions."""
    delay = WanDelay.symmetric(inter_region_ms, n, k, n_regions)
    return Scenario("wan", n, k, _offsets(k, delta_ms), delay)


def lossy_acceptors(loss_prob: float = 0.01, k: int = 2,
                    delta_ms: float = 0.5, n: int = 11,
                    inner=None) -> Scenario:
    """Every hop independently drops with ``loss_prob``."""
    delay = LossyDelay(inner if inner is not None else default_delay(),
                       loss_prob)
    return Scenario("lossy_acceptors", n, k, _offsets(k, delta_ms), delay)


def grid_wan(cols: int = 3, k: int = 2, inter_region_ms: float = 30.0,
             delta_ms: float = 0.5,
             crashed: Sequence[int] = ()) -> Tuple[Scenario, QuorumMasks]:
    """A 3xC grid quorum system deployed so each grid row is a WAN region:
    acceptor r*cols + c sits in region r.  ``crashed`` injects acceptor
    failures (a whole row = a region outage)."""
    system = ExplicitQuorumSystem.grid(cols)
    n, rows = system.n, 3
    delay = WanDelay(oneway_ms=inter_region_ms * (1.0 - torch.eye(rows)),
                     acceptor_region=torch.arange(n) // cols,
                     proposer_region=torch.arange(k) % rows,
                     learner_region=0)
    if len(tuple(crashed)):
        delay = CrashedDelay(delay, crash_mask(n, crashed))
    return (Scenario("grid_wan", n, k, _offsets(k, delta_ms), delay),
            system.to_masks())


def weighted_acceptors(weights: Sequence[int] = (2, 2, 2, 1, 1, 1, 1, 1, 1,
                                                 1, 1),
                       thresholds: Optional[Tuple[int, int, int]] = None,
                       k: int = 2, delta_ms: float = 0.5,
                       crashed: Sequence[int] = ()
                       ) -> Tuple[Scenario, QuorumMasks]:
    """Weighted voting: heavyweight acceptors shrink fast-quorum
    cardinality while the FFP weight inequalities keep safety.  Default
    thresholds: t1 = ceil(3W/4), then the least valid phase-2 thresholds
    (t1 + t2c > W, t1 + 2*t2f > 2W)."""
    n, total = len(weights), sum(weights)
    if thresholds is None:
        t1 = math.ceil(3 * total / 4)
        t2c = total - t1 + 1
        t2f = (2 * total - t1) // 2 + 1
        thresholds = (t1, t2c, t2f)
    system = WeightedQuorumSystem(tuple(weights), *thresholds).validate()
    delay = default_delay()
    if len(tuple(crashed)):
        delay = CrashedDelay(delay, crash_mask(n, crashed))
    return (Scenario("weighted_acceptors", n, k, _offsets(k, delta_ms),
                     delay), system.to_masks())
