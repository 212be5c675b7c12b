"""``Experiment``: declare once -- model-check, simulate and sample
(``repro.api.experiment`` in PyTorch).

    exp = Experiment(systems=[QuorumSpec.paper_headline(11),
                              ExplicitQuorumSystem.grid(3).embed(11),
                              weighted_system],
                     workload=Workload.race(k=2, delta_ms=0.2),
                     samples=20_000)
    mc  = exp.run("montecarlo")     # mask-table engine, on the card
    des = exp.run("des")            # protocol state machines, per system
    mc.to_dict()                    # flat {label.metric: float}

Layering:

    declare        Experiment(systems, workload, faults, ...)
    lower          QuorumMasks via build_mask_table for the Monte-Carlo
                   backend; the systems themselves for the set-level
                   backends (DES, model checker)
    dispatch       one backend call; Results normalizes the outputs

The Monte-Carlo backend runs on ``device`` (``None`` = the CUDA card, an
error where there is none; ``"cpu"`` runs the kernels' plain versions) and
goes through the same kernel dispatch as the streams: the tensor's device
picks the kernel.  The DES and model-check backends run on the host.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import random
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import device as device_mod
from repro_torch.core.model_check import explore
from repro_torch.core.quorum import (ExplicitQuorumSystem, QuorumMasks,
                                     QuorumSpec, RelaxedQuorumSpec,
                                     WeightedQuorumSystem)
from repro_torch.core.simulator import FastPaxosSim, LatencyModel
from repro_torch.montecarlo import engine, rng, streaming
from repro_torch.montecarlo.latency import (CrashedDelay, LossyDelay,
                                            ShiftedLognormalDelay, WanDelay,
                                            crash_mask, delay_from_config,
                                            delay_kinds, delay_to_config)
from repro_torch.montecarlo.regimes import MarkovRegimes
from repro_torch.montecarlo.scenarios import Scenario

BACKENDS = ("montecarlo", "des", "modelcheck")

# Instances this far apart are independent races in the DES (delays are a
# few ms); the spacing the cross-validation suite uses.
_DES_GAP_MS = 50.0

# Brute-force crash-set enumeration is exponential; past this n it is
# skipped and Results.fault_tolerance is None.
_FT_MAX_N = 14


# ---------------------------------------------------------------------------
# Workload: backend-independent race geometry + delay model.
# ---------------------------------------------------------------------------

def _check_workload_keys(cfg: Dict[str, Any], valid: set, what: str) -> None:
    """Reject unknown top-level keys with the offending names and the valid
    set."""
    unknown = sorted(set(cfg) - valid)
    if unknown:
        raise ValueError(f"unknown {what} key(s) {unknown}; "
                         f"valid keys: {sorted(valid)}")


def _check_delay_config(d) -> None:
    """Validate serialized delay-model ``kind`` names (through wrapper
    ``inner`` configs) against the registry at parse time."""
    while isinstance(d, dict):
        kind = d.get("kind")
        if kind not in delay_kinds():
            raise ValueError(f"unknown delay kind {kind!r}; "
                             f"known kinds: {delay_kinds()}")
        d = d.get("inner")


@dataclass(frozen=True)
class Workload:
    """What the cluster is asked to do, independent of any quorum system.

    ``k_proposers`` values race for each instance (1: conflict-free),
    proposer i submitting at ``i * delta_ms``; ``conflict_frac`` < 1 mixes
    in conflict-free commands.  ``delay`` is a delay model or its config
    dict (``None`` = the EC2 fit the DES backend shares);
    ``inter_region_ms`` instead builds a WAN placement once the cluster
    size is known, and ``loss_prob`` wraps the model with i.i.d. loss.
    ``regimes`` (a ``MarkovRegimes`` or its config dict) Markov-modulates
    streamed runs.  ``recovery`` picks the collision-recovery rule.

    ``to_dict()`` / ``from_dict()`` round-trip every constructor through
    the JAX package's JSON (``examples/scenarios/*.json``)."""

    name: str = "conflict_free"
    k_proposers: int = 1
    delta_ms: float = 0.0
    conflict_frac: float = 1.0
    delay: object = None
    inter_region_ms: Optional[float] = None
    n_regions: int = 3
    loss_prob: float = 0.0
    des_requests: int = 1200        # DES backend sample count (per system)
    regimes: object = None          # MarkovRegimes | config dict | None
    recovery: str = "coordinated"   # collision-recovery rule

    def __post_init__(self) -> None:
        if self.k_proposers < 1:
            raise ValueError(
                f"k_proposers must be >= 1 (1 = conflict-free), "
                f"got {self.k_proposers}")
        engine._check_recovery(self.recovery)

    # -- constructors ------------------------------------------------------
    @classmethod
    def conflict_free(cls, delay=None, **kw) -> "Workload":
        """A steady conflict-free stream."""
        return cls(name="conflict_free", delay=delay, **kw)

    @classmethod
    def race(cls, k: int = 2, delta_ms: float = 0.5, delay=None,
             **kw) -> "Workload":
        """K proposals race for every instance, staggered by delta."""
        if k < 2:
            raise ValueError("a race needs at least 2 proposers")
        return cls(name=f"{k}_way_race", k_proposers=k, delta_ms=delta_ms,
                   delay=delay, **kw)

    @classmethod
    def mixed(cls, conflict_frac: float = 0.10, delta_ms: float = 0.5,
              k: int = 2, delay=None, **kw) -> "Workload":
        """``conflict_frac`` of commands race, the rest are clean."""
        return cls(name="mixed_workload", k_proposers=k, delta_ms=delta_ms,
                   conflict_frac=conflict_frac, delay=delay, **kw)

    @classmethod
    def wan(cls, k: int = 2, inter_region_ms: float = 30.0,
            n_regions: int = 3, delta_ms: float = 0.5, **kw) -> "Workload":
        """Geo-distributed acceptors round-robin across regions."""
        return cls(name="wan", k_proposers=k, delta_ms=delta_ms,
                   inter_region_ms=inter_region_ms, n_regions=n_regions,
                   **kw)

    @classmethod
    def lossy(cls, loss_prob: float = 0.01, k: int = 2,
              delta_ms: float = 0.5, delay=None, **kw) -> "Workload":
        """Every hop independently drops with ``loss_prob``."""
        return cls(name="lossy", k_proposers=k, delta_ms=delta_ms,
                   loss_prob=loss_prob, delay=delay, **kw)

    # -- declarative config ------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """A plain JSON-ready dict; fields at their defaults are dropped."""
        regimes = self.regimes
        if isinstance(regimes, MarkovRegimes):
            regimes = regimes.to_config()
        cfg: Dict[str, Any] = {
            "name": self.name, "k_proposers": self.k_proposers,
            "delta_ms": float(self.delta_ms),
            "conflict_frac": float(self.conflict_frac),
            "delay": (self.delay if isinstance(self.delay, dict)
                      else delay_to_config(self.delay)),
            "inter_region_ms": (None if self.inter_region_ms is None
                                else float(self.inter_region_ms)),
            "n_regions": self.n_regions,
            "loss_prob": float(self.loss_prob),
            "des_requests": self.des_requests, "regimes": regimes,
            "recovery": self.recovery}
        defaults = Workload()
        return {k: v for k, v in cfg.items()
                if v is not None and v != getattr(defaults, k, None)
                or k == "name"}

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "Workload":
        """Build from ``to_dict`` output or the ``{"kind": ...}``
        constructor shorthand.  Delay and regime configs stay declarative
        until a cluster size is known, but their registry names are checked
        here."""
        cfg = dict(cfg)
        kind = cfg.pop("kind", None)
        if kind is not None:
            ctors = {"conflict_free": cls.conflict_free, "race": cls.race,
                     "mixed": cls.mixed, "wan": cls.wan, "lossy": cls.lossy}
            if kind not in ctors:
                raise ValueError(f"unknown workload kind {kind!r}; "
                                 f"pick one of {sorted(ctors)}")
            ctor = ctors[kind]
            named = [p.name for p in
                     inspect.signature(ctor).parameters.values()
                     if p.kind is not inspect.Parameter.VAR_KEYWORD]
            valid = set(named) | (set(cls.__dataclass_fields__) - {"name"})
            _check_workload_keys(cfg, valid, f"workload kind {kind!r}")
            _check_delay_config(cfg.get("delay"))
            return ctor(**cfg)
        _check_workload_keys(cfg, set(cls.__dataclass_fields__), "workload")
        _check_delay_config(cfg.get("delay"))
        return cls(**cfg)

    # -- lowering ----------------------------------------------------------
    def delay_for(self, n: int):
        d = self.delay
        if isinstance(d, dict):             # serialized form: resolve now
            d = delay_from_config(d, n)
        if d is None and self.inter_region_ms is not None:
            d = WanDelay.symmetric(self.inter_region_ms, n,
                                   self.k_proposers, self.n_regions)
        if d is None:
            d = ShiftedLognormalDelay()
        if self.loss_prob:
            d = LossyDelay(d, self.loss_prob)
        return d

    def regimes_for(self, n: int) -> Optional[MarkovRegimes]:
        """The regime chain with config dicts resolved for a cluster of
        ``n`` (base-delay inheritance waits until the stream binds it)."""
        if self.regimes is None:
            return None
        if isinstance(self.regimes, MarkovRegimes):
            return self.regimes.validate()
        return MarkovRegimes.from_config(self.regimes, n)

    def scenario(self, n: int, faults: Sequence[int] = (),
                 device=None) -> Scenario:
        """Lower to a Monte-Carlo ``Scenario`` for a cluster of ``n``, its
        offsets on ``device`` (``None`` = the CUDA card)."""
        offs = self.delta_ms * torch.arange(
            self.k_proposers, dtype=torch.float32,
            device=device_mod.resolve(device))
        scen = Scenario(self.name, n, self.k_proposers, offs,
                        self.delay_for(n), self.conflict_frac)
        scen = scen.with_spec(recovery=self.recovery)
        regimes = self.regimes_for(n)
        if regimes is not None:
            scen = scen.with_spec(regimes=regimes)
        return scen.with_faults(faults)

    def des_latency(self) -> LatencyModel:
        """The delay model of the discrete-event backend, which speaks the
        shifted-lognormal EC2 fit, optionally lossy."""
        d = self.delay if self.delay is not None else ShiftedLognormalDelay()
        if isinstance(d, dict):
            d = delay_from_config(d)
        if self.inter_region_ms is not None or not isinstance(
                d, ShiftedLognormalDelay):
            raise ValueError(
                f"the des backend models the single-region network "
                f"(ShiftedLognormalDelay); workload {self.name!r} uses "
                f"{type(d).__name__ if self.delay is not None else 'WAN'} -- "
                f"run it on the montecarlo backend")
        return LatencyModel(base_ms=d.base_ms, mu=d.mu, sigma=d.sigma,
                            loss_prob=self.loss_prob)


# ---------------------------------------------------------------------------
# Results: one normalized shape for all three backends.
# ---------------------------------------------------------------------------

@dataclass
class Results:
    """Structured outcome of one ``Experiment.run``.

    ``summary``          metric name -> length-M vector: (M,) tensors on
                         the run's device for the montecarlo backend,
                         lists for des (latency percentiles over decided
                         instances, fast / recovery / undecided rates) and
                         modelcheck (``safe`` / ``states``).
    ``raw``              materializing montecarlo only: the (M, S) decide
                         bits and latencies (None when streamed).
    ``stream``           streamed montecarlo only: the mergeable
                         ``StreamSummary`` (``RegimeStreamSummary`` under
                         regimes).
    ``fault_tolerance``  per-system crash budgets per phase (brute force
                         over the masks; None above n=14).
    ``safety``           modelcheck only: per-system verdict dicts."""

    backend: str
    labels: Tuple[str, ...]
    summary: Dict[str, Any]
    raw: Optional[Dict[str, torch.Tensor]] = None
    fault_tolerance: Optional[Tuple[Dict[str, int], ...]] = None
    safety: Optional[Tuple[Dict[str, Any], ...]] = None
    stream: Optional[object] = None

    def system(self, which) -> Dict[str, float]:
        """Per-system scalar view, by label or index."""
        i = which if isinstance(which, int) else self.labels.index(which)
        out = {k: _scalar(v[i]) for k, v in self.summary.items()}
        if self.fault_tolerance is not None:
            out.update({f"ft_{k}": v for k, v in
                        self.fault_tolerance[i].items()})
        if self.safety is not None:
            out.update({f"safety_{k}": v for k, v in
                        self.safety[i].items() if k != "trace"})
        return out

    def to_dict(self) -> Dict[str, float]:
        """Flatten to ``{label.metric: float}``."""
        flat: Dict[str, float] = {}
        for i, label in enumerate(self.labels):
            for k, v in self.summary.items():
                flat[f"{label}.{k}"] = _scalar(v[i])
            if self.fault_tolerance is not None:
                ft = self.fault_tolerance[i]
                flat[f"{label}.ft_fast"] = ft["phase2_fast"]
                flat[f"{label}.ft_classic"] = ft["phase2_classic"]
                flat[f"{label}.ft_phase1"] = ft["phase1"]
            if self.safety is not None:
                flat[f"{label}.safe"] = float(self.safety[i]["ok"])
        return flat


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


# ---------------------------------------------------------------------------
# Experiment.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Experiment:
    """A declarative evaluation: systems x workload x faults -> Results.

    ``systems`` mixes ``QuorumSpec`` / ``ExplicitQuorumSystem`` /
    ``WeightedQuorumSystem`` / raw ``QuorumMasks``, all on one cluster
    size.  ``faults`` crashes the named acceptors on the montecarlo and des
    backends; the modelcheck backend ignores it (losing messages only
    removes behaviours).  ``trials`` switches the montecarlo backend to the
    streams (a ``StreamSummary`` of ``precision`` relative quantile error,
    chunks of ``chunk`` trials, ``Results.raw`` None); otherwise it
    materializes ``samples`` instances.  ``shard`` splits the streamed
    trials over the trial mesh: ``True`` uses every domain of the global
    mesh (every process's, once ``repro_torch.parallel.distributed.
    initialize()`` has joined a grid; unsharded with a warning when there
    is one), or pass an explicit ``parallel.sharding.TrialMesh`` to pin
    the layout (honored even with one domain).  ``device`` is where the
    montecarlo backend runs (``None`` = the CUDA card)."""

    systems: Tuple
    workload: Workload = field(default_factory=Workload)
    faults: Tuple[int, ...] = ()
    backend: str = "montecarlo"
    samples: int = 20_000
    seed: int = 0
    max_states: int = 200_000      # modelcheck BFS cap
    compute_fault_tolerance: bool = True   # brute-force crash budgets
    trials: Optional[int] = None   # streaming trial count (montecarlo)
    precision: float = streaming.DEFAULT_PRECISION
    chunk: int = streaming.DEFAULT_CHUNK
    shard: object = True
    # "auto": sort-free streamed lowerings at the table's saturation
    # depths; None: the full-sort reference path; an int / 3-tuple pins the
    # depths.  Integer outputs are identical either way.
    k_max: object = "auto"
    device: object = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "systems", tuple(self.systems))
        object.__setattr__(self, "faults", tuple(self.faults))
        if not self.systems:
            raise ValueError("Experiment needs at least one quorum system")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"pick one of {BACKENDS}")
        if self.trials is not None and self.trials < 1:
            raise ValueError(f"trials must be >= 1, got {self.trials}")

    # -- lowering ----------------------------------------------------------
    def masks(self) -> Tuple[QuorumMasks, ...]:
        cached = self.__dict__.get("_masks")
        if cached is None:
            cached = tuple(s if isinstance(s, QuorumMasks) else s.to_masks()
                           for s in self.systems)
            object.__setattr__(self, "_masks", cached)
        return cached

    @property
    def n(self) -> int:
        ns = {m.n for m in self.masks()}
        if len(ns) != 1:
            raise ValueError(f"systems mix cluster sizes {sorted(ns)}; "
                             f"use QuorumMasks.embed() to align them")
        return ns.pop()

    @property
    def labels(self) -> Tuple[str, ...]:
        labels, seen = [], {}
        for i, m in enumerate(self.masks()):
            lab = m.label or f"system{i}"
            if lab in seen:                      # keep to_dict keys unique
                seen[lab] += 1
                lab = f"{lab}#{seen[lab]}"
            else:
                seen[lab] = 0
            labels.append(lab)
        return tuple(labels)

    def lower(self, *, specialize: bool = True) -> Dict[str, torch.Tensor]:
        """The batched mask table on the experiment's device (all-
        cardinality batches carry the ``"q"`` specialization); memoized per
        ``specialize``."""
        cache = self.__dict__.setdefault("_lowered", {})
        if specialize not in cache:
            cache[specialize] = engine.build_mask_table(
                self.masks(), specialize=specialize, device=self.device)
        return cache[specialize]

    # -- declarative config ------------------------------------------------
    @classmethod
    def from_config(cls, path_or_dict, device=None) -> "Experiment":
        """Build from a JSON file path or a parsed dict (the
        ``examples/scenarios/*.json`` schema): ``systems`` entries through
        ``system_from_config``, ``workload`` through ``Workload.from_dict``,
        every other key an ``Experiment`` field (``device``, when given,
        overrides the config's).  ``shard`` means what it means in the
        JAX package; ``use_kernel``, the JAX package's kernel switch, is
        taken and selects nothing (the device picks every kernel)."""
        cfg = path_or_dict
        if isinstance(cfg, (str, Path)):
            with open(cfg) as f:
                cfg = json.load(f)
        cfg = dict(cfg)
        cfg.pop("use_kernel", None)       # the device picks every kernel
        systems = [system_from_config(s) for s in cfg.pop("systems")]
        wl = cfg.pop("workload", None)
        workload = (Workload.from_dict(wl) if isinstance(wl, dict)
                    else wl if wl is not None else Workload())
        cfg["faults"] = tuple(cfg.get("faults", ()))
        if device is not None:
            cfg["device"] = device
        return cls(systems=systems, workload=workload, **cfg)

    # -- execution ---------------------------------------------------------
    def run(self, backend: Optional[str] = None) -> Results:
        """Evaluate on ``backend`` (default: the declared one)."""
        backend = backend or self.backend
        if backend == "montecarlo":
            return self._run_montecarlo()
        if backend == "des":
            return self._run_des()
        if backend == "modelcheck":
            return self._run_modelcheck()
        raise ValueError(f"unknown backend {backend!r}; "
                         f"pick one of {BACKENDS}")

    def frontier(self, axes=None, trials: Optional[int] = None):
        """Streamed quorum-space Pareto frontier over this experiment's
        systems (``repro_torch.frontier``), the race geometry from the
        workload when it races (else a 2-way race at 0.2 ms), the
        experiment's faults crashed for the whole run."""
        return frontier(self.systems, self.workload, n=self.n,
                        faults=self.faults,
                        trials=trials if trials is not None else self.trials,
                        chunk=self.chunk, precision=self.precision,
                        shard=self.shard, seed=self.seed, k_max=self.k_max,
                        axes=axes, device=self.device)

    def plan(self, family: str = "cardinality", *,
             faults: Optional[Dict[str, int]] = None,
             trials: Optional[int] = None,
             objective: str = "race_p999_ms", planner=None, **query_kw):
        """Search ``family`` for the best system under this experiment's
        workload and engine knobs (``repro_torch.planner``), on its
        ``device``.

        ``faults`` is the minimum crash-budget triple the recommendation
        must satisfy (``{"fast": 1, "phase1": 2, "classic": 2}``; missing
        keys 0) -- distinct from the experiment's ``faults`` tuple, whose
        named acceptors are crashed for the whole scoring run, as on the
        montecarlo backend.  ``trials`` is the final successive-halving
        budget (default: the experiment's streaming trial count, or 10^6).
        Queries go to the device's default planner (or an explicit
        ``planner``), so a repeat same-geometry plan reuses its cached
        search.  Returns a ``repro_torch.planner.PlanResult``."""
        wl = self.workload
        if self.faults:
            wl = dataclasses.replace(
                wl, delay=CrashedDelay(wl.delay_for(self.n),
                                       crash_mask(self.n, self.faults)),
                loss_prob=0.0)
        query = dict(n=self.n, family=family, workload=wl,
                     faults=faults or {},
                     trials=(trials if trials is not None
                             else self.trials or 1_000_000),
                     objective=objective, chunk=self.chunk,
                     precision=self.precision, seed=self.seed,
                     shard=self.shard, k_max=self.k_max, **query_kw)
        return plan(query, planner=planner, device=self.device)

    def _fault_tolerance(self) -> Optional[Tuple[Dict[str, int], ...]]:
        if not self.compute_fault_tolerance or self.n > _FT_MAX_N:
            return None
        cached = self.__dict__.get("_ft")
        if cached is None:
            cached = tuple(m.fault_tolerance() for m in self.masks())
            object.__setattr__(self, "_ft", cached)
        return cached

    def _run_montecarlo(self) -> Results:
        table = self.lower()
        scen = self.workload.scenario(self.n, self.faults,
                                      device=engine._table_device(table))
        key = rng.root(self.seed)
        if self.trials is not None:
            state = scen.with_spec(
                trials=self.trials, chunk=self.chunk,
                precision=self.precision, shard=self.shard,
                k_max=self.k_max).stream(key, table)
            return Results(backend="montecarlo", labels=self.labels,
                           summary=state.summary(), stream=state,
                           fault_tolerance=self._fault_tolerance())
        out = scen.with_spec(samples=self.samples).run(key, table)
        return Results(backend="montecarlo", labels=self.labels,
                       summary=engine.summarize(out), raw=out,
                       fault_tolerance=self._fault_tolerance())

    # -- discrete-event backend --------------------------------------------
    def _set_level(self, system, backend: str):
        """Lower one system for the set-level backends (DES, checker)."""
        if isinstance(system, QuorumMasks):
            raise ValueError(
                f"raw QuorumMasks ({system.label or 'unlabelled'}) only "
                f"lower to the montecarlo engine; pass the originating "
                f"QuorumSpec/ExplicitQuorumSystem/WeightedQuorumSystem "
                f"for the {backend} backend")
        return system

    def _run_des(self) -> Results:
        lat = self.workload.des_latency()
        per_sys = [self._des_one(self._set_level(s, "des"), lat)
                   for s in self.systems]
        summary = {k: [d[k] for d in per_sys] for k in per_sys[0]}
        return Results(backend="des", labels=self.labels, summary=summary,
                       fault_tolerance=self._fault_tolerance())

    def _des_one(self, system, lat: LatencyModel) -> Dict[str, float]:
        wl = self.workload
        sim = FastPaxosSim(system, latency=lat, seed=self.seed,
                           crashed=self.faults, recovery=wl.recovery)
        rnd = random.Random(self.seed + 1)
        k = wl.k_proposers
        t = 0.0
        for i in range(wl.des_requests):
            kk = k if (k > 1 and rnd.random() < wl.conflict_frac) else 1
            for p in range(kk):
                sim.submit(t + p * wl.delta_ms, instance=i,
                           value=f"v{i}_{p}", proposer=p)
            t += _DES_GAP_MS           # isolate instances (independent races)
        sim.run()

        by_inst: Dict[int, list] = {}
        for r in sim.results.values():
            by_inst.setdefault(r.instance, []).append(r)
        lats, fast, rec = [], 0, 0
        for rs in by_inst.values():
            win = next((r for r in rs
                        if r.outcome in ("fast", "recovered")), None)
            if win is None:
                continue
            lats.append(win.latency_ms)
            fast += win.outcome == "fast"
            rec += win.outcome == "recovered"
        m = len(by_inst)
        lats.sort()
        q = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))] \
            if lats else float("nan")
        return {
            "mean_ms": sum(lats) / len(lats) if lats else float("nan"),
            "p50_ms": q(0.50), "p95_ms": q(0.95), "p99_ms": q(0.99),
            "p999_ms": q(0.999), "p9999_ms": q(0.9999),
            "max_ms": lats[-1] if lats else float("nan"),
            "fast_rate": fast / m, "recovery_rate": rec / m,
            "undecided_rate": (m - fast - rec) / m,
        }

    # -- model-check backend -----------------------------------------------
    def _run_modelcheck(self) -> Results:
        if self.n > 5:
            raise ValueError(
                f"the modelcheck backend explores the full state space and "
                f"is capped at n<=5 acceptors (got n={self.n}); check a "
                f"small congruent system and sweep the big one on the "
                f"montecarlo backend")
        verdicts = []
        for s in self.systems:
            r = explore(self._set_level(s, "modelcheck"),
                        max_states=self.max_states)
            verdicts.append({"ok": r.ok, "states": r.states,
                             "violation": r.violation,
                             "truncated": r.truncated, "trace": r.trace})
        summary = {"safe": [float(v["ok"]) for v in verdicts],
                   "states": [float(v["states"]) for v in verdicts]}
        return Results(backend="modelcheck", labels=self.labels,
                       summary=summary,
                       fault_tolerance=self._fault_tolerance(),
                       safety=tuple(verdicts))


def system_from_config(cfg):
    """One quorum system from declarative data:

      {"kind": "cardinality", "n": 11, "q1": 9, "q2c": 3, "q2f": 7}
      {"kind": "cardinality", "preset": "paper_headline", "n": 11}
      {"kind": "relaxed", "n": 11, "q1": 5, "q2c": 2, "q2f": 9}
      {"kind": "grid", "cols": 3, "rows": 3, "n": 11}      # n: embed target
      {"kind": "weighted", "weights": [...], "t1": ..., "t2c": ..., "t2f": ...}
    """
    cfg = dict(cfg)
    kind = cfg.pop("kind", "cardinality")
    if kind == "relaxed":
        return RelaxedQuorumSpec(**cfg).validate()
    if kind == "cardinality":
        preset = cfg.pop("preset", None)
        if preset is not None:
            ctor = getattr(QuorumSpec, preset, None)
            if ctor is None:
                raise ValueError(f"unknown QuorumSpec preset {preset!r}")
            return ctor(**cfg).validate()
        return QuorumSpec(**cfg).validate()
    if kind == "grid":
        n = cfg.pop("n", None)
        sys_ = ExplicitQuorumSystem.grid(int(cfg.pop("cols", 3)),
                                         int(cfg.pop("rows", 3))).validate()
        return sys_ if n is None or n == sys_.n else sys_.embed(int(n))
    if kind == "weighted":
        return WeightedQuorumSystem(
            tuple(int(w) for w in cfg["weights"]), int(cfg["t1"]),
            int(cfg["t2c"]), int(cfg["t2f"])).validate()
    raise ValueError(f"unknown system kind {kind!r}; pick one of "
                     f"('cardinality', 'relaxed', 'grid', 'weighted')")


def sweep(experiment: Experiment, backends: Sequence[str] = BACKENDS
          ) -> Dict[str, Results]:
    """Run one experiment across several backends: {backend: Results}."""
    return {b: experiment.run(b) for b in backends}


def frontier(systems: Sequence, workload: Optional[Workload] = None, *,
             n: Optional[int] = None, faults: Sequence[int] = (),
             trials: Optional[int] = None,
             chunk: Optional[int] = None, precision: Optional[float] = None,
             shard=True, seed: int = 0, k_max="auto", axes=None,
             device=None):
    """One-call quorum-space Pareto frontier (``repro_torch.frontier``) on
    ``device`` (``None`` = the CUDA card).

    ``systems`` mixes ``frontier.families.Member``, quorum systems and raw
    ``QuorumMasks``; smaller systems embed into the largest n present (or
    ``n``).  ``workload`` supplies the race geometry and delay model when
    it races; otherwise a 2-way race at 0.2 ms.  ``faults`` crashes the
    named acceptors for the whole run (the crash budgets on the ft axes
    still describe the intact systems).  ``shard`` as in
    ``score_systems``.  Returns a ``FrontierResult``."""
    from repro_torch.frontier import score as fscore

    systems = list(systems)          # may be a generator: consume once
    wl = workload if workload is not None else Workload.race(
        k=2, delta_ms=fscore.DEFAULT_DELTA_MS)
    if n is None:
        n = fscore._as_masks(systems, None)[2]
    delay = wl.delay_for(n)
    if len(tuple(faults)):
        delay = CrashedDelay(delay, crash_mask(n, faults))
    racing = wl.k_proposers >= 2
    return fscore.score_systems(
        systems, n=n,
        trials=trials if trials is not None else fscore.DEFAULT_TRIALS,
        k_proposers=wl.k_proposers if racing else 2,
        delta_ms=wl.delta_ms if racing else fscore.DEFAULT_DELTA_MS,
        delay=delay,
        chunk=chunk if chunk is not None else fscore.DEFAULT_CHUNK,
        precision=(precision if precision is not None
                   else streaming.DEFAULT_PRECISION),
        shard=shard, seed=seed, k_max=k_max, axes=axes,
        regimes=wl.regimes_for(n), recovery=wl.recovery, device=device)


# Process-wide planners behind ``plan()``, one per device: one engine pool
# and search LRU shared by every in-process query on that device, so the
# second same-geometry call searches nothing (the planner service holds its
# own instance).
_PLANNERS: Dict[torch.device, Any] = {}
_PLANNERS_LOCK = threading.Lock()


def default_planner(device=None):
    """The lazily-created process-wide ``repro_torch.planner.Planner`` of
    ``device`` (``None`` = the CUDA card)."""
    dev = device_mod.resolve(device)
    with _PLANNERS_LOCK:
        if dev not in _PLANNERS:
            from repro_torch.planner import Planner
            _PLANNERS[dev] = Planner(device=dev)
        return _PLANNERS[dev]


def plan(query=None, *, planner=None, device=None, **query_kw):
    """One-call quorum planning (``repro_torch.planner``).

    Successive-halving search over a family, answered by ``planner`` or
    the process-wide planner of ``device`` (``None`` = the CUDA card):
    pass a ``repro_torch.planner.PlanQuery``, a dict, or its fields as
    keywords --

        plan(n=11, family="cardinality",
             workload=Workload.race(k=2, delta_ms=0.2),
             faults={"fast": 1, "classic": 2}, trials=1_000_000)

    ``faults`` is the minimum crash-budget triple the recommendation must
    satisfy; ``objective`` ranks the budget-satisfying frontier members
    (``race_p999_ms`` default).  Returns a ``PlanResult`` (recommended
    system, predicted p50/p99.9/p99.99, fault-tolerance triple, search
    telemetry).  Repeat same-geometry calls hit the search cache and build
    no launch plan."""
    if planner is None:
        planner = default_planner(device)
    elif device is not None and device_mod.resolve(device) != planner.device:
        raise ValueError(f"the planner runs on {planner.device}, the query "
                         f"asks for {device_mod.resolve(device)}")
    return planner.plan(query, **query_kw)
