"""Markov-modulated failure regimes over the streamed trial axis
(``repro.montecarlo.regimes``).

  regimes   ``MarkovRegimes``: R named regimes, each a full delay + fault
            environment (any registered delay model, ``CrashedDelay`` /
            ``LossyDelay`` wrappers included), an (R, R) transition matrix
            and an epoch length in trials.
  chain     trial t runs in regime ``z[t // epoch_trials]``; z is a Markov
            chain stepped once an epoch on the host, epoch e's uniform
            taken from ``rng.derive(key, REGIME_FOLD_DOMAIN, e)``.  The
            epoch map lives in trial-index space, so occupancy does not
            depend on the chunk size, and ``sequence`` is a prefix: z[e]
            does not depend on the number of epochs asked for.
  chunk     each chunk samples every hop under all R environments from the
            chunk's one generator, in order, and keeps each trial's own
            (``_RegimeMixedDelay``); its outcomes are reduced into R
            per-regime ``StreamSummary`` slices (``RegimeStreamSummary``).
  merge     counts and histograms are integers, so the slices merge back
            to the marginal summary exactly (``total``).

With R == 1 the mixed delay passes the call straight through: a
single-regime stream draws exactly what the i.i.d. stream draws, and its
decide counts, histograms and maxima are the same bits.

Configs are the JAX package's JSON::

    {"epoch_trials": 8192,
     "regimes": [
       {"name": "baseline"},                           # inherit base delay
       {"name": "degraded",
        "delay": {"kind": "pareto", "scale_ms": 0.8},
        "loss_prob": 0.02},
       {"name": "partitioned", "crashed": [0, 1, 2]}],
     "transition": [[0.98, 0.01, 0.01],
                    [0.10, 0.88, 0.02],
                    [0.20, 0.00, 0.80]]}
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, fields, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rng
from .latency import (CrashedDelay, LossyDelay, ParetoDelay, PROPOSAL,
                      crash_mask, delay_from_config, delay_to_config)

REGIME_FOLD_DOMAIN = rng.REGIME_FOLD_DOMAIN

# Regimes persist for thousands of trials (the correlated-failure point),
# while 10^6-trial runs still see hundreds of transitions.
DEFAULT_EPOCH_TRIALS = 8192

_ROW_SUM_TOL = 1e-6


def _crashed_ids(mask: torch.Tensor) -> list:
    return [int(i) for i in torch.nonzero(mask.detach().cpu()).flatten()]


@dataclass(frozen=True, eq=False)
class MarkovRegimes:
    """R named regime environments and an (R, R) Markov transition matrix.

    ``delays[r]`` is regime r's delay model; ``None`` (and the deferred
    loss / crash wrappers) inherit the stream's base delay at ``bound``
    time.  ``transition[i, j]`` = P(next = j | current = i), an f32 tensor
    on the host.  The chain starts in ``start`` and steps every
    ``epoch_trials`` trials."""

    names: Tuple[str, ...]
    delays: Tuple[object, ...]
    transition: torch.Tensor
    epoch_trials: int = DEFAULT_EPOCH_TRIALS
    start: int = 0

    @property
    def n_regimes(self) -> int:
        return len(self.names)

    def validate(self) -> "MarkovRegimes":
        """Square (R, R) matrix matching the regime count, finite
        non-negative entries, rows summing to 1, a valid start, a positive
        epoch."""
        r = self.n_regimes
        if r < 1:
            raise ValueError("MarkovRegimes needs at least one regime")
        if len(self.delays) != r:
            raise ValueError(f"{r} regime names but {len(self.delays)} "
                             f"delay environments")
        if len(set(self.names)) != r:
            raise ValueError(f"regime names must be unique, "
                             f"got {self.names}")
        t = self.transition.detach().cpu().double().numpy()
        if t.shape != (r, r):
            raise ValueError(f"transition matrix must be ({r}, {r}) for "
                             f"{r} regimes, got {t.shape}")
        if np.any(t < 0) or not np.all(np.isfinite(t)):
            raise ValueError("transition probabilities must be finite and "
                             ">= 0")
        rows = t.sum(axis=1)
        bad = np.nonzero(np.abs(rows - 1.0) > _ROW_SUM_TOL)[0]
        if bad.size:
            raise ValueError(
                f"transition rows must sum to 1: row(s) "
                f"{[self.names[i] for i in bad]} sum to "
                f"{rows[bad].tolist()}")
        if not 0 <= self.start < r:
            raise ValueError(f"start regime {self.start} out of range "
                             f"[0, {r})")
        if self.epoch_trials < 1:
            raise ValueError(f"epoch_trials must be >= 1, "
                             f"got {self.epoch_trials}")
        return self

    def bound(self, base_delay) -> "MarkovRegimes":
        """Substitute the stream's base delay into inheriting slots:
        ``None`` becomes the base model, deferred loss / crash wrappers
        wrap it."""
        def _bind(d):
            if d is None:
                return base_delay
            if isinstance(d, (_DeferredCrash, _DeferredLoss)):
                return d.bind(base_delay)
            return d

        return replace(self, delays=tuple(_bind(d) for d in self.delays))

    # -- the chain ---------------------------------------------------------
    def chain(self, uniforms: np.ndarray) -> np.ndarray:
        """(E,) int32 regime ids from E uniforms: z[0] = start and
        z[e+1] = the first j whose f32 cumulative transition-row entry
        exceeds u[e] (``searchsorted(side="right")``), clipped to R - 1."""
        cum = np.cumsum(self.transition.detach().cpu().numpy().astype(
            np.float32), axis=1, dtype=np.float32)
        u = np.asarray(uniforms, np.float32)
        zs = np.empty((u.shape[0],), np.int32)
        z, last = int(self.start), self.n_regimes - 1
        for e in range(u.shape[0]):
            zs[e] = z
            z = min(int(np.searchsorted(cum[z], u[e], side="right")), last)
        return zs

    def sequence(self, key: int, n_epochs: int) -> torch.Tensor:
        """(n_epochs,) int32 regime ids on the host for a stream keyed
        ``key``; epoch e steps with ``rng.uniform(rng.derive(key,
        REGIME_FOLD_DOMAIN, e))``, so a longer sequence only appends."""
        u = [rng.uniform(rng.derive(key, REGIME_FOLD_DOMAIN, e))
             for e in range(n_epochs)]
        return torch.from_numpy(self.chain(np.asarray(u, np.float32)))

    def mixed_delay(self, rid: torch.Tensor) -> "_RegimeMixedDelay":
        """The per-trial environment selector of one chunk: ``rid`` the
        (chunk,) regime id of each trial."""
        return _RegimeMixedDelay(models=self.delays, rid=rid)

    # -- declarative config ------------------------------------------------
    @classmethod
    def from_config(cls, cfg: Dict, n: Optional[int] = None
                    ) -> "MarkovRegimes":
        """Build from the JSON shape (module docstring).  ``n`` resolves
        per-regime ``crashed`` lists and symmetric-WAN shorthands."""
        if isinstance(cfg, cls):
            return cfg.validate()
        entries = cfg["regimes"]
        if not entries:
            raise ValueError("regime config needs at least one regime")
        names, delays = [], []
        for i, e in enumerate(entries):
            names.append(str(e.get("name", f"regime{i}")))
            d = delay_from_config(e.get("delay"), n)
            loss = float(e.get("loss_prob", 0.0))
            crashed = tuple(e.get("crashed", ()))
            mask = None
            if crashed:
                if n is None:
                    raise ValueError(
                        f"regime {names[-1]!r} crashes acceptors "
                        f"{sorted(crashed)} but the cluster size is "
                        f"unknown; resolve the config with n=")
                mask = crash_mask(n, crashed)
            if d is None:
                # loss / crashes on top of the inherited base delay: the
                # wrap waits until the stream binds its model.
                if loss:
                    d = _DeferredLoss(loss, mask)
                elif mask is not None:
                    d = _DeferredCrash(mask)
            else:
                if loss:
                    d = LossyDelay(d, loss)
                if mask is not None:
                    d = CrashedDelay(d, mask)
            delays.append(d)
        return cls(names=tuple(names), delays=tuple(delays),
                   transition=torch.tensor(cfg["transition"],
                                           dtype=torch.float32),
                   epoch_trials=int(cfg.get("epoch_trials",
                                            DEFAULT_EPOCH_TRIALS)),
                   start=int(cfg.get("start", 0))).validate()

    def to_config(self) -> Dict:
        """Invert ``from_config`` (deferred wrappers serialize back to
        their declarative form)."""
        entries = []
        for name, d in zip(self.names, self.delays):
            e: Dict = {"name": name}
            e.update(_env_to_config(d))
            entries.append(e)
        return {"regimes": entries,
                "transition": self.transition.detach().cpu().double()
                .tolist(),
                "epoch_trials": int(self.epoch_trials),
                "start": int(self.start)}


def _env_to_config(d) -> Dict:
    """One regime environment -> its config fields."""
    if d is None:
        return {}
    if isinstance(d, _DeferredCrash):
        return {"crashed": _crashed_ids(d.crashed)}
    if isinstance(d, _DeferredLoss):
        out = {"loss_prob": float(d.loss_prob)}
        if d.crashed is not None:
            out["crashed"] = _crashed_ids(d.crashed)
        return out
    return {"delay": delay_to_config(d)}


@dataclass(frozen=True, eq=False)
class _DeferredCrash:
    """Crash these acceptors on top of the stream's base delay."""

    crashed: torch.Tensor

    def bind(self, base):
        return CrashedDelay(base, self.crashed)


@dataclass(frozen=True, eq=False)
class _DeferredLoss:
    """Loss (and optionally crashes) on top of the stream's base delay."""

    loss_prob: float
    crashed: Optional[torch.Tensor] = None

    def bind(self, base):
        d = LossyDelay(base, self.loss_prob)
        return CrashedDelay(d, self.crashed) if self.crashed is not None \
            else d


@dataclass(frozen=True, eq=False)
class _RegimeMixedDelay:
    """Sample every hop under all R environments and keep each trial's.

    ``rid`` is the (S,) regime id of each sample (S = the leading axis of
    every hop shape).  With R == 1 the call goes straight to the single
    model: the draws are those of the model alone.  With R > 1 each model
    draws from the same generator in turn (so environments are independent
    even when two regimes share a model) and ``torch.where`` keeps each
    trial's regime."""

    models: Tuple[object, ...]
    rid: torch.Tensor

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        if len(self.models) == 1:
            return self.models[0].sample_hops(gen, shape, kind)
        sel = self.rid.reshape((-1,) + (1,) * (len(shape) - 1))
        out = None
        for r, m in enumerate(self.models):
            d = m.sample_hops(gen, shape, kind)
            out = d if out is None else torch.where(sel == r, d, out)
        return out


def _slice(summary, i: int):
    """Entry ``i`` of every tensor field of a stacked summary."""
    return replace(summary, **{
        f.name: getattr(summary, f.name)[i] for f in fields(summary)
        if isinstance(getattr(summary, f.name), torch.Tensor)})


@dataclass(frozen=True)
class RegimeStreamSummary:
    """A streamed run decomposed by regime.

    ``by_regime`` is a ``StreamSummary`` whose fields carry a leading R
    axis: slice r summarizes exactly the trials the chain spent in regime
    r.  ``occupancy`` is the (R,) int32 trial count per regime (it sums to
    the run's trials).  ``total()`` merges the slices into the marginal
    summary; the count and quantile surface of ``StreamSummary`` is
    mirrored here and reads the total."""

    names: Tuple[str, ...]
    occupancy: torch.Tensor
    by_regime: object

    @property
    def n_regimes(self) -> int:
        return len(self.names)

    @property
    def precision(self) -> float:
        return self.by_regime.precision

    def regime(self, which):
        """One regime's slice (by name or index) as a ``StreamSummary``."""
        i = which if isinstance(which, int) else self.names.index(which)
        return _slice(self.by_regime, i)

    def total(self):
        """The marginal summary: the slices merged in regime order."""
        return functools.reduce(
            lambda a, b: a.merge(b),
            [self.regime(i) for i in range(self.n_regimes)])

    def merge(self, other: "RegimeStreamSummary") -> "RegimeStreamSummary":
        """Combine two regime-decomposed runs over the same regime set."""
        if self.names != other.names:
            raise ValueError(f"cannot merge different regime sets "
                             f"{self.names} vs {other.names}")
        return RegimeStreamSummary(
            names=self.names, occupancy=self.occupancy + other.occupancy,
            by_regime=self.by_regime.merge(other.by_regime))

    @property
    def n_trials(self):
        return self.total().n_trials

    @property
    def n_fast(self):
        return self.total().n_fast

    @property
    def n_recovery(self):
        return self.total().n_recovery

    @property
    def n_undecided(self):
        return self.total().n_undecided

    @property
    def n_decided(self):
        return self.total().n_decided

    @property
    def max_ms(self):
        return self.total().max_ms

    @property
    def mean_ms(self):
        return self.total().mean_ms

    @property
    def hist(self):
        return self.total().hist

    def quantile(self, q):
        return self.total().quantile(q)

    def summary(self):
        return self.total().summary()

    def report(self) -> Dict:
        """Host-side per-regime breakdown: occupancy and each regime's
        summary (scalars for one system, lists otherwise)."""
        def _host(v):
            a = v.detach().cpu().numpy()
            return a.item() if a.size == 1 else a.tolist()

        occ = self.occupancy.detach().cpu().numpy().astype(np.int64)
        out = {"names": list(self.names), "occupancy": occ.tolist(),
               "occupancy_frac": (occ / max(int(occ.sum()), 1)).tolist(),
               "per_regime": {}}
        for i, name in enumerate(self.names):
            out["per_regime"][name] = {
                k: _host(v) for k, v in self.regime(i).summary().items()}
        return out


def gray_failure(n: int, *, epoch_trials: int = DEFAULT_EPOCH_TRIALS,
                 degraded_scale_ms: float = 0.8, loss_prob: float = 0.02,
                 partition: Sequence[int] = (0, 1, 2),
                 p_fail: float = 0.01, p_recover: float = 0.15
                 ) -> MarkovRegimes:
    """A 3-regime gray-failure chain: a healthy baseline that inherits the
    stream's delay, a heavy-tailed lossy degradation, and a partition that
    crashes ``partition``."""
    cfg_t = [[1.0 - 2 * p_fail, p_fail, p_fail],
             [p_recover, 1.0 - p_recover - p_fail, p_fail],
             [p_recover, 0.0, 1.0 - p_recover]]
    return MarkovRegimes(
        names=("baseline", "degraded", "partitioned"),
        delays=(None,
                LossyDelay(ParetoDelay(scale_ms=degraded_scale_ms),
                           loss_prob),
                _DeferredCrash(crash_mask(n, partition))),
        transition=torch.tensor(cfg_t, dtype=torch.float32),
        epoch_trials=epoch_trials).validate()
