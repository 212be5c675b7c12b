"""Network-delay models for the Monte-Carlo engine (``repro.montecarlo.latency``).

A model answers one question, ``sample_hops(gen, shape, kind)``: a float32
tensor of one-way delays in ms, drawn from the ``torch.Generator`` ``gen`` on
``gen.device``.  ``kind`` names the hop so placement-aware models
(``WanDelay``, ``CrashedDelay``) can vary the distribution per endpoint
pair; i.i.d. models ignore it.  The hop kinds the engine asks for:

  ``proposal``         proposer k -> acceptor a, shape (S, n, K)
  ``to_learner``       acceptor a -> learner,    shape (S, n)
  ``from_coordinator`` coordinator -> acceptor,  shape (S, n)
  ``to_coordinator``   acceptor -> coordinator,  shape (S, n)
  ``client_to_leader`` client -> leader relay,   shape (S,)

A delay >= ``LOST_MS`` means the message never arrives.  The models take the
same parameters as the JAX package's; their draws come from Philox, not
threefry, so the two agree in distribution, not bit for bit.  A model's
tensors (placements, crash masks, quantile grids) are moved to the sampling
device once per entry-point call by ``to_device``, never per hop.

Every model registers a ``kind`` name with to/from-config codecs, so a whole
delay stack, wrappers included, round-trips through the same JSON as the
JAX package's (``delay_to_config`` / ``delay_from_config``).  The
trace-driven ``empirical`` kind registers itself from ``traces.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing

# Sentinel one-way delay for a dropped message.
LOST_MS = 1e9

PROPOSAL = "proposal"
TO_LEARNER = "to_learner"
FROM_COORDINATOR = "from_coordinator"
TO_COORDINATOR = "to_coordinator"
CLIENT_TO_LEADER = "client_to_leader"


def _shape(shape) -> tuple:
    return tuple(int(s) for s in shape)


@dataclass(frozen=True)
class ShiftedLognormalDelay:
    """one_way = base + LogNormal(mu, sigma) ms -- the EC2 same-region fit
    the discrete-event simulator uses."""

    base_ms: float = 0.25
    mu: float = -1.20
    sigma: float = 0.55

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        z = torch.randn(_shape(shape), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return self.base_ms + torch.exp(self.mu + self.sigma * z)


@dataclass(frozen=True)
class ParetoDelay:
    """Heavy-tailed one-way delay: base + scale * (Pareto(alpha) - 1).

    Pareto(alpha) has support [1, inf), so delays start exactly at
    ``base_ms``; ``alpha > 1`` keeps the mean finite.  Drawn by inverse CDF,
    ``exp(E / alpha)`` of a unit exponential E, as ``jax.random.pareto``
    draws it."""

    base_ms: float = 0.25
    scale_ms: float = 0.12
    alpha: float = 2.2

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        e = torch.empty(_shape(shape), dtype=torch.float32,
                        device=gen.device).exponential_(generator=gen)
        return self.base_ms + self.scale_ms * (torch.exp(e / self.alpha)
                                               - 1.0)


@dataclass(frozen=True, eq=False)
class WanDelay:
    """Multi-region WAN model: ``oneway_ms`` is an (R, R) float32 table of
    one-way propagation delays between regions, and every message also
    pays a lognormal jitter.  Placement: ``acceptor_region`` (n,) and
    ``proposer_region`` (K,) int64 region ids, ``learner_region`` the
    region of the learner / coordinator.  Each hop kind's base table is
    built once per (kind, shape) on the placement's device and kept."""

    oneway_ms: torch.Tensor
    acceptor_region: torch.Tensor
    proposer_region: torch.Tensor
    learner_region: int = 0
    jitter_mu: float = -2.0
    jitter_sigma: float = 0.4
    _bases: Dict = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        object.__setattr__(self, "_bases", {})

    def _base(self, shape, kind: str) -> torch.Tensor:
        """The deterministic part of a hop, broadcastable to ``shape``."""
        key = (kind, int(shape[-1]) if kind == PROPOSAL else 0)
        if key not in self._bases:
            self._bases[key] = self._base_table(key[1], kind)
        return self._bases[key]

    def _base_table(self, k_req: int, kind: str) -> torch.Tensor:
        ow, acc, lr = self.oneway_ms, self.acceptor_region, self.learner_region
        if kind == PROPOSAL:                                 # (1, n, K)
            # a requested K may differ from the placement's (the
            # conflict-free fast path asks for one proposer): proposer k
            # sits where placement entry k mod K does.
            prop = self.proposer_region[
                torch.arange(k_req, device=acc.device)
                % self.proposer_region.shape[0]]
            return ow[prop[None, :], acc[:, None]][None]
        if kind in (TO_LEARNER, TO_COORDINATOR):             # (1, n)
            return ow[acc, lr][None]
        if kind == FROM_COORDINATOR:                         # (1, n)
            return ow[lr, acc][None]
        if kind == CLIENT_TO_LEADER:                         # ()
            return ow[self.proposer_region[0], lr]
        raise ValueError(f"unknown hop kind {kind!r}")

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        base = self._base(_shape(shape), kind)
        z = torch.randn(_shape(shape), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return base + torch.exp(self.jitter_mu + self.jitter_sigma * z)

    @classmethod
    def symmetric(cls, inter_region_ms: float, n: int, k_proposers: int,
                  n_regions: int = 3, **kw) -> "WanDelay":
        """All region pairs ``inter_region_ms`` apart, zero intra-region
        propagation; acceptors round-robin over regions, proposer k in
        region k mod R, learner in region 0."""
        r = n_regions
        return cls(oneway_ms=inter_region_ms * (1.0 - torch.eye(r)),
                   acceptor_region=torch.arange(n) % r,
                   proposer_region=torch.arange(k_proposers) % r,
                   learner_region=0, **kw)


@dataclass(frozen=True)
class LossyDelay:
    """Wrap a delay model with i.i.d. message loss: with probability
    ``loss_prob`` a hop's delay becomes ``LOST_MS``."""

    inner: object
    loss_prob: float = 0.01

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        d = self.inner.sample_hops(gen, shape, kind)
        lost = torch.rand(_shape(shape), generator=gen,
                          device=gen.device) < self.loss_prob
        return torch.where(lost, torch.full_like(d, LOST_MS), d)


@dataclass(frozen=True, eq=False)
class CrashedDelay:
    """Per-acceptor fault injection: every hop touching a crashed acceptor
    is lost, so crashed nodes never vote and their 2bs never arrive.
    ``crashed`` is an (n,) bool tensor (``to_device`` moves it)."""

    inner: object
    crashed: torch.Tensor

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        d = self.inner.sample_hops(gen, shape, kind)
        if kind == PROPOSAL:                               # (S, n, K)
            mask = self.crashed[None, :, None]
        elif kind in (TO_LEARNER, FROM_COORDINATOR, TO_COORDINATOR):
            mask = self.crashed[None, :]                   # (S, n)
        else:                                              # client -> leader
            return d
        return torch.where(mask, torch.full_like(d, LOST_MS), d)


def crash_mask(n: int, crashed) -> torch.Tensor:
    """(n,) bool mask of the acceptor ids ``crashed``, for ``CrashedDelay``."""
    m = torch.zeros((n,), dtype=torch.bool)
    if len(tuple(crashed)):
        m[sorted(set(int(c) for c in crashed))] = True
    return m


def default_delay() -> ShiftedLognormalDelay:
    """The paper-section-6 EC2 fit shared with the discrete-event simulator."""
    return ShiftedLognormalDelay()


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def to_device(model, device):
    """``model`` with every tensor of it and of the models it wraps on
    ``device`` (the same object when they already are).  The engine's and
    the streams' entry points call it once per call; each tensor copied is
    one ``repro_torch.host_write`` span."""
    if model is None or not dataclasses.is_dataclass(model):
        return model
    device = torch.device(device)
    changes = {}
    for f in dataclasses.fields(model):
        if not f.init:
            continue
        v = getattr(model, f.name)
        if isinstance(v, torch.Tensor):
            if _on(v, device):
                w = v
            else:
                with tracing.span(tracing.HOST_WRITE):
                    w = v.to(device)
        elif isinstance(v, tuple):
            w = tuple(to_device(x, device) for x in v)
            w = v if all(a is b for a, b in zip(w, v)) else w
        else:
            w = to_device(v, device)
        if w is not v:
            changes[f.name] = w
    return dataclasses.replace(model, **changes) if changes else model


# ---------------------------------------------------------------------------
# Named registry and declarative serialization: the JAX package's JSON.
#
#     {"kind": "lossy", "loss_prob": 0.02,
#      "inner": {"kind": "empirical", "probs": [...], "values_ms": [...]}}
#
# ``delay_from_config`` optionally takes the cluster size ``n`` for kinds
# whose placement depends on it (the symmetric WAN shorthand).
# ---------------------------------------------------------------------------

_DELAY_REGISTRY: Dict[str, Tuple[type, Callable, Callable]] = {}


def register_delay_model(kind: str, cls: type, to_config: Callable,
                         from_config: Callable) -> None:
    """Register a delay-model kind: ``to_config(model) -> dict`` (without
    the ``kind`` key) and ``from_config(cfg, n=None) -> model``."""
    _DELAY_REGISTRY[kind] = (cls, to_config, from_config)


def delay_kinds() -> Tuple[str, ...]:
    return tuple(sorted(_DELAY_REGISTRY))


def delay_to_config(model) -> Optional[dict]:
    """Serialize any registered delay model (wrappers recurse) to a plain
    JSON-ready dict; ``None`` passes through (= the engine default)."""
    if model is None:
        return None
    for kind, (cls, to_cfg, _) in _DELAY_REGISTRY.items():
        if type(model) is cls:
            return {"kind": kind, **to_cfg(model)}
    raise TypeError(f"unregistered delay model {type(model).__name__}; "
                    f"known kinds: {delay_kinds()}")


def delay_from_config(cfg, n: Optional[int] = None):
    """Inverse of ``delay_to_config``.  Accepts ``None``, an
    already-constructed model (passed through), or a ``{"kind": ...}``
    dict."""
    if cfg is None or not isinstance(cfg, dict):
        return cfg
    kind = cfg.get("kind")
    if kind not in _DELAY_REGISTRY:
        raise ValueError(f"unknown delay kind {kind!r}; "
                         f"known kinds: {delay_kinds()}")
    body = {k: v for k, v in cfg.items() if k != "kind"}
    return _DELAY_REGISTRY[kind][2](body, n)


def _ints(t: torch.Tensor) -> list:
    return [int(v) for v in t.detach().cpu().tolist()]


register_delay_model(
    "lognormal", ShiftedLognormalDelay,
    lambda m: {"base_ms": float(m.base_ms), "mu": float(m.mu),
               "sigma": float(m.sigma)},
    lambda cfg, n=None: ShiftedLognormalDelay(**cfg))

register_delay_model(
    "pareto", ParetoDelay,
    lambda m: {"base_ms": float(m.base_ms), "scale_ms": float(m.scale_ms),
               "alpha": float(m.alpha)},
    lambda cfg, n=None: ParetoDelay(**cfg))


def _wan_to_config(m: WanDelay) -> dict:
    return {"oneway_ms": m.oneway_ms.detach().cpu().double().tolist(),
            "acceptor_region": _ints(m.acceptor_region),
            "proposer_region": _ints(m.proposer_region),
            "learner_region": int(m.learner_region),
            "jitter_mu": float(m.jitter_mu),
            "jitter_sigma": float(m.jitter_sigma)}


def _wan_from_config(cfg: dict, n: Optional[int] = None) -> WanDelay:
    cfg = dict(cfg)
    if "inter_region_ms" in cfg:    # symmetric shorthand: needs cluster size
        if n is None:
            raise ValueError(
                "the symmetric WAN delay config needs the cluster size; "
                "pass n= (Workload/Experiment configs resolve it for you)")
        kw = {k: cfg[k] for k in ("jitter_mu", "jitter_sigma") if k in cfg}
        return WanDelay.symmetric(float(cfg["inter_region_ms"]), n,
                                  int(cfg.get("k_proposers", 2)),
                                  int(cfg.get("n_regions", 3)), **kw)
    return WanDelay(
        oneway_ms=torch.tensor(cfg["oneway_ms"], dtype=torch.float32),
        acceptor_region=torch.tensor(cfg["acceptor_region"],
                                     dtype=torch.int64),
        proposer_region=torch.tensor(cfg["proposer_region"],
                                     dtype=torch.int64),
        learner_region=int(cfg.get("learner_region", 0)),
        jitter_mu=float(cfg.get("jitter_mu", -2.0)),
        jitter_sigma=float(cfg.get("jitter_sigma", 0.4)))


register_delay_model("wan", WanDelay, _wan_to_config, _wan_from_config)

register_delay_model(
    "lossy", LossyDelay,
    lambda m: {"loss_prob": float(m.loss_prob),
               "inner": delay_to_config(m.inner)},
    lambda cfg, n=None: LossyDelay(delay_from_config(cfg["inner"], n),
                                   float(cfg.get("loss_prob", 0.01))))

register_delay_model(
    "crashed", CrashedDelay,
    lambda m: {"crashed": [int(bool(v)) for v in
                           m.crashed.detach().cpu().tolist()],
               "inner": delay_to_config(m.inner)},
    lambda cfg, n=None: CrashedDelay(
        delay_from_config(cfg["inner"], n),
        torch.from_numpy(np.asarray(cfg["crashed"], np.int64) != 0)))
