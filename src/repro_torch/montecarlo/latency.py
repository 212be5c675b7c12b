"""Network-delay models for the Monte-Carlo engine (``repro.montecarlo.latency``).

A model answers one question, ``sample_hops(gen, shape, kind)``: a float32
tensor of one-way delays in ms, drawn from the ``torch.Generator`` ``gen`` on
``gen.device``.  ``kind`` names the hop so placement-aware models can vary the
distribution per endpoint pair; the models here ignore it except
``CrashedDelay``.  The hop kinds the engine asks for:

  ``proposal``         proposer k -> acceptor a, shape (S, n, K)
  ``to_learner``       acceptor a -> learner,    shape (S, n)
  ``from_coordinator`` coordinator -> acceptor,  shape (S, n)
  ``to_coordinator``   acceptor -> coordinator,  shape (S, n)
  ``client_to_leader`` client -> leader relay,   shape (S,)

A delay >= ``LOST_MS`` means the message never arrives.  The models take the
same scalar parameters as the JAX package's; their draws come from Philox,
not threefry, so the two agree in distribution, not bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
    ``crashed`` is an (n,) bool tensor on the sampling device."""

    inner: object
    crashed: torch.Tensor

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        d = self.inner.sample_hops(gen, shape, kind)
        crashed = self.crashed.to(device=d.device, dtype=torch.bool)
        if kind == PROPOSAL:                               # (S, n, K)
            mask = crashed[None, :, None]
        elif kind in (TO_LEARNER, FROM_COORDINATOR, TO_COORDINATOR):
            mask = crashed[None, :]                        # (S, n)
        else:                                              # client -> leader
            return d
        return torch.where(mask, torch.full_like(d, LOST_MS), d)


def default_delay() -> ShiftedLognormalDelay:
    """The paper-section-6 EC2 fit shared with the discrete-event simulator."""
    return ShiftedLognormalDelay()
