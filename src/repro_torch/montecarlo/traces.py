"""Trace-driven delays: replay a measured latency trace as a quantile table
(``repro.montecarlo.traces``).

``EmpiricalDelay.from_trace`` compresses a trace of any length into a
fixed-size quantile grid on the host, in numpy as the JAX package does, so
the two grids are equal: ``probs`` a uniform CDF grid in [0, 1],
``values_ms[i]`` the trace's ``probs[i]``-quantile.  ``sample_hops`` is an
inverse CDF: a uniform u, its bracket ``probs[j-1] <= u < probs[j]`` by
``torch.searchsorted(right=True)`` clipped to [1, Q-1], and linear
interpolation between the bracketing values in f32.

Loss belongs in the ``LossyDelay`` wrapper, not in the trace: interpolating
across a finite / sentinel bracket would make up delays that never
occurred, so ``from_trace`` rejects non-finite samples.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .latency import PROPOSAL, _shape, register_delay_model

# Default grid: 256 points resolve probability to ~0.4%, below the stream
# sketch's default 1% relative error.
DEFAULT_GRID = 256


@dataclass(frozen=True, eq=False)
class EmpiricalDelay:
    """Inverse-CDF replay of a measured one-way latency trace.

    ``probs``      (Q,) f32, strictly increasing, probs[0] = 0 and
                   probs[-1] = 1 (uniform when built by ``from_trace``)
    ``values_ms``  (Q,) f32, non-decreasing quantiles of the trace

    Hop ``kind`` is ignored: the trace is one marginal distribution."""

    probs: torch.Tensor
    values_ms: torch.Tensor

    def _inverse(self, u: torch.Tensor) -> torch.Tensor:
        q = self.probs.shape[0]
        j = torch.searchsorted(self.probs, u, right=True).clamp(1, q - 1)
        p_lo, p_hi = self.probs[j - 1], self.probs[j]
        v_lo, v_hi = self.values_ms[j - 1], self.values_ms[j]
        w = (u - p_lo) / torch.clamp(p_hi - p_lo, min=1e-12)
        return v_lo + w * (v_hi - v_lo)

    def sample_hops(self, gen: torch.Generator, shape,
                    kind: str = PROPOSAL) -> torch.Tensor:
        u = torch.rand(_shape(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)
        return self._inverse(u)

    @classmethod
    def from_trace(cls, trace_ms: Sequence[float],
                   n_quantiles: int = DEFAULT_GRID) -> "EmpiricalDelay":
        """Compress a measured trace (any length >= 1) into a fixed-size
        quantile grid.  A single-sample trace gives a constant delay;
        non-finite samples are rejected."""
        t = np.asarray(trace_ms, np.float64).ravel()
        if t.size < 1:
            raise ValueError("trace must contain at least one sample")
        if not np.all(np.isfinite(t)):
            raise ValueError(
                "trace contains non-finite samples; drop them and model "
                "loss with LossyDelay instead of sentinel delays")
        if np.any(t < 0):
            raise ValueError("trace contains negative delays")
        if n_quantiles < 2:
            raise ValueError(f"n_quantiles must be >= 2, got {n_quantiles}")
        probs = np.linspace(0.0, 1.0, n_quantiles)
        values = np.quantile(t, probs)
        return cls(probs=torch.from_numpy(probs.astype(np.float32)),
                   values_ms=torch.from_numpy(values.astype(np.float32))
                   ).validate()

    def validate(self) -> "EmpiricalDelay":
        """Host-side checks: matching 1-D grids of >= 2 points, probs
        strictly increasing within [0, 1], values finite and
        non-decreasing."""
        p = self.probs.detach().cpu().double().numpy()
        v = self.values_ms.detach().cpu().double().numpy()
        if p.ndim != 1 or p.shape != v.shape or p.size < 2:
            raise ValueError(
                f"probs/values_ms must be matching 1-D grids of >= 2 "
                f"points, got {p.shape} / {v.shape}")
        if not (np.all(np.diff(p) > 0) and p[0] >= 0.0 and p[-1] <= 1.0):
            raise ValueError("probs must be strictly increasing within "
                             "[0, 1]")
        if np.any(np.diff(v) < 0):
            raise ValueError("values_ms must be non-decreasing (a quantile "
                             "function cannot invert)")
        if not np.all(np.isfinite(v)):
            raise ValueError("values_ms must be finite; model loss with "
                             "LossyDelay")
        return self

    def quantile(self, q) -> torch.Tensor:
        """The model's own quantile function (linear interpolation over
        the grid): what sampled quantiles converge to."""
        return self._inverse(torch.as_tensor(q, dtype=torch.float32).to(
            self.probs.device))


def _empirical_to_config(model: EmpiricalDelay) -> dict:
    return {"probs": model.probs.detach().cpu().double().tolist(),
            "values_ms": model.values_ms.detach().cpu().double().tolist()}


def _empirical_from_config(cfg: dict, n=None) -> EmpiricalDelay:
    cfg = dict(cfg)
    if "trace_ms" in cfg:           # raw-trace form: fit at load time
        return EmpiricalDelay.from_trace(
            cfg["trace_ms"], n_quantiles=int(cfg.get("n_quantiles",
                                                     DEFAULT_GRID)))
    return EmpiricalDelay(
        probs=torch.tensor(cfg["probs"], dtype=torch.float32),
        values_ms=torch.tensor(cfg["values_ms"], dtype=torch.float32)
    ).validate()


register_delay_model("empirical", EmpiricalDelay,
                     _empirical_to_config, _empirical_from_config)
