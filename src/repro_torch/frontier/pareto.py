"""Pure array-level Pareto dominance over mixed min/max axes.

The quorum-space frontier (§5/§6) compares systems on axes that pull in
different directions — latency quantiles shrink with smaller fast quorums
while fault tolerance grows with larger ones — and the streamed scores
carry a *known* uncertainty: sketch quantiles are exact only up to the
DDSketch relative error, Monte-Carlo rates only up to binomial noise.
This module computes the maximal (non-dominated) set under dominance that
respects both:

  orient      every axis is flipped so "larger is better" uniformly
              (``Axis.maximize``); NaN scores (nothing decided) orient to
              -inf, i.e. worst.
  quantize    each axis snaps to an epsilon grid *before* comparison —
              absolute steps of ``eps`` for rates/counts, log-scale steps
              of ratio ``sketch_gamma(eps)`` for sketch-valued latency
              axes (``Axis.relative``), the exact bucket geometry of
              ``montecarlo.streaming``.  Values indistinguishable at the
              measurement's precision land in one cell and compare equal.
  dominate    on the quantized matrix, j dominates i iff j is >= on every
              axis and > on at least one.  Quantized dominance is a strict
              partial order (irreflexive, transitive), which is what makes
              the frontier well-behaved:

    * no frontier point is dominated (by construction);
    * every excluded point is dominated by some *frontier* point (follow
      the dominance chain — finite strict partial orders have maximal
      elements above every element);
    * exact ties (equal quantized vectors) never dominate each other, so
      duplicates and within-epsilon copies are kept or excluded together;
    * membership depends only on the multiset of value vectors, so the
      frontier is invariant under input permutation and duplicated rows.

The kernel is plain numpy over an (M, A) value matrix — O(M^2 A) compares,
blocked so the pairwise tensor never exceeds a few MB.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# Relative (log-grid) quantization floors tiny values here so log() is
# defined; matches the streaming sketch's lower edge.
_REL_MIN = 1e-12


@dataclass(frozen=True)
class Axis:
    """One frontier axis: a name, a direction, and a measurement precision.

    ``maximize``  False (default) = smaller is better (latencies, rates);
                  True = larger is better (fault tolerance).
    ``eps``       quantization step: scores closer than this are ties.
                  0.0 compares raw values exactly.
    ``relative``  interpret ``eps`` as a *relative* error (DDSketch-style
                  log buckets with growth ``(1+eps)/(1-eps)``) instead of
                  an absolute step — the right grid for sketch quantiles,
                  whose guarantee is relative.
    """

    name: str
    maximize: bool = False
    eps: float = 0.0
    relative: bool = False

    def __post_init__(self) -> None:
        if self.eps < 0:
            raise ValueError(f"axis {self.name!r}: eps must be >= 0")
        if self.relative and not self.eps:
            raise ValueError(f"axis {self.name!r}: relative quantization "
                             f"needs eps > 0")


def quantize(values: np.ndarray,
             axes: Sequence[Axis]) -> np.ndarray:
    """(M, A) raw scores -> (M, A) float64 oriented-and-quantized matrix.

    Output columns are "larger is better" on every axis; eps-quantized
    columns hold integral cell indices (as float64), eps=0 columns the raw
    values.  NaN maps to -inf (worst) after orientation, so systems that
    never decided sort below everything without poisoning comparisons.
    """
    v = np.asarray(values, np.float64)
    if v.ndim != 2 or v.shape[1] != len(axes):
        raise ValueError(f"values {v.shape} inconsistent with "
                         f"{len(axes)} axes")
    out = np.empty_like(v)
    with np.errstate(invalid="ignore", divide="ignore"):
        for a, ax in enumerate(axes):
            col = v[:, a]
            if ax.relative:
                # the streaming sketch's bucket geometry: cells grow by
                # gamma = (1+eps)/(1-eps); +0.5 centers cells so exact
                # bucket representatives (bucket_value outputs) sit
                # mid-cell, never on a boundary
                gamma = (1.0 + ax.eps) / (1.0 - ax.eps)
                col = np.floor(np.log(np.maximum(col, _REL_MIN))
                               / math.log(gamma) + 0.5)
            elif ax.eps:
                col = np.floor(col / ax.eps + 0.5)
            oriented = col if ax.maximize else -col
            out[:, a] = np.where(np.isnan(v[:, a]), -np.inf, oriented)
    return out


def dominates(oriented: np.ndarray, j: int, i: int) -> bool:
    """Does row j dominate row i in an oriented/quantized matrix?"""
    return bool((oriented[j] >= oriented[i]).all()
                and (oriented[j] > oriented[i]).any())


def maximal_mask(oriented: np.ndarray, *, block: int = 512) -> np.ndarray:
    """(M,) bool: rows of an oriented ("larger is better", already
    quantized) matrix that no other row dominates.  Exact ties survive
    together.  Blocked O(M^2 A) numpy; no sorting, no recursion."""
    o = np.asarray(oriented, np.float64)
    m = o.shape[0]
    keep = np.ones(m, bool)
    for lo in range(0, m, block):
        hi = min(lo + block, m)
        blk = o[lo:hi]                                   # (B, A)
        ge = (o[None, :, :] >= blk[:, None, :]).all(-1)  # [b, j]: j >= b
        gt = (o[None, :, :] > blk[:, None, :]).any(-1)
        keep[lo:hi] = ~(ge & gt).any(axis=1)
    return keep


def pareto_mask(values: np.ndarray, axes: Sequence[Axis]) -> np.ndarray:
    """(M,) bool frontier membership of raw scores under ``axes``."""
    return maximal_mask(quantize(values, axes))


# ---------------------------------------------------------------------------
# FrontierResult: scores + membership as one queryable record.
# ---------------------------------------------------------------------------

@dataclass
class FrontierResult:
    """A scored quorum-space frontier.

    ``labels``   per-system labels (one per row)
    ``axes``     the ``Axis`` tuple the mask was computed under
    ``values``   (M, A) raw scores, axis order matching ``axes``
    ``mask``     (M,) bool frontier membership
    ``streams``  optional dict of the ``StreamSummary`` states the scores
                 were extracted from (e.g. ``{"fast": ..., "race": ...}``)
                 — mergeable / re-queryable for other quantiles
    ``wall_s``   optional wall seconds of each stream pass
    """

    labels: Tuple[str, ...]
    axes: Tuple[Axis, ...]
    values: Any
    mask: Any
    streams: Optional[Dict[str, Any]] = None
    wall_s: Optional[Dict[str, float]] = None

    # -- queries -----------------------------------------------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def frontier_indices(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.flatnonzero(np.asarray(self.mask)))

    @property
    def frontier_labels(self) -> Tuple[str, ...]:
        return tuple(self.labels[i] for i in self.frontier_indices)

    def row(self, which) -> Dict[str, float]:
        """One system's scores by label or index, plus membership."""
        i = which if isinstance(which, int) else self.labels.index(which)
        vals = np.asarray(self.values)
        out = {a.name: float(vals[i, k]) for k, a in enumerate(self.axes)}
        out["on_frontier"] = bool(np.asarray(self.mask)[i])
        return out

    def table(self, frontier_only: bool = True) -> str:
        """Human-readable score table, frontier members by default."""
        vals = np.asarray(self.values)
        mask = np.asarray(self.mask)
        idx = [i for i in range(len(self.labels))
               if mask[i] or not frontier_only]
        head = ["system", *self.axis_names, "frontier"]
        body = [[self.labels[i],
                 *(f"{vals[i, k]:.4g}" for k in range(len(self.axes))),
                 "*" if mask[i] else ""] for i in idx]
        widths = [max(len(r[c]) for r in [head] + body)
                  for c in range(len(head))]
        fmt = lambda r: "  ".join(s.ljust(w) for s, w in zip(r, widths))
        rule = "  ".join("-" * w for w in widths)
        return "\n".join([fmt(head), rule, *map(fmt, body)])

    def to_dict(self, frontier_only: bool = True) -> Dict[str, float]:
        """Flatten to ``{label.axis: scalar}`` (benchmark CSV shape), plus
        ``n_systems`` / ``n_frontier`` and per-label membership bits."""
        vals = np.asarray(self.values)
        mask = np.asarray(self.mask)
        flat: Dict[str, float] = {
            "n_systems": float(len(self.labels)),
            "n_frontier": float(int(mask.sum())),
        }
        for i, label in enumerate(self.labels):
            if frontier_only and not mask[i]:
                continue
            for k, a in enumerate(self.axes):
                flat[f"{label}.{a.name}"] = float(vals[i, k])
            flat[f"{label}.on_frontier"] = float(mask[i])
        return flat
