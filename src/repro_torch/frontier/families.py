"""Families of FFPaxos-valid quorum systems for frontier sweeps.

The paper's §5/§6 point is that Eqs. 13/14 admit a *space* of quorum
systems; this module enumerates that space family by family, following the
constructions the Flexible/Relaxed Paxos line of work actually proposes:

  cardinality   every (q1, q2c, q2f) triple valid under Eqs. 13/14, at any
                n — the full counting space the paper's §5 examples live in
  grid          3xC grid systems (§6 closing remark) over every C with
                3C <= n, embedded into the n-acceptor cluster; fast quorums
                are row pairs, classic quorums columns
  weighted      Gifford-style weighted voting with h heavyweight acceptors
                and FFP-valid weight thresholds (the weight-space analogues
                of Eqs. 13/14), at two phase-1 aggressiveness levels

Every generator yields ``Member`` records: a label, the *native* system
(usable by the model checker and DES at its natural size), and a
``masks(n)`` lowering that relabels and embeds into the target cluster so
a whole mixed-family batch shares one ``build_mask_table`` call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

from repro_torch.core.quorum import (ExplicitQuorumSystem, QuorumMasks,
                                     WeightedQuorumSystem,
                                     all_relaxed_specs, all_valid_specs,
                                     ffp_card_ok, relaxed_card_ok)


@dataclass(frozen=True)
class Member:
    """One labeled family member.

    ``system`` is the native quorum system (its own natural ``n``);
    ``masks(n)`` lowers it into the shared mask batch of an n-acceptor
    cluster, carrying ``label`` so frontier rows stay identifiable.
    """

    label: str
    system: object          # QuorumSystem protocol object

    def masks(self, n: Optional[int] = None) -> QuorumMasks:
        m = replace(self.system.to_masks(), label=self.label)
        if n is not None and n != m.n:
            m = m.embed(n)
        return m


# ---------------------------------------------------------------------------
# Cardinality: the full Eq. 13/14 space.
# ---------------------------------------------------------------------------

def cardinality_family(n: int) -> List[Member]:
    """Every FFP-valid cardinality triple for a cluster of ``n`` (Eqs.
    13/14), in deterministic (q1, q2c, q2f) order.  This is the *full*
    space — 271 systems at n=11 — not a pre-filtered frontier; dominance
    is the scorer's job."""
    out = []
    for spec in all_valid_specs(n):
        assert ffp_card_ok(n, spec.q1, spec.q2c, spec.q2f)
        out.append(Member(spec.label, spec))
    return out


# ---------------------------------------------------------------------------
# Relaxed Paxos (arXiv 2203.03058): Eq.14 alone, per-round phase-1 sizes.
# ---------------------------------------------------------------------------

def relaxed_family(n: int) -> List[Member]:
    """Every Relaxed-Paxos-valid cardinality triple that FFP Eq.13
    *rejects* — the systems the relaxation newly admits (125 at n=11), in
    deterministic (q1, q2f, q2c) order.  Triples that also satisfy Eq.13
    coincide with their FFP ``QuorumSpec`` (``q1_full == q1``) and already
    live in ``cardinality_family``, so a joint sweep over both families
    never scores the same system twice.  Members are
    ``RelaxedQuorumSpec``s: safety comes from per-round phase-1 quorums
    (``q1_full`` above classic rounds), model-checked clean at n <= 5; the
    lowered masks carry the hot-path (q1, q2c, q2f) triple the engine
    scores, so FFP + relaxed batches share one compile."""
    out = []
    for spec in all_relaxed_specs(n):
        assert relaxed_card_ok(n, spec.q1, spec.q2c, spec.q2f)
        assert not ffp_card_ok(n, spec.q1, spec.q2c, spec.q2f)
        out.append(Member(spec.label, spec))
    return out


# ---------------------------------------------------------------------------
# Grid: 3xC systems over every factorization-compatible width.
# ---------------------------------------------------------------------------

def grid_family(n: int) -> List[Member]:
    """All 3xC grid systems fitting an n-acceptor cluster (3C <= n; the
    §6 pigeonhole construction is only FFP-valid with exactly 3 rows).
    Widths where 3C < n embed — the spare acceptors join no quorum."""
    out = []
    for cols in range(1, n // 3 + 1):
        g = ExplicitQuorumSystem.grid(cols).validate()
        out.append(Member(f"grid.3x{cols}", g))
    return out


# ---------------------------------------------------------------------------
# Weighted: Gifford voting under the FFP weight inequalities.
# ---------------------------------------------------------------------------

def weighted_family(n: int, heavy_counts: Sequence[int] = (1, 2, 3),
                    heavy_weight: int = 2) -> List[Member]:
    """Weighted systems with ``h`` heavyweight acceptors (weight
    ``heavy_weight``, the rest weight 1), for each ``h`` in
    ``heavy_counts`` with h < n.  Two phase-1 levels per weighting — the
    paper-headline-shaped ceil(3W/4) and the Fast-Paxos-shaped
    ceil(2W/3)+1 — each completed with the minimal valid phase-2
    thresholds (t1 + t2c > W, t1 + 2*t2f > 2W).  Every member is
    ``validate()``d against the weight-space Eqs. 13/14."""
    out, seen = [], set()
    for h in heavy_counts:
        if not 1 <= h < n:
            continue
        weights = (heavy_weight,) * h + (1,) * (n - h)
        total = sum(weights)
        for tag, t1 in (("p34", math.ceil(3 * total / 4)),
                        ("p23", (2 * total) // 3 + 1)):
            t2c = total - t1 + 1
            t2f = (2 * total - t1) // 2 + 1
            if not (1 <= t2c <= total and 1 <= t2f <= total):
                continue
            key = (weights, t1, t2c, t2f)
            if key in seen:
                continue
            seen.add(key)
            w = WeightedQuorumSystem(weights, t1, t2c, t2f).validate()
            out.append(Member(f"weighted.{h}x{heavy_weight}.{tag}", w))
    return out


# ---------------------------------------------------------------------------
# Combined enumeration.
# ---------------------------------------------------------------------------

FAMILIES = ("cardinality", "relaxed", "grid", "weighted")


def family(name: str, n: int) -> List[Member]:
    """Enumerate one family by name."""
    if name == "cardinality":
        return cardinality_family(n)
    if name == "relaxed":
        return relaxed_family(n)
    if name == "grid":
        return grid_family(n)
    if name == "weighted":
        return weighted_family(n)
    raise ValueError(f"unknown family {name!r}; pick one of {FAMILIES}")


def all_families(n: int,
                 names: Sequence[str] = FAMILIES) -> List[Member]:
    """Every member of the named families, ready to share one mask batch
    on an n-acceptor cluster (mixed batches lower to the general masked
    engine path; all-cardinality batches keep the "q" specialization)."""
    out: List[Member] = []
    for name in names:
        out.extend(family(name, n))
    labels = [m.label for m in out]
    assert len(set(labels)) == len(labels), "family labels must be unique"
    return out
