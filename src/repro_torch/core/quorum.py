"""Quorum systems and the intersection requirements of the Paxos family.

This module is the heart of the paper: first-class ``QuorumSystem`` objects
plus checkers for every intersection requirement discussed in the paper —

  Paxos           (Eq.1)   any two quorums intersect
  Flexible Paxos  (Eq.3)   every phase-1 quorum intersects every phase-2 quorum
  Fast Paxos      (Eq.5-7) classic/classic, fast/fast/classic, fast/fast/fast
  Fast Flexible   (Eq.11)  every Q1 intersects every classic Q2
  Paxos           (Eq.12)  every Q1 intersects every *pair* of fast Q2s

and their cardinality forms (Eqs. 2, 4, 8-10, 13-14).

Quorum systems are represented explicitly as frozensets of acceptor ids so the
set-based requirements can be checked exactly; cardinality systems enumerate
lazily (validity is proved arithmetically, enumerated only on demand).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import (Dict, FrozenSet, Iterable, Iterator, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np

Acceptor = int
Quorum = FrozenSet[Acceptor]

# Threshold assigned to padding quorum rows in mask encodings: with zero
# weights no indicator can ever reach it, so padded rows never satisfy.
PAD_THRESHOLD = float(2 ** 30)


@runtime_checkable
class QuorumSystem(Protocol):
    """What every evaluation backend asks of a quorum system.

    ``QuorumSpec``, ``ExplicitQuorumSystem`` and ``WeightedQuorumSystem``
    all satisfy it, so one object can be model-checked, DES-simulated and
    Monte-Carlo-swept without reshaping its inputs:

      ``to_masks()``     lowers to the engine's mask encoding — the single
                         lowering every Monte-Carlo path consumes;
      ``to_explicit()``  enumerates the quorums for the set-level protocol
                         predicates (model checker, discrete-event sim);
      ``is_valid()``     the FFP intersection requirements in the system's
                         native form (Eqs. 11-14).
    """

    n: int

    def is_valid(self) -> bool: ...

    def validate(self) -> "QuorumSystem": ...

    def to_masks(self) -> "QuorumMasks": ...

    def to_explicit(self) -> "ExplicitQuorumSystem": ...


# ---------------------------------------------------------------------------
# Set-level intersection predicates (the paper's Eqs. 1, 3, 5-7, 11, 12).
# ---------------------------------------------------------------------------

def pairwise_intersect(qs: Iterable[Quorum], qs2: Iterable[Quorum] | None = None) -> bool:
    """Eq.1 / Eq.3 / Eq.5 / Eq.11: every quorum in ``qs`` meets every one in ``qs2``."""
    qs = list(qs)
    qs2 = qs if qs2 is None else list(qs2)
    return all(q & p for q in qs for p in qs2)


def triple_intersect(a: Iterable[Quorum], b: Iterable[Quorum], c: Iterable[Quorum]) -> bool:
    """Eq.6 / Eq.7 / Eq.12: every (Q,Q',Q'') in a x b x c has a common element."""
    a, b, c = list(a), list(b), list(c)
    return all(q & p & r for q in a for p in b for r in c)


# ---------------------------------------------------------------------------
# Cardinality forms (Eqs. 2, 4, 8-10, 13, 14).
# ---------------------------------------------------------------------------

def paxos_card_ok(n: int, q: int) -> bool:
    return 2 * q > n                                   # Eq.2


def flexible_card_ok(n: int, q1: int, q2: int) -> bool:
    return q1 + q2 > n                                 # Eq.4


def fast_paxos_card_ok(n: int, qc: int, qf: int) -> bool:
    return (2 * qc > n                                 # Eq.8
            and qc + 2 * qf > 2 * n                    # Eq.9
            and 3 * qf > 2 * n)                        # Eq.10


def ffp_card_ok(n: int, q1: int, q2c: int, q2f: int) -> bool:
    """The paper's relaxed requirements (Eqs. 13 & 14)."""
    return (q1 + q2c > n                               # Eq.13
            and q1 + 2 * q2f > 2 * n)                  # Eq.14


def relaxed_card_ok(n: int, q1: int, q2c: int, q2f: int) -> bool:
    """Relaxed Paxos cardinality requirement (arXiv 2203.03058).

    Relaxed Paxos observes that Eq.13 (``q1 + q2c > n``) is only needed by
    phase 1 of rounds that have a *classic* round below them; the hot-path
    recovery round (the first round after the steady-state fast round) only
    needs Eq.14's pair intersection with the fast round.  The per-system
    requirement therefore drops to Eq.14 alone — ``q2c`` is a free choice —
    provided later rounds enlarge their phase-1 quorums to
    ``max(q1, n + 1 - q2c)`` (``RelaxedQuorumSpec.q1_full``), which restores
    Eq.13 exactly where it is needed.
    """
    return 1 <= q2c <= n and q1 + 2 * q2f > 2 * n    # Eq.14 only


def ffp_min_q2f(n: int, q1: int) -> int:
    """Smallest valid fast phase-2 quorum for a given phase-1 quorum (Eq.14)."""
    return max(1, (2 * n - q1) // 2 + 1)


def ffp_min_q2c(n: int, q1: int) -> int:
    """Smallest valid classic phase-2 quorum for a given phase-1 quorum (Eq.13)."""
    return max(1, n - q1 + 1)


def fast_paxos_suggested(n: int, variant: str = "three_quarters") -> Tuple[int, int]:
    """Fast Paxos' own suggested (qc, qf) pairs from Section 2.3."""
    if variant == "two_thirds":
        q = (2 * n) // 3 + 1
        return q, q
    if variant == "three_quarters":
        return n // 2 + 1, math.ceil(3 * n / 4)
    raise ValueError(f"unknown variant {variant!r}")


# ---------------------------------------------------------------------------
# Membership-mask encoding (DESIGN.md §2): the lingua franca between the
# set-level quorum systems here and the batched Monte-Carlo engine / Pallas
# masked-tally kernel.  Per phase, a (G, n) float32 weight matrix plus a (G,)
# threshold vector; an acceptor subset S (0/1 indicator x) satisfies quorum
# row g iff  W[g] . x >= t[g].  The three system families all fit:
#
#   cardinality  one row of ones, threshold q          (G = 1)
#   weighted     one row of weights, phase threshold   (G = 1)
#   explicit     one row per quorum: membership indicator, threshold |Q|
#                (the row "saturates" only when every member is present)
#
# Padding rows carry zero weight and threshold PAD_THRESHOLD, so they are
# never satisfied; padding acceptor columns carry zero weight.
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class QuorumMasks:
    """Mask encoding of one quorum system's three phases (numpy, host-side).

    ``p1``/``p2c``/``p2f`` weights are (G, n) float32; thresholds (G,)
    float32.  Build via the ``to_masks()`` method of ``QuorumSpec``,
    ``ExplicitQuorumSystem`` or ``WeightedQuorumSystem``.
    """

    n: int
    p1_w: np.ndarray
    p1_t: np.ndarray
    p2c_w: np.ndarray
    p2c_t: np.ndarray
    p2f_w: np.ndarray
    p2f_t: np.ndarray
    label: str = ""

    def __post_init__(self) -> None:
        for ph in ("p1", "p2c", "p2f"):
            w, t = getattr(self, ph + "_w"), getattr(self, ph + "_t")
            if w.ndim != 2 or w.shape[1] != self.n or t.shape != (w.shape[0],):
                raise ValueError(
                    f"{ph}: weights {w.shape} / thresholds {t.shape} "
                    f"inconsistent with n={self.n}")
            if (w < 0).any() or (t <= 0).any():
                raise ValueError(f"{ph}: weights must be >= 0, thresholds > 0")

    @property
    def groups(self) -> Tuple[int, int, int]:
        """(G1, G2c, G2f) quorum-row counts."""
        return (self.p1_w.shape[0], self.p2c_w.shape[0], self.p2f_w.shape[0])

    def pad_groups(self, g1: int, g2c: int, g2f: int) -> "QuorumMasks":
        """Pad each phase to the given row count with never-satisfied rows."""
        def pad(w, t, g):
            G = w.shape[0]
            if g < G:
                raise ValueError(f"cannot pad {G} rows down to {g}")
            return (np.concatenate([w, np.zeros((g - G, self.n), np.float32)]),
                    np.concatenate([t, np.full(g - G, PAD_THRESHOLD,
                                               np.float32)]))
        p1w, p1t = pad(self.p1_w, self.p1_t, g1)
        p2cw, p2ct = pad(self.p2c_w, self.p2c_t, g2c)
        p2fw, p2ft = pad(self.p2f_w, self.p2f_t, g2f)
        return QuorumMasks(self.n, p1w, p1t, p2cw, p2ct, p2fw, p2ft,
                           self.label)

    def embed(self, n: int) -> "QuorumMasks":
        """Re-express over a larger cluster: acceptors >= self.n get zero
        weight everywhere (present but never counted), letting systems of
        different natural sizes share one batched mask table."""
        if n < self.n:
            raise ValueError(f"cannot embed n={self.n} into n={n}")
        def wide(w):
            return np.concatenate(
                [w, np.zeros((w.shape[0], n - self.n), np.float32)], axis=1)
        return QuorumMasks(n, wide(self.p1_w), self.p1_t, wide(self.p2c_w),
                           self.p2c_t, wide(self.p2f_w), self.p2f_t,
                           self.label)

    def cardinality_q(self) -> "Tuple[int, int, int] | None":
        """(q1, q2c, q2f) when every phase is a single all-ones row with an
        integral threshold — the encoding ``QuorumSpec.to_masks`` emits.
        ``None`` otherwise.  ``build_mask_table`` uses this to select the
        k-th-order-statistic specialization for all-cardinality tables."""
        qs = []
        for ph in ("p1", "p2c", "p2f"):
            w, t = getattr(self, ph + "_w"), getattr(self, ph + "_t")
            if w.shape[0] != 1 or not (w == 1.0).all():
                return None
            q = float(t[0])
            if q != int(q) or not (1 <= q <= self.n):
                return None
            qs.append(int(q))
        return (qs[0], qs[1], qs[2])

    # -- reference semantics (used by differential tests) -------------------
    def satisfied(self, members: Iterable[Acceptor], phase: str) -> bool:
        """Does the acceptor set satisfy some quorum row of ``phase``?"""
        x = np.zeros(self.n, np.float32)
        x[list(set(members))] = 1.0
        w = getattr(self, phase + "_w")
        t = getattr(self, phase + "_t")
        return bool(((w @ x) >= t).any())

    def fault_tolerance(self) -> Dict[str, int]:
        """Max crashes each phase survives (some quorum stays intact),
        by brute force over crash sets — small n only."""
        def phase_ft(w, t):
            f = 0
            while f < self.n:
                for crash in itertools.combinations(range(self.n), f + 1):
                    alive = np.ones(self.n, np.float32)
                    alive[list(crash)] = 0.0
                    if not ((w @ alive) >= t).any():
                        return f
                f += 1
            return f
        ft1 = phase_ft(self.p1_w, self.p1_t)
        ft2c = phase_ft(self.p2c_w, self.p2c_t)
        ft2f = phase_ft(self.p2f_w, self.p2f_t)
        return {"phase1": ft1, "phase2_classic": ft2c, "phase2_fast": ft2f,
                "steady_state_classic": ft2c, "steady_state_fast": ft2f}


def _card_masks(n: int, q1: int, q2c: int, q2f: int,
                label: str = "") -> QuorumMasks:
    ones = np.ones((1, n), np.float32)
    return QuorumMasks(n, ones, np.array([q1], np.float32),
                       ones.copy(), np.array([q2c], np.float32),
                       ones.copy(), np.array([q2f], np.float32), label)


def _explicit_masks(n: int, p1: Sequence[Quorum], p2c: Sequence[Quorum],
                    p2f: Sequence[Quorum], label: str = "") -> QuorumMasks:
    def rows(qs):
        w = np.zeros((len(qs), n), np.float32)
        for g, q in enumerate(qs):
            w[g, list(q)] = 1.0
        return w, np.array([len(q) for q in qs], np.float32)
    p1w, p1t = rows(p1)
    p2cw, p2ct = rows(p2c)
    p2fw, p2ft = rows(p2f)
    return QuorumMasks(n, p1w, p1t, p2cw, p2ct, p2fw, p2ft, label)


# ---------------------------------------------------------------------------
# Quorum systems.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QuorumSpec:
    """Quorum configuration of a Fast Flexible Paxos deployment.

    ``q1``  phase-1 quorums (identical for fast and classic rounds — §5)
    ``q2c`` phase-2 quorums for classic rounds
    ``q2f`` phase-2 quorums for fast rounds
    """

    n: int
    q1: int
    q2c: int
    q2f: int

    def __post_init__(self) -> None:
        for name in ("q1", "q2c", "q2f"):
            v = getattr(self, name)
            if not (1 <= v <= self.n):
                raise ValueError(f"{name}={v} out of range for n={self.n}")

    # -- validity ----------------------------------------------------------
    def is_valid(self) -> bool:
        return ffp_card_ok(self.n, self.q1, self.q2c, self.q2f)

    def validate(self) -> "QuorumSpec":
        if not self.is_valid():
            raise ValueError(
                f"quorum spec violates FFP intersection requirements: "
                f"n={self.n} q1={self.q1} q2c={self.q2c} q2f={self.q2f} "
                f"(need q1+q2c>n and q1+2*q2f>2n)")
        return self

    # -- constructors ------------------------------------------------------
    @classmethod
    def paper_headline(cls, n: int = 11) -> "QuorumSpec":
        """§5/§6 example: n=11, q1=9, q2f=7, q2c=3."""
        if n == 11:
            return cls(11, 9, 3, 7).validate()
        # generalized: q1 = n - ceil(n/4), then minimal phase-2 quorums.
        q1 = n - max(1, n // 4)
        return cls(n, q1, ffp_min_q2c(n, q1), ffp_min_q2f(n, q1)).validate()

    @classmethod
    def fast_paxos(cls, n: int, variant: str = "three_quarters") -> "QuorumSpec":
        """Fast Paxos baseline expressed in FFP vocabulary (q1=qc, q2c=qc, q2f=qf)."""
        qc, qf = fast_paxos_suggested(n, variant)
        return cls(n, qc, qc, qf).validate()

    @classmethod
    def majority_fast(cls, n: int) -> "QuorumSpec":
        """§5 liveness-limited extreme: majority fast quorums need q1 = n."""
        q2f = n // 2 + 1
        q1 = 2 * n - 2 * q2f + 1
        return cls(n, q1, ffp_min_q2c(n, q1), q2f).validate()

    # -- enumeration (for the set-based checkers & the model checker) -------
    def phase1_quorums(self, acceptors: Sequence[Acceptor] | None = None) -> Iterator[Quorum]:
        yield from _combos(self.n, self.q1, acceptors)

    def phase2c_quorums(self, acceptors: Sequence[Acceptor] | None = None) -> Iterator[Quorum]:
        yield from _combos(self.n, self.q2c, acceptors)

    def phase2f_quorums(self, acceptors: Sequence[Acceptor] | None = None) -> Iterator[Quorum]:
        yield from _combos(self.n, self.q2f, acceptors)

    def check_sets(self) -> bool:
        """Verify Eqs. 11 & 12 by explicit set enumeration (small n only)."""
        p1 = list(self.phase1_quorums())
        p2c = list(self.phase2c_quorums())
        p2f = list(self.phase2f_quorums())
        return (pairwise_intersect(p1, p2c)
                and triple_intersect(p1, p2f, p2f))

    # -- mask export (DESIGN.md §2) ----------------------------------------
    def to_masks(self) -> QuorumMasks:
        """One all-ones row per phase with the cardinality threshold — the
        engine's mask path on this encoding is bit-identical to its
        threshold path."""
        return _card_masks(self.n, self.q1, self.q2c, self.q2f, self.label)

    def to_explicit(self) -> "ExplicitQuorumSystem":
        """Enumerate the size-q quorums (for the set-level backends)."""
        return ExplicitQuorumSystem.from_spec(self)

    @property
    def label(self) -> str:
        return f"card[{self.q1},{self.q2c},{self.q2f}]"

    # -- convenience -------------------------------------------------------
    def fault_tolerance(self) -> dict:
        """How many acceptor crashes each path tolerates while staying live."""
        return {
            "phase1": self.n - self.q1,
            "phase2_classic": self.n - self.q2c,
            "phase2_fast": self.n - self.q2f,
            # steady-state Multi-Paxos-style operation only needs phase-2:
            "steady_state_classic": self.n - self.q2c,
            "steady_state_fast": self.n - self.q2f,
        }


def _combos(n: int, k: int, acceptors: Sequence[Acceptor] | None) -> Iterator[Quorum]:
    ids = range(n) if acceptors is None else acceptors
    for c in itertools.combinations(ids, k):
        yield frozenset(c)


@dataclass(frozen=True)
class RelaxedQuorumSpec(QuorumSpec):
    """Relaxed Paxos quorum configuration (arXiv 2203.03058).

    Validity is ``relaxed_card_ok`` — Eq.14 alone, so ``q2c`` may drop all
    the way to 1 even when ``q1 + q2c <= n``.  Safety is preserved by making
    phase-1 quorum size *per round*: the steady-state fast round and the
    recovery round directly above it use ``q1`` (they only ever need pair
    intersection with fast quorums, Eq.14); any round with a classic round
    below it uses ``q1_full = max(q1, n + 1 - q2c)``, restoring Eq.13 for
    exactly the rounds whose phase 1 must see a classic round's vote.
    ``RoundSystem`` consults ``q1_for`` to apply this (the model checker,
    DES and coordinator all route through it).

    ``to_masks()`` lowers the *hot-path* triple (q1, q2c, q2f) — the fast
    round plus its first recovery, which is what the Monte-Carlo engine
    scores — so all-cardinality batches mixing FFP and Relaxed systems
    share one mask table and one compile.
    """

    def is_valid(self) -> bool:
        return relaxed_card_ok(self.n, self.q1, self.q2c, self.q2f)

    def validate(self) -> "RelaxedQuorumSpec":
        if not self.is_valid():
            raise ValueError(
                f"quorum spec violates the Relaxed Paxos requirement: "
                f"n={self.n} q1={self.q1} q2c={self.q2c} q2f={self.q2f} "
                f"(need q1+2*q2f>2n)")
        return self

    @property
    def q1_full(self) -> int:
        """Phase-1 size for rounds with a classic round below (Eq.13)."""
        return max(self.q1, self.n + 1 - self.q2c)

    def q1_for(self, classic_below: bool) -> int:
        """Per-round phase-1 quorum size — the relaxation's whole trick."""
        return self.q1_full if classic_below else self.q1

    def check_sets(self) -> bool:
        """Relaxed set-level requirement: hot-path phase-1 quorums triple-
        intersect fast-quorum pairs (Eq.12); *full* phase-1 quorums meet
        every classic quorum (Eq.11)."""
        p1_hot = list(self.phase1_quorums())
        p1_full = list(_combos(self.n, self.q1_full, None))
        p2c = list(self.phase2c_quorums())
        p2f = list(self.phase2f_quorums())
        return (pairwise_intersect(p1_full, p2c)
                and triple_intersect(p1_hot, p2f, p2f))

    def to_explicit(self) -> "ExplicitQuorumSystem":
        raise TypeError(
            "RelaxedQuorumSpec has per-round phase-1 quorums (q1 on the hot "
            "path, q1_full above classic rounds); a flat ExplicitQuorumSystem "
            "cannot represent that — keep the cardinality spec (RoundSystem, "
            "the DES and the model checker all consume it directly)")

    def fault_tolerance(self) -> dict:
        """Crash budgets with the per-round phase-1 relaxation priced in:
        ``phase1`` reports the *guaranteed* budget ``n - q1_full`` — once a
        classic round has run, every later phase 1 needs ``q1_full``
        acceptors, so that is the size the system must always be able to
        form.  The hot-path detection quorum stays ``q1`` (it shows up in
        the latency axes instead)."""
        ft = super().fault_tolerance()
        ft["phase1"] = self.n - self.q1_full
        return ft

    @property
    def label(self) -> str:
        return f"relaxed[{self.q1},{self.q2c},{self.q2f}]"


# ---------------------------------------------------------------------------
# Explicit (non-cardinality) quorum systems — §6 "quorum systems that are not
# based solely on quorum cardinality".  These exercise the *set-level*
# requirement checkers, demonstrating that the framework accepts any system
# satisfying Eqs. 11/12, not just counting systems.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExplicitQuorumSystem:
    """A fully enumerated quorum system over acceptors 0..n-1."""

    n: int
    p1: Tuple[Quorum, ...]
    p2c: Tuple[Quorum, ...]
    p2f: Tuple[Quorum, ...]

    def is_valid(self) -> bool:
        return (pairwise_intersect(self.p1, self.p2c)
                and triple_intersect(self.p1, self.p2f, self.p2f))

    def validate(self) -> "ExplicitQuorumSystem":
        if not self.is_valid():
            raise ValueError("explicit quorum system violates Eq.11/Eq.12")
        return self

    @classmethod
    def from_spec(cls, spec: QuorumSpec) -> "ExplicitQuorumSystem":
        return cls(spec.n,
                   tuple(spec.phase1_quorums()),
                   tuple(spec.phase2c_quorums()),
                   tuple(spec.phase2f_quorums()))

    def to_masks(self) -> QuorumMasks:
        """One membership-indicator row per quorum, threshold |Q| (a row
        saturates only once every member is present)."""
        return _explicit_masks(self.n, self.p1, self.p2c, self.p2f,
                               self.label)

    def to_explicit(self) -> "ExplicitQuorumSystem":
        return self

    def embed(self, n: int) -> "ExplicitQuorumSystem":
        """Re-express over a larger cluster: the extra acceptors join no
        quorum (mirrors ``QuorumMasks.embed``, but keeps the set-level form
        so the system still runs on the DES / model-check backends)."""
        if n < self.n:
            raise ValueError(f"cannot embed n={self.n} into n={n}")
        return ExplicitQuorumSystem(n, self.p1, self.p2c, self.p2f)

    @property
    def label(self) -> str:
        return f"explicit[n={self.n}]"

    @classmethod
    def grid(cls, cols: int, rows: int = 3) -> "ExplicitQuorumSystem":
        """A 3xC grid system (non-cardinality example for §6's closing remark).

        phase-1        = one full row ∪ one full column
        phase-2 classic = one column
        phase-2 fast    = two full rows

        Eq.11: a row meets every column.  Eq.12: with exactly three rows, any
        two fast quorums (two rows each) share a row r* by pigeonhole; any
        phase-1 quorum's column hits r*, giving the triple intersection.  The
        pigeonhole argument needs rows == 3 — larger grids admit two fast
        quorums with disjoint row pairs, violating Eq.12 (checked by
        ``is_valid`` and exercised in tests)."""
        if rows != 3:
            raise ValueError("grid construction is only FFP-valid for rows=3")
        n = rows * cols
        idx = lambda r, c: r * cols + c

        def row(r):
            return frozenset(idx(r, c) for c in range(cols))

        def col(c):
            return frozenset(idx(r, c) for r in range(rows))

        p2c = tuple(col(c) for c in range(cols))
        p1 = tuple(row(r) | col(c) for r in range(rows) for c in range(cols))
        p2f = tuple(row(r1) | row(r2)
                    for r1 in range(rows) for r2 in range(rows) if r1 < r2)
        return cls(n, p1, p2c, p2f)


@dataclass(frozen=True)
class WeightedQuorumSystem:
    """Weighted voting (Gifford '79) generalized to FFP thresholds.

    Each acceptor i carries weight w[i]; a set is a quorum for a phase when
    its total weight exceeds the phase threshold.  Validity of the FFP
    requirements for weighted systems:

      Eq.11  t1 + t2c >  W         (any Q1, Q2c overlap)
      Eq.12  t1 + 2*t2f > 2*W      (any Q1 and two Q2f share an acceptor)

    mirroring the cardinality forms with weights in place of counts.
    """

    weights: Tuple[int, ...]
    t1: int
    t2c: int
    t2f: int

    @property
    def n(self) -> int:
        return len(self.weights)

    @property
    def total(self) -> int:
        return sum(self.weights)

    def is_valid(self) -> bool:
        W = self.total
        return self.t1 + self.t2c > W and self.t1 + 2 * self.t2f > 2 * W

    def validate(self) -> "WeightedQuorumSystem":
        if not self.is_valid():
            raise ValueError("weighted system violates FFP thresholds")
        return self

    def is_quorum(self, members: Iterable[Acceptor], phase: str) -> bool:
        w = sum(self.weights[a] for a in set(members))
        t = {"p1": self.t1, "p2c": self.t2c, "p2f": self.t2f}[phase]
        return w >= t

    def enumerate(self, phase: str) -> Iterator[Quorum]:
        """Minimal quorums of a phase (exponential; small n only)."""
        ids = range(self.n)
        for r in range(1, self.n + 1):
            for c in itertools.combinations(ids, r):
                if self.is_quorum(c, phase):
                    s = frozenset(c)
                    if all(not self.is_quorum(s - {a}, phase) for a in s):
                        yield s

    def to_explicit(self) -> ExplicitQuorumSystem:
        """Enumerate minimal quorums into an explicit system (small n)."""
        return ExplicitQuorumSystem(self.n, tuple(self.enumerate("p1")),
                                    tuple(self.enumerate("p2c")),
                                    tuple(self.enumerate("p2f")))

    def to_masks(self) -> QuorumMasks:
        """One weighted row per phase (Gifford-style voting thresholds)."""
        w = np.asarray(self.weights, np.float32)[None, :]
        return QuorumMasks(self.n, w, np.array([self.t1], np.float32),
                           w.copy(), np.array([self.t2c], np.float32),
                           w.copy(), np.array([self.t2f], np.float32),
                           self.label)

    @property
    def label(self) -> str:
        return f"weighted[t1={self.t1},t2c={self.t2c},t2f={self.t2f}]"


def all_valid_specs(n: int) -> Iterator[QuorumSpec]:
    """Every cardinality spec valid under Eqs. 13/14 for a cluster of n."""
    for q1 in range(1, n + 1):
        for q2c in range(ffp_min_q2c(n, q1), n + 1):
            for q2f in range(ffp_min_q2f(n, q1), n + 1):
                yield QuorumSpec(n, q1, q2c, q2f)


def all_relaxed_specs(n: int) -> Iterator[RelaxedQuorumSpec]:
    """Every Relaxed-Paxos-valid cardinality spec (Eq.14 only) that FFP
    Eq.13 *rejects* — the systems the relaxation newly admits.  (A triple
    that also satisfies Eq.13 behaves identically to its FFP ``QuorumSpec``
    — ``q1_full == q1`` — so only the strictly-new points are yielded.)"""
    for q1 in range(1, n + 1):
        for q2f in range(ffp_min_q2f(n, q1), n + 1):
            for q2c in range(1, ffp_min_q2c(n, q1)):
                yield RelaxedQuorumSpec(n, q1, q2c, q2f)
