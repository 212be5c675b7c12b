"""Fast Flexible Paxos protocol logic, faithful to the paper's Appendix A.

The module is deliberately split into two layers:

* **pure logic** — ``RoundSystem`` (round → fast/classic, coordinator-of-round,
  per-round quorum predicates) and ``pick_values`` (the TLA+ ``IsPickableVal``
  rule, including the O4 condition evaluated against *phase-2* quorums — the
  paper's modification of Fast Paxos' Figure 2 rule).  These functions are
  shared verbatim by the discrete-event simulator, the TLC-lite model checker
  and the cluster control plane, so one implementation is validated three ways.

* **node classes** — ``Acceptor``, ``Coordinator``, ``Learner`` consume and
  emit ``Message`` values; transport (delays, loss, duplication) is supplied
  by the caller (see ``simulator.py``).

Classic Paxos and Fast Paxos are *configurations* of the same code: Fast Paxos
is FFP with ``q1 = q2c = qc`` and ``q2f = qf`` (the paper's §2.3 framing), and
Paxos is the degenerate no-fast-round case.  The baselines the paper compares
against therefore share every code path except quorum sizes.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, FrozenSet, Hashable, Iterable, List, Optional, Sequence, Set, Tuple

from .quorum import QuorumSpec

Value = Hashable

# Sentinels (the TLA+ spec's ``any`` and ``none``).
ANY = "__ANY__"
NONE = "__NONE__"


# ---------------------------------------------------------------------------
# Messages (the TLA+ ``Message`` set).
# ---------------------------------------------------------------------------

@dataclass(frozen=True, order=True)
class Phase1a:
    rnd: int


@dataclass(frozen=True, order=True)
class Phase1b:
    rnd: int
    vrnd: int
    vval: Value
    acc: int


@dataclass(frozen=True, order=True)
class Phase2a:
    rnd: int
    val: Value          # may be ANY in fast rounds


@dataclass(frozen=True, order=True)
class Phase2b:
    rnd: int
    val: Value
    acc: int


@dataclass(frozen=True, order=True)
class Proposal:
    """A client value sent directly to acceptors (fast-round path)."""
    val: Value


Message = object


# ---------------------------------------------------------------------------
# Round system: fast/classic rounds, coordinators, quorums.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RoundSystem:
    """Assigns round numbers to coordinators and fast/classic kinds.

    Round 0 is "no round".  By default odd rounds starting at 1 are *fast*
    (steady state) and even rounds are *classic* (recovery), matching the
    deployment style of §6: the system sits in a fast round; collisions are
    resolved by the coordinator moving to the next (classic) round.

    ``spec`` may be any ``QuorumSystem`` — a cardinality ``QuorumSpec``, an
    ``ExplicitQuorumSystem`` (grids, hand-built sets, ...), or anything else
    exposing ``to_explicit()`` (e.g. ``WeightedQuorumSystem``), which is
    lowered to its enumerated explicit form on construction.  Everything
    downstream — ``pick_values``, the learner, the model checker, the
    discrete-event simulator — speaks only the set-level predicates
    ``contains_q1``/``contains_q2``/``q1_subsets``, which degrade to the
    original cardinality comparisons when ``spec`` is a ``QuorumSpec``.
    """

    spec: object                  # QuorumSpec | ExplicitQuorumSystem
    n_coordinators: int = 1
    fast_rounds: str = "odd"      # "odd" | "all" | "none"

    def __post_init__(self) -> None:
        # Lower anything that is neither cardinality nor already explicit
        # (weighted voting, future families) through the QuorumSystem
        # protocol; QuorumSpec keeps its O(1) counting predicates.
        spec = self.spec
        if not isinstance(spec, QuorumSpec) and not hasattr(spec, "p1"):
            if not hasattr(spec, "to_explicit"):
                raise TypeError(
                    f"RoundSystem needs a QuorumSpec, an explicit system, or "
                    f"a QuorumSystem with to_explicit(); got {type(spec)!r}")
            object.__setattr__(self, "spec", spec.to_explicit())

    def is_fast(self, rnd: int) -> bool:
        if rnd <= 0:
            return False
        if self.fast_rounds == "all":
            return True
        if self.fast_rounds == "none":
            return False
        return rnd % 2 == 1

    def coord_of(self, rnd: int) -> int:
        return rnd % self.n_coordinators

    @property
    def cardinality(self) -> bool:
        return isinstance(self.spec, QuorumSpec)

    def _q1_size(self, rnd: int) -> int:
        """Phase-1 quorum size of round ``rnd`` (cardinality systems).

        Plain FFP specs use one q1 for every round (§5).  Relaxed Paxos
        specs (``RelaxedQuorumSpec``) expose ``q1_for``: rounds whose
        history contains a classic round need the Eq.13-restoring
        ``q1_full``; rounds above nothing but fast rounds (the steady-state
        hot path and its first recovery) keep the relaxed ``q1``.
        """
        spec = self.spec
        if hasattr(spec, "q1_for"):
            return spec.q1_for(any(not self.is_fast(j)
                                   for j in range(1, rnd)))
        return spec.q1

    # -- quorum sizes (cardinality systems only) ----------------------------
    def q1(self, rnd: int) -> int:          # phase-1 (fast or classic: §5)
        if not self.cardinality:
            raise TypeError("q1() is a cardinality-system accessor; use "
                            "contains_q1()/q1_subsets() for explicit systems")
        return self._q1_size(rnd)

    def q2(self, rnd: int) -> int:          # phase-2 depends on round kind
        if not self.cardinality:
            raise TypeError("q2() is a cardinality-system accessor; use "
                            "contains_q2() for explicit systems")
        return self.spec.q2f if self.is_fast(rnd) else self.spec.q2c

    # -- quorum predicates over acceptor-id sets ----------------------------
    def contains_q1(self, acceptors: Iterable[int], rnd: int) -> bool:
        """Does the set contain (a superset of) some phase-1 quorum?"""
        s = set(acceptors)
        if self.cardinality:
            return len(s) >= self._q1_size(rnd)
        return any(q <= s for q in self.spec.p1)

    def contains_q2(self, acceptors: Iterable[int], rnd: int) -> bool:
        """Does the set contain some phase-2 quorum of round ``rnd``?"""
        s = set(acceptors)
        if self.cardinality:
            return len(s) >= self.q2(rnd)
        qs = self.spec.p2f if self.is_fast(rnd) else self.spec.p2c
        return any(q <= s for q in qs)

    def q1_subsets(self, available: Iterable[int],
                   rnd: int) -> Iterable[Tuple[int, ...]]:
        """Every phase-1 quorum drawn from ``available`` (sorted tuples).
        For cardinality systems these are the size-q1 combinations; for
        explicit systems, the enumerated quorums contained in the set."""
        avail = sorted(set(available))
        if self.cardinality:
            yield from itertools.combinations(avail, self._q1_size(rnd))
            return
        s = set(avail)
        for q in self.spec.p1:
            if q <= s:
                yield tuple(sorted(q))

    # Backwards-compatible aliases (the original >=-threshold predicates).
    def is_q1(self, acceptors: Iterable[int], rnd: int) -> bool:
        return self.contains_q1(acceptors, rnd)

    def is_q2(self, acceptors: Iterable[int], rnd: int) -> bool:
        return self.contains_q2(acceptors, rnd)


# ---------------------------------------------------------------------------
# IsPickableVal — the coordinator's phase-2 value-picking rule.
# ---------------------------------------------------------------------------

def pick_values(rs: RoundSystem,
                i: int,
                msgs: Sequence[Phase1b],
                proposed: Set[Value]) -> Set[Value]:
    """Return every value v for which TLA+ ``IsPickableVal(Q, i, M, v)`` holds.

    ``msgs`` are the round-i phase-1b messages from a phase-1 quorum Q (one
    per acceptor).  The O4 condition is evaluated against *phase-2* quorums of
    round k (the paper's modification): O4(w) asks whether some phase-2
    round-k quorum R could have decided w given what Q reported, i.e. whether
    the acceptors *outside* Q together with the members of Q that voted (k, w)
    can still form a round-k phase-2 quorum.
    """
    assert msgs, "phase-1 quorum must be non-empty"
    by_acc = {m.acc: m for m in msgs}
    assert len(by_acc) == len(msgs), "one phase-1b message per acceptor"
    Q = set(by_acc)

    k = max(m.vrnd for m in msgs)
    if k == 0:
        # Nothing voted below round i: any proposed value, or ANY in fast rounds.
        picks: Set[Value] = set(proposed)
        if rs.is_fast(i):
            picks.add(ANY)
        return picks

    V = {m.vval for m in msgs if m.vrnd == k}
    if len(V) == 1:
        return set(V)

    # Multiple values seen at round k (k must be fast): O4 elimination.
    # O4(w) asks whether some round-k phase-2 quorum could have decided w
    # given what Q reported: the acceptors outside Q (whose round-k votes Q
    # cannot see) plus the members of Q that voted (k, w) must still contain
    # a round-k phase-2 quorum.  For cardinality systems this reduces to the
    # original ``outside + in_q_voted_w >= q2(k)`` arithmetic.
    outside = set(range(rs.spec.n)) - Q

    def o4(w: Value) -> bool:
        voted_w = {m.acc for m in msgs if m.vrnd == k and m.vval == w}
        return rs.contains_q2(outside | voted_w, k)

    winners = {w for w in V if o4(w)}
    if winners:
        # TLA+: v = CHOOSE w ∈ V : O4(w).  Eq.12 guarantees at most one value
        # can actually be decided, but more than one may *pass* O4 when no
        # value was decided; any single deterministic choice is safe.  We
        # return the full O4-passing set and let callers choose
        # deterministically (min) — the model checker explores each.
        return winners
    return set(proposed)


def _canonical_key(v: Value) -> Tuple:
    """Total order over heterogeneous values for deterministic CHOOSE.

    Numbers compare numerically (``repr`` ordered them lexicographically:
    ``repr(10) < repr(2)``), strings lexicographically, everything else by
    type name then ``repr``.  The leading rank tag keeps the tuple
    comparison from ever comparing across types.
    """
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        if isinstance(v, str):
            return (1, v)
        return (2, type(v).__name__, repr(v))
    return (0, v)


def choose_value(picks: Set[Value],
                 counts: Optional[Dict[Value, int]] = None) -> Value:
    """Deterministic CHOOSE over a pick set (prefer concrete over ANY).

    ``counts`` (round-k vote tallies) biases the free choice towards the
    plurality value.  This only matters when *no* value passed O4 — for any
    valid phase-1 quorum at most one value can pass O4 (Eq. 12), so when it
    does the pick set is a singleton and the preference is inert.  Preferring
    the plurality value is the liveness-optimal recovery heuristic: it is the
    value closest to a phase-2 quorum in the collision round.

    Ties sort by ``(-count, canonical key)`` in one pass — numeric values
    order numerically, so the choice is stable across value types.
    """
    concrete = [v for v in picks if v != ANY]
    if concrete:
        tally = counts or {}
        return min(concrete,
                   key=lambda v: (-tally.get(v, 0), _canonical_key(v)))
    return ANY


# ---------------------------------------------------------------------------
# Node state machines.
# ---------------------------------------------------------------------------

@dataclass
class Acceptor:
    """TLA+ acceptor: variables rnd, vrnd, vval."""

    aid: int
    rs: RoundSystem
    rnd: int = 0
    vrnd: int = 0
    vval: Value = ANY

    def on_phase1a(self, m: Phase1a) -> Optional[Phase1b]:
        if self.rnd < m.rnd:
            self.rnd = m.rnd
            return Phase1b(m.rnd, self.vrnd, self.vval, self.aid)
        return None

    def on_phase2a(self, m: Phase2a, proposed_val: Optional[Value] = None) -> Optional[Phase2b]:
        """Vote in round m.rnd.  If m.val is ANY, ``proposed_val`` is the
        client value this acceptor received first (fast path)."""
        if self.rnd > m.rnd or self.vrnd >= m.rnd:
            return None
        v = m.val
        if v == ANY:
            if proposed_val is None:
                return None
            v = proposed_val
        self.rnd = m.rnd
        self.vrnd = m.rnd
        self.vval = v
        return Phase2b(m.rnd, v, self.aid)

    def last_msg(self) -> Message:
        """TLA+ accLastMsg — for retransmission."""
        if self.vrnd < self.rnd:
            return Phase1b(self.rnd, self.vrnd, self.vval, self.aid)
        return Phase2b(self.rnd, self.vval, self.aid)

    def uncoordinated_recovery(self, i: int, p1b_msgs: Sequence[Phase1b],
                               proposed: Set[Value]) -> Optional[Phase2b]:
        """Recover from a round-i collision by voting directly in round i+1
        (must be fast).  ``p1b_msgs`` is P2bToP1b(Q, i) for a phase-1 quorum Q
        of round i+1.

        The guard mirrors the TLA+ Phase2b enabling condition for a round
        i+1 vote — ``rnd <= i+1 /\\ vrnd < i+1`` — so an acceptor that
        already *promised* round i+1 (rnd == i+1 from a Phase1a) can still
        vote in it; only a vote in i+1 or a promise beyond it disables the
        action.  (The old ``self.rnd > i`` rejection was strictly tighter
        than the spec: it silently excluded promised-but-unvoted acceptors,
        shrinking the recovery quorum for no safety gain.)
        """
        if not self.rs.is_fast(i + 1) or self.rnd > i + 1 \
                or self.vrnd >= i + 1:
            return None
        if not self.rs.is_q1({m.acc for m in p1b_msgs}, i + 1):
            return None
        picks = pick_values(self.rs, i + 1, list(p1b_msgs), proposed)
        counts: Dict[Value, int] = {}
        for m in p1b_msgs:
            if m.vrnd == i:
                counts[m.vval] = counts.get(m.vval, 0) + 1
        v = choose_value(picks - {ANY}, counts)
        if v == ANY:
            return None
        self.rnd = i + 1
        self.vrnd = i + 1
        self.vval = v
        return Phase2b(i + 1, v, self.aid)


def p2b_to_p1b(msgs: Iterable[Phase2b], i: int) -> List[Phase1b]:
    """TLA+ P2bToP1b: reinterpret round-i phase-2b votes as round-i+1
    phase-1b messages (collision recovery without an explicit phase 1)."""
    return [Phase1b(i + 1, i, m.val, m.acc) for m in msgs if m.rnd == i]


@dataclass
class Coordinator:
    """TLA+ coordinator: variables crnd, cval; drives phase 1 and phase 2."""

    cid: int
    rs: RoundSystem
    crnd: int = 0
    cval: Value = NONE
    am_leader: bool = True
    p1b: Dict[int, Dict[int, Phase1b]] = field(default_factory=dict)   # rnd -> acc -> msg
    p2b: Dict[int, Dict[int, Phase2b]] = field(default_factory=dict)   # rnd -> acc -> msg

    # -- phase 1 -----------------------------------------------------------
    def start_round(self, i: int) -> Optional[Phase1a]:
        """Phase1a(c, i)."""
        if not self.am_leader or self.rs.coord_of(i) != self.cid or self.crnd >= i:
            return None
        self.crnd = i
        self.cval = NONE
        return Phase1a(i)

    def on_phase1b(self, m: Phase1b) -> None:
        self.p1b.setdefault(m.rnd, {})[m.acc] = m

    def try_phase2a(self, proposed: Set[Value]) -> Optional[Phase2a]:
        """Phase2a(c, v): once a phase-1 quorum reported, pick and send v."""
        i = self.crnd
        if i == 0 or self.cval != NONE or not self.am_leader:
            return None
        msgs = list(self.p1b.get(i, {}).values())
        if not self.rs.is_q1({m.acc for m in msgs}, i):
            return None
        picks = pick_values(self.rs, i, msgs, proposed)
        if not picks:
            return None
        v = choose_value(picks)
        if v == ANY and not self.rs.is_fast(i):
            v = choose_value(picks - {ANY})
            if v == ANY:
                return None
        self.cval = v
        return Phase2a(i, v)

    # -- collision recovery --------------------------------------------------
    def on_phase2b(self, m: Phase2b) -> None:
        self.p2b.setdefault(m.rnd, {})[m.acc] = m

    def coordinated_recovery(self, proposed: Set[Value]) -> Optional[Phase2a]:
        """CoordinatedRecovery(c, v): observe a round-i collision through
        phase-2b messages and jump straight to phase 2 of round i+1."""
        i = self.crnd
        if not self.am_leader or self.cval != ANY or self.rs.coord_of(i + 1) != self.cid:
            return None
        msgs = p2b_to_p1b(self.p2b.get(i, {}).values(), i)
        if not self.rs.is_q1({m.acc for m in msgs}, i + 1):
            return None
        picks = pick_values(self.rs, i + 1, msgs, proposed) - {ANY}
        if not picks:
            return None
        counts: Dict[Value, int] = {}
        for m in msgs:
            if m.vrnd == i:
                counts[m.vval] = counts.get(m.vval, 0) + 1
        v = choose_value(picks, counts)
        self.cval = v
        self.crnd = i + 1
        return Phase2a(i + 1, v)

    def last_msg(self) -> Optional[Message]:
        """TLA+ coordLastMsg."""
        if self.crnd == 0:
            return None
        if self.cval == NONE:
            return Phase1a(self.crnd)
        return Phase2a(self.crnd, self.cval)


@dataclass
class Learner:
    """Watches phase-2b votes; learns v once a phase-2 quorum voted (i, v)."""

    rs: RoundSystem
    votes: Dict[int, Dict[int, Value]] = field(default_factory=dict)  # rnd -> acc -> val
    learned: Set[Value] = field(default_factory=set)

    def on_phase2b(self, m: Phase2b) -> Optional[Value]:
        self.votes.setdefault(m.rnd, {})[m.acc] = m.val
        by_val: Dict[Value, Set[int]] = {}
        for acc, val in self.votes[m.rnd].items():
            by_val.setdefault(val, set()).add(acc)
        for val, accs in by_val.items():
            if self.rs.contains_q2(accs, m.rnd):
                self.learned.add(val)
                return val
        return None

    def collision_suspected(self, rnd: int) -> bool:
        """True when round-rnd votes can no longer reach any single-value
        phase-2 quorum: for every value, even if all outstanding acceptors
        voted for it, its voters would not contain a quorum."""
        votes = self.votes.get(rnd, {})
        if not votes:
            return False
        by_val: Dict[Value, Set[int]] = {}
        for acc, val in votes.items():
            by_val.setdefault(val, set()).add(acc)
        if len(by_val) <= 1:
            return False
        outstanding = set(range(self.rs.spec.n)) - set(votes)
        return not any(self.rs.contains_q2(accs | outstanding, rnd)
                       for accs in by_val.values())
