"""TLC-lite: exhaustive breadth-first exploration of the Fast Flexible Paxos
specification (Appendix A of the paper) on small configurations.

The paper validates its claim by model-checking a TLA+ spec with TLC.  We do
the same in Python: states are explored breadth-first from ``Init`` under the
full action set (Propose, Phase1a/1b/2a/2b, CoordinatedRecovery,
UncoordinatedRecovery), and the invariants

  Nontriviality:  learned ⊆ proposed
  Consistency:    |learned| ≤ 1

are asserted in every reachable state.  ``learned`` is *derived* from the
message history (v is learned in round i iff a phase-2 round-i quorum all
voted (i, v)), which keeps the state vector small.

Two usage modes, mirroring the paper:

* positive — valid quorum specs (Eqs. 13/14 hold) must explore cleanly;
* negative — a spec violating Eq.14 (e.g. n=3, q1=2, q2c=2, q2f=2) must
  yield a reachable Consistency violation, demonstrating the checker has
  teeth and that the paper's requirements are tight.

Message loss is not modelled: for *safety*, losing messages only removes
behaviours (nodes act on a monotonically growing ``sentMsg``, exactly as in
the TLA+ spec, where LoseMsg only shrinks the set a node can react to).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from .protocol import ANY, NONE, Phase1b, RoundSystem, pick_values
from .quorum import ExplicitQuorumSystem, QuorumSpec

# Compact message encodings: ('1a', i) | ('1b', i, vrnd, vval, acc)
#                           | ('2a', i, val) | ('2b', i, val, acc)
Msg = Tuple
# State: (rnds, vrnds, vvals, crnd, cval, sentMsg frozenset, proposed frozenset)
State = Tuple[Tuple[int, ...], Tuple[int, ...], Tuple, int, object, FrozenSet[Msg], FrozenSet]

A_ANY = ANY
C_NONE = NONE


@dataclass
class CheckResult:
    ok: bool
    states: int
    violation: Optional[str] = None
    trace: Optional[List[str]] = None
    truncated: bool = False

    def __bool__(self) -> bool:
        return self.ok


def _learned(sent: FrozenSet[Msg], rs: RoundSystem) -> Set:
    votes: Dict[int, Dict[object, Set[int]]] = {}
    for m in sent:
        if m[0] == "2b":
            _, i, val, acc = m
            votes.setdefault(i, {}).setdefault(val, set()).add(acc)
    out: Set = set()
    for i, by_val in votes.items():
        for val, accs in by_val.items():
            if rs.contains_q2(accs, i):
                out.add(val)
    return out


def explore(spec: "QuorumSpec | ExplicitQuorumSystem",
            values: Sequence = (1, 2),
            max_round: int = 2,
            fast_rounds: str = "odd",
            max_states: int = 400_000,
            uncoordinated: bool = False) -> CheckResult:
    """BFS the reachable state space; check invariants in every state.

    ``spec`` may be any ``QuorumSystem`` — a cardinality ``QuorumSpec``, an
    ``ExplicitQuorumSystem`` (grid, hand-built), or a system lowered through
    ``to_explicit()`` (e.g. weighted voting): quorum checks route through
    the set-level ``RoundSystem`` predicates, so the checker validates
    arbitrary mask-encodable systems — the differential backstop for the
    Monte-Carlo engine's general quorum support."""
    rs = RoundSystem(spec, n_coordinators=1, fast_rounds=fast_rounds)
    n = rs.spec.n
    rounds = list(range(1, max_round + 1))

    init: State = (
        tuple([0] * n), tuple([0] * n), tuple([A_ANY] * n),
        0, C_NONE, frozenset(), frozenset(),
    )
    parent: Dict[State, Tuple[Optional[State], str]] = {init: (None, "Init")}
    queue: deque = deque([init])
    explored = 0

    while queue:
        st = queue.popleft()
        explored += 1
        if explored > max_states:
            return CheckResult(True, explored - 1, truncated=True)

        rnds, vrnds, vvals, crnd, cval, sent, proposed = st

        # ---- invariants --------------------------------------------------
        learned = _learned(sent, rs)
        if not learned <= set(proposed):
            return CheckResult(False, explored, "Nontriviality", _trace(parent, st))
        if len(learned) > 1:
            return CheckResult(False, explored, "Consistency", _trace(parent, st))

        # ---- successors ----------------------------------------------------
        for nxt, label in _successors(st, rs, values, rounds, uncoordinated):
            if nxt not in parent:
                parent[nxt] = (st, label)
                queue.append(nxt)

    return CheckResult(True, explored)


def _successors(st: State, rs: RoundSystem, values, rounds,
                uncoordinated: bool) -> Iterator[Tuple[State, str]]:
    rnds, vrnds, vvals, crnd, cval, sent, proposed = st
    n = rs.spec.n

    # Propose(v)
    for v in values:
        if v not in proposed:
            yield ((rnds, vrnds, vvals, crnd, cval, sent, proposed | {v}),
                   f"Propose({v})")

    # Phase1a(c, i)
    for i in rounds:
        if crnd < i:
            yield ((rnds, vrnds, vvals, i, C_NONE, sent | {("1a", i)}, proposed),
                   f"Phase1a({i})")

    # Phase1b(i, a)
    for i in rounds:
        if ("1a", i) not in sent:
            continue
        for a in range(n):
            if rnds[a] < i:
                m = ("1b", i, vrnds[a], vvals[a], a)
                nr = _set(rnds, a, i)
                yield ((nr, vrnds, vvals, crnd, cval, sent | {m}, proposed),
                       f"Phase1b({i},{a})")

    # Phase2a(c, v): needs a phase-1 quorum of 1b messages for round crnd.
    if crnd > 0 and cval == C_NONE:
        got = {m[4]: m for m in sent if m[0] == "1b" and m[1] == crnd}
        for Q in rs.q1_subsets(got, crnd):
            msgs = [Phase1b(crnd, got[a][2], got[a][3], a) for a in Q]
            for v in pick_values(rs, crnd, msgs, set(proposed)):
                if v == ANY and not rs.is_fast(crnd):
                    continue
                m = ("2a", crnd, v)
                yield ((rnds, vrnds, vvals, crnd, v, sent | {m}, proposed),
                       f"Phase2a({crnd},{v})")

    # Phase2b(i, a, v)
    for m in sent:
        if m[0] != "2a":
            continue
        _, i, val = m
        cands = list(proposed) if val == ANY else [val]
        for a in range(n):
            if rnds[a] <= i and vrnds[a] < i:
                for v in cands:
                    nr = _set(rnds, a, i)
                    nvr = _set(vrnds, a, i)
                    nvv = _set(vvals, a, v)
                    mm = ("2b", i, v, a)
                    yield ((nr, nvr, nvv, crnd, cval, sent | {mm}, proposed),
                           f"Phase2b({i},{a},{v})")

    # CoordinatedRecovery(c, v): coordinator saw a fast round crnd with cval=ANY.
    i = crnd
    if cval == A_ANY and (i + 1) in rounds:
        p2b = {m[3]: m for m in sent if m[0] == "2b" and m[1] == i}
        for Q in rs.q1_subsets(p2b, i + 1):
            msgs = [Phase1b(i + 1, i, p2b[a][2], a) for a in Q]
            picks = pick_values(rs, i + 1, msgs, set(proposed)) - {ANY}
            for v in picks:
                m = ("2a", i + 1, v)
                yield ((rnds, vrnds, vvals, i + 1, v, sent | {m}, proposed),
                       f"CoordRecovery({i + 1},{v})")

    # UncoordinatedRecovery(i, a, v)
    if uncoordinated:
        for i in rounds:
            if (i + 1) not in rounds or not rs.is_fast(i + 1):
                continue
            p2b = {m[3]: m for m in sent if m[0] == "2b" and m[1] == i}
            for a in range(n):
                # TLA+ Phase2b enabling condition for a round-(i+1) vote:
                # rnd <= i+1 /\ vrnd < i+1 (a promise of i+1 alone does not
                # disable the vote — mirrors Acceptor.uncoordinated_recovery)
                if rnds[a] > i + 1 or vrnds[a] >= i + 1:
                    continue
                for Q in rs.q1_subsets(p2b, i + 1):
                    msgs = [Phase1b(i + 1, i, p2b[b][2], b) for b in Q]
                    picks = pick_values(rs, i + 1, msgs, set(proposed)) - {ANY}
                    for v in picks:
                        nr = _set(rnds, a, i + 1)
                        nvr = _set(vrnds, a, i + 1)
                        nvv = _set(vvals, a, v)
                        mm = ("2b", i + 1, v, a)
                        yield ((nr, nvr, nvv, crnd, cval, sent | {mm}, proposed),
                               f"UncoordRecovery({i + 1},{a},{v})")


def _set(t: Tuple, i: int, v) -> Tuple:
    lst = list(t)
    lst[i] = v
    return tuple(lst)


def _trace(parent: Dict[State, Tuple[Optional[State], str]], st: State) -> List[str]:
    out: List[str] = []
    cur: Optional[State] = st
    while cur is not None:
        prev, label = parent[cur]
        out.append(label)
        cur = prev
    return list(reversed(out))
