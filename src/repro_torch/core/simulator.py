"""Discrete-event simulator of a Fast (Flexible) Paxos deployment.

Reproduces the paper's §6 evaluation environment in simulation: the paper ran
Paxi on 11 AWS EC2 m5a.large VMs in one region; we are CPU-only on one host,
so the *network* is simulated — per-message one-way delays drawn from a
shifted-lognormal distribution fit to same-region EC2 RTTs (~0.5 ms median
one-way, heavy right tail).  Both algorithms under comparison run over
identical sampled delays (common random numbers), so latency *ratios* — the
paper's claim — are preserved by construction.

The simulated deployment matches §6's steady state:

* a stable coordinator has pre-executed phase-1 for every instance (the
  Multi-Paxos-style ``any`` message is already at the acceptors), so clients
  send proposals *directly* to acceptors (the fast path);
* each acceptor votes for the first proposal it receives per instance and
  sends phase-2b to the coordinator (the learner);
* the coordinator learns a value once a fast phase-2 quorum (q2f) votes for
  it; on a collision (no value can reach q2f) it runs *coordinated recovery*:
  picks a value per ``IsPickableVal`` from the round-i votes reinterpreted as
  round-i+1 phase-1b messages, and commits it in a classic round with q2c.

``recovery="uncoordinated"`` swaps the collision path for the leaderless
rule (arXiv 1710.08047): acceptors broadcast their round-1 votes to each
other, and each acceptor that can locally prove the fast round dead over a
phase-1 quorum of observed votes runs ``Acceptor.uncoordinated_recovery``
— voting directly in (fast) round 2 — so the learner commits once q2f
round-2 votes agree, skipping the coordinator round trip.

Node and protocol behaviour comes from ``core.protocol`` — the same
state machines validated by the model checker.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from .protocol import (ANY, Acceptor, Coordinator, Learner, Phase1b, Phase2a,
                       Phase2b, RoundSystem, choose_value, p2b_to_p1b,
                       pick_values)
from .quorum import ExplicitQuorumSystem, QuorumSpec


# ---------------------------------------------------------------------------
# Network model.
# ---------------------------------------------------------------------------

@dataclass
class LatencyModel:
    """Shifted-lognormal one-way delay (EC2 same-region m5a profile).

    one_way = base + LogNormal(mu, sigma)   [milliseconds]

    Defaults give ~0.25 ms floor, ~0.55 ms median, ~1 ms p95 one-way —
    consistent with the ~1.5-2 ms fast-path commit latencies in Fig. 2a.
    """

    base_ms: float = 0.25
    mu: float = -1.20       # ln(0.30)
    sigma: float = 0.55
    loss_prob: float = 0.0

    def sample(self, rng: random.Random) -> Optional[float]:
        if self.loss_prob and rng.random() < self.loss_prob:
            return None
        return self.base_ms + rng.lognormvariate(self.mu, self.sigma)


# ---------------------------------------------------------------------------
# Event loop.
# ---------------------------------------------------------------------------

@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)


class EventLoop:
    def __init__(self) -> None:
        self._q: List[_Event] = []
        self._seq = itertools.count()
        self.now = 0.0

    def at(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._q, _Event(t, next(self._seq), fn))

    def after(self, dt: float, fn: Callable) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: float = math.inf) -> None:
        while self._q and self._q[0].time <= until:
            ev = heapq.heappop(self._q)
            self.now = ev.time
            ev.fn()


# ---------------------------------------------------------------------------
# Per-instance consensus record at the coordinator.
# ---------------------------------------------------------------------------

@dataclass
class InstanceState:
    learner: Learner
    votes_r1: Dict[int, object] = field(default_factory=dict)   # acc -> val
    decided: Optional[object] = None
    decide_time: Optional[float] = None
    recovered: bool = False
    recovery_sent: bool = False
    r2_votes: Dict[int, object] = field(default_factory=dict)


@dataclass
class InstanceResult:
    instance: int
    value: object
    proposer: int
    submit_time: float
    decide_time: Optional[float]
    outcome: str           # "fast" | "recovered" | "aborted" | "lost"

    @property
    def latency_ms(self) -> Optional[float]:
        if self.decide_time is None:
            return None
        return self.decide_time - self.submit_time


RECOVERY_MODES = ("coordinated", "uncoordinated")


class FastPaxosSim:
    """One simulated cluster running either Fast Paxos or Fast Flexible Paxos
    (the difference is purely the quorum system).  ``spec`` may be any
    ``QuorumSystem`` — a cardinality ``QuorumSpec``, an
    ``ExplicitQuorumSystem`` (grid, hand-built, ...), or a system lowered
    through ``to_explicit()`` (e.g. ``WeightedQuorumSystem``): all quorum
    checks route through the set-level ``RoundSystem`` predicates.

    ``recovery`` selects the collision rule: ``"coordinated"`` (default)
    routes recovery through the coordinator's classic round 2 (q2c),
    ``"uncoordinated"`` lets acceptors vote directly in a fast round 2
    (q2f) from their own peer-broadcast view of round 1."""

    def __init__(self, spec: "QuorumSpec | ExplicitQuorumSystem",
                 latency: LatencyModel | None = None,
                 seed: int = 0, crashed: Sequence[int] = (),
                 recovery: str = "coordinated") -> None:
        if recovery not in RECOVERY_MODES:
            raise ValueError(f"unknown recovery rule {recovery!r}; "
                             f"pick one of {RECOVERY_MODES}")
        self.recovery = recovery
        self.spec = spec.validate()
        # Uncoordinated recovery votes happen *in* round 2, so round 2 must
        # be fast there; the coordinated path keeps the classic round 2.
        fast_rounds = "all" if recovery == "uncoordinated" else "odd"
        self.rs = RoundSystem(spec, n_coordinators=1, fast_rounds=fast_rounds)
        self.lat = latency or LatencyModel()
        self.rng = random.Random(seed)
        self.loop = EventLoop()
        self.n = self.rs.spec.n
        self.crashed: Set[int] = set(crashed)
        # Per-instance acceptor vote registries (steady-state fast round 1:
        # phase-1 already ran; acceptors accept the first proposal per slot).
        self.acc_vote: List[Dict[int, object]] = [dict() for _ in range(self.n)]
        self.instances: Dict[int, InstanceState] = {}
        self.results: Dict[Tuple[int, object], InstanceResult] = {}
        self.recovery_entries = 0
        self.fast_decides = 0
        # Uncoordinated-mode state: per-acceptor view of peer round-1 votes,
        # per-acceptor set of instances already recovered in round 2, and the
        # set of instances counted in ``recovery_entries``.
        self.peer_seen: List[Dict[int, Dict[int, object]]] = \
            [dict() for _ in range(self.n)]
        self.uncoord_voted: List[Set[int]] = [set() for _ in range(self.n)]
        self._rec_instances: Set[int] = set()

    # -- client API ----------------------------------------------------------
    def submit(self, t: float, instance: int, value: object, proposer: int = 0) -> None:
        """Client submits ``value`` for ``instance`` at time t (fast path:
        straight to every acceptor)."""
        self.results[(instance, value)] = InstanceResult(
            instance, value, proposer, t, None, "lost")
        self.loop.at(t, lambda: self._broadcast_proposal(instance, value))

    def _broadcast_proposal(self, instance: int, value: object) -> None:
        for a in range(self.n):
            if a in self.crashed:
                continue
            d = self.lat.sample(self.rng)
            if d is None:
                continue
            self.loop.after(d, lambda a=a: self._acceptor_recv(a, instance, value))

    # -- acceptor fast-path vote ----------------------------------------------
    def _acceptor_recv(self, a: int, instance: int, value: object) -> None:
        votes = self.acc_vote[a]
        if instance in votes:           # already voted in round 1 of this slot
            return
        if instance in self.uncoord_voted[a]:
            return                      # already voted round 2 (vrnd = 2 > 1)
        votes[instance] = value
        d = self.lat.sample(self.rng)
        if d is not None:
            self.loop.after(d, lambda: self._coord_recv_2b(instance, 1, a, value))
        if self.recovery == "uncoordinated":
            # 2b goes to the peer acceptors too (one-way each); the voter
            # observes its own vote immediately.
            self._acceptor_recv_peer_2b(a, instance, a, value)
            for b in range(self.n):
                if b == a or b in self.crashed:
                    continue
                d = self.lat.sample(self.rng)
                if d is None:
                    continue
                self.loop.after(d, lambda b=b: self._acceptor_recv_peer_2b(
                    b, instance, a, value))

    # -- uncoordinated recovery (acceptor side) -------------------------------
    def _acceptor_recv_peer_2b(self, b: int, instance: int, a: int,
                               value: object) -> None:
        seen = self.peer_seen[b].setdefault(instance, {})
        if a in seen:
            return
        seen[a] = value
        self._maybe_uncoord_recover(b, instance)

    def _fast_round_dead(self, seen: Dict[int, object]) -> bool:
        """Local collision proof: no value can reach a fast round-1 quorum
        even if every acceptor this view is missing voted for it (the same
        predicate as ``Learner.collision_suspected``, over a peer view)."""
        by_val: Dict[object, Set[int]] = {}
        for acc, val in seen.items():
            by_val.setdefault(val, set()).add(acc)
        if len(by_val) <= 1:
            return False
        outstanding = set(range(self.n)) - set(seen)
        return not any(self.rs.contains_q2(accs | outstanding, 1)
                       for accs in by_val.values())

    def _maybe_uncoord_recover(self, b: int, instance: int) -> None:
        """UncoordRecovery(b): once acceptor b's peer view holds a round-2
        phase-1 quorum of round-1 votes and proves the fast round dead, b
        picks per ``IsPickableVal`` and votes directly in (fast) round 2."""
        if instance in self.uncoord_voted[b]:
            return
        seen = self.peer_seen[b][instance]
        if not self.rs.contains_q1(seen, 2) or not self._fast_round_dead(seen):
            return
        acc = Acceptor(b, self.rs, rnd=1, vrnd=1, vval=self.acc_vote[b][instance]) \
            if instance in self.acc_vote[b] else Acceptor(b, self.rs)
        msgs = [Phase1b(2, 1, v, a) for a, v in seen.items()]
        m2b = acc.uncoordinated_recovery(1, msgs, set(seen.values()))
        if m2b is None:
            return
        self.uncoord_voted[b].add(instance)
        if instance not in self._rec_instances:
            self._rec_instances.add(instance)
            self.recovery_entries += 1
        d = self.lat.sample(self.rng)
        if d is None:
            return
        self.loop.after(d, lambda: self._coord_recv_2b(instance, 2, b, m2b.val))

    # -- coordinator / learner --------------------------------------------------
    def _inst(self, instance: int) -> InstanceState:
        if instance not in self.instances:
            self.instances[instance] = InstanceState(Learner(self.rs))
        return self.instances[instance]

    def _coord_recv_2b(self, instance: int, rnd: int, a: int, value: object) -> None:
        ist = self._inst(instance)
        if ist.decided is not None:
            return
        if rnd == 1:
            ist.votes_r1.setdefault(a, value)
        else:
            ist.r2_votes.setdefault(a, value)
        learned = ist.learner.on_phase2b(Phase2b(rnd, value, a))
        if learned is not None:
            ist.decided = learned
            ist.decide_time = self.loop.now
            if rnd == 1:
                self.fast_decides += 1
            self._finalize(instance, ist, outcome="fast" if rnd == 1 else "recovered")
            return
        if rnd == 1 and self.recovery == "coordinated" \
                and not ist.recovery_sent and ist.learner.collision_suspected(1):
            self._start_recovery(instance, ist)

    def _start_recovery(self, instance: int, ist: InstanceState) -> None:
        """Coordinated recovery: round-1 2b votes become round-2 1b messages
        (needs a phase-1 quorum of them), pick per IsPickableVal, commit
        classically with q2c."""
        votes = ist.votes_r1
        if not self.rs.contains_q1(votes, 2):
            # Wait for more votes — re-check on each arrival.
            return
        ist.recovery_sent = True
        self.recovery_entries += 1
        msgs = [Phase1b(2, 1, v, a) for a, v in votes.items()]
        picks = pick_values(self.rs, 2, msgs, set(votes.values())) - {ANY}
        v = choose_value(picks)
        for a in range(self.n):
            if a in self.crashed:
                continue
            d = self.lat.sample(self.rng)
            if d is None:
                continue
            self.loop.after(d, lambda a=a, v=v: self._acceptor_recv_2a_r2(a, instance, v))

    def _acceptor_recv_2a_r2(self, a: int, instance: int, v: object) -> None:
        # Classic round 2 vote (rnd[a] <= 2, vrnd[a] < 2 always holds here:
        # acceptors only voted in round 1 for this slot).
        d = self.lat.sample(self.rng)
        if d is None:
            return
        self.loop.after(d, lambda: self._coord_recv_2b(instance, 2, a, v))

    def _finalize(self, instance: int, ist: InstanceState, outcome: str) -> None:
        for (inst, value), res in self.results.items():
            if inst != instance or res.decide_time is not None:
                continue
            if value == ist.decided:
                res.decide_time = ist.decide_time
                res.outcome = outcome
            else:
                res.decide_time = ist.decide_time
                res.outcome = "aborted"

    # -- driver -----------------------------------------------------------------
    def run(self, until_ms: float = math.inf) -> List[InstanceResult]:
        self.loop.run(until=until_ms)
        return list(self.results.values())


# ---------------------------------------------------------------------------
# Workload generators (§6).
# ---------------------------------------------------------------------------

def conflict_free_workload(sim: FastPaxosSim, n_requests: int, rate_per_s: float,
                           seed: int = 1) -> None:
    """§6 Fig. 2a: steady stream, one instance per command (no conflicts)."""
    rng = random.Random(seed)
    t = 0.0
    mean_gap_ms = 1000.0 / rate_per_s
    for i in range(n_requests):
        t += rng.expovariate(1.0 / mean_gap_ms)
        sim.submit(t, instance=i, value=f"v{i}", proposer=i % 4)


def conflict_workload(sim: FastPaxosSim, n_requests: int, rate_per_s: float,
                      conflict_frac: float = 0.10, seed: int = 1) -> int:
    """§6 Fig. 2b/2c: ~conflict_frac of commands share an instance with the
    *next* command (two clients race for the same slot).  Returns the number
    of potential conflict pairs generated."""
    rng = random.Random(seed)
    t = 0.0
    mean_gap_ms = 1000.0 / rate_per_s
    inst = 0
    pairs = 0
    i = 0
    while i < n_requests:
        t += rng.expovariate(1.0 / mean_gap_ms)
        if rng.random() < conflict_frac and i + 1 < n_requests:
            gap = rng.expovariate(1.0 / mean_gap_ms)
            sim.submit(t, instance=inst, value=f"v{i}", proposer=0)
            sim.submit(t + gap, instance=inst, value=f"v{i + 1}", proposer=1)
            pairs += 1
            i += 2
            t += gap
        else:
            sim.submit(t, instance=inst, value=f"v{i}", proposer=i % 4)
            i += 1
        inst += 1
    return pairs


def latency_stats(results: Sequence[InstanceResult]) -> Dict[str, float]:
    lats = sorted(r.latency_ms for r in results
                  if r.latency_ms is not None and r.outcome in ("fast", "recovered"))
    if not lats:
        return {"count": 0}
    q = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]
    return {
        "count": len(lats),
        "mean_ms": sum(lats) / len(lats),
        "p50_ms": q(0.50),
        "p95_ms": q(0.95),
        "p99_ms": q(0.99),
        "max_ms": lats[-1],
    }
