"""Consensus-backed control plane for the training framework
(``repro.cluster.coordinator``, copied unchanged but for its imports).


``ConsensusLog`` is a replicated log whose every slot is decided by Fast
Flexible Paxos — the paper's technique as a first-class feature.  Training
hosts commit *cluster events* (checkpoint manifests, membership epochs,
data-pipeline cursors, straggler verdicts) leaderlessly on the fast path:
any host proposes directly to the acceptor group and the event commits after
one round trip to a **q2f** quorum (7 of 11 under the paper's headline
config, vs Fast Paxos' 9 of 11).  Collisions — two hosts proposing different
events for the same slot — are resolved by coordinated recovery exactly as
in ``repro_torch.core.protocol``; the loser's event is re-proposed on the
next slot.

Transport here is in-process and deterministic; delivery order and acceptor
failures are injectable so tests can force every conflict/recovery path.
The protocol state machines are the same ones validated by the TLC-lite
model checker.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.protocol import (ANY, Acceptor, Learner, Phase1b,
                                       Phase2a, Phase2b, RoundSystem,
                                       choose_value, pick_values)
from repro_torch.core.quorum import QuorumSpec


@dataclass
class SlotOutcome:
    slot: int
    value: Any
    fast: bool                 # decided on the fast path?
    recovered: bool            # went through coordinated recovery?
    votes: Dict[int, Any]      # acceptor -> round-1 vote (diagnostics)

    @property
    def outcome(self) -> str:
        return "fast" if self.fast else (
            "recovered" if self.recovered else "failed")


class ConsensusLog:
    """A replicated log; each slot is one Fast Flexible Paxos instance.

    Steady state mirrors §6: a stable coordinator has pre-executed phase-1
    with the ``any`` value for every slot, so proposals go straight to the
    acceptors (round 1, fast).  Recovery runs in round 2 (classic).
    """

    def __init__(self, spec: QuorumSpec, seed: int = 0) -> None:
        self.spec = spec.validate()
        self.rs = RoundSystem(spec, n_coordinators=1, fast_rounds="odd")
        self.rng = random.Random(seed)
        self.n = spec.n
        self.crashed: Set[int] = set()
        # acceptor round-1 vote per slot: slot -> {acc: value}
        self._votes: Dict[int, Dict[int, Any]] = {}
        self.decided: Dict[int, SlotOutcome] = {}
        self.next_slot = 0
        self.stats = {"fast": 0, "recovered": 0, "aborted_proposals": 0}

    # ------------------------------------------------------------------ api
    def crash(self, acc: int) -> None:
        self.crashed.add(acc)

    def recover_node(self, acc: int) -> None:
        self.crashed.discard(acc)

    def live(self) -> List[int]:
        return [a for a in range(self.n) if a not in self.crashed]

    def propose(self, value: Any, slot: Optional[int] = None) -> SlotOutcome:
        """Propose ``value`` on the fast path; returns the slot outcome (which
        may carry a *different* value if we lost a race for the slot)."""
        out = self.propose_racing([value], slot=slot)
        return out

    def propose_racing(self, values: Sequence[Any], slot: Optional[int] = None,
                       arrival_orders: Optional[Sequence[Sequence[int]]] = None
                       ) -> SlotOutcome:
        """Deliver several racing proposals for one slot.

        ``arrival_orders[i]`` is the order in which proposal i reaches the
        acceptors; interleaving is round-robin over proposals (deterministic,
        injectable) so tests can force exact vote splits.
        """
        s = self.next_slot if slot is None else slot
        if s in self.decided:
            self.stats["aborted_proposals"] += len(values)
            return self.decided[s]
        if slot is None:
            self.next_slot += 1

        votes = self._votes.setdefault(s, {})
        live = self.live()
        orders = (list(arrival_orders) if arrival_orders is not None
                  else [self.rng.sample(live, len(live)) for _ in values])
        # Round-robin interleaved delivery: proposal i's next acceptor, etc.
        idx = [0] * len(values)
        progressed = True
        while progressed:
            progressed = False
            for i, v in enumerate(values):
                if idx[i] < len(orders[i]):
                    a = orders[i][idx[i]]
                    idx[i] += 1
                    progressed = True
                    if a not in self.crashed and a not in votes:
                        votes[a] = v          # first proposal wins the vote

        outcome = self._learn(s, votes, values)
        if outcome is None:
            raise RuntimeError(
                f"slot {s}: no value can commit and recovery lacks a phase-1 "
                f"quorum ({len(votes)} < q1={self.spec.q1}) — cluster has "
                f"lost liveness; repair acceptors or reconfigure")
        self.decided[s] = outcome
        return outcome

    # ------------------------------------------------------------- internals
    def _learn(self, slot: int, votes: Dict[int, Any],
               proposed: Sequence[Any]) -> Optional[SlotOutcome]:
        learner = Learner(self.rs)
        decided = None
        for a, v in votes.items():
            decided = learner.on_phase2b(Phase2b(1, v, a)) or decided
        if decided is not None:
            self.stats["fast"] += 1
            return SlotOutcome(slot, decided, fast=True, recovered=False,
                               votes=dict(votes))
        # Coordinated recovery (round 2, classic): round-1 votes double as
        # round-2 phase-1b messages; pick per IsPickableVal; commit with q2c.
        if len(votes) < self.rs.q1(2):
            return None
        msgs = [Phase1b(2, 1, v, a) for a, v in votes.items()]
        picks = pick_values(self.rs, 2, msgs, set(proposed)) - {ANY}
        v = choose_value(picks)
        acks = [a for a in self.live()][: self.rs.q2(2)]
        if len(acks) < self.rs.q2(2):
            return None
        self.stats["recovered"] += 1
        return SlotOutcome(slot, v, fast=False, recovered=True,
                           votes=dict(votes))


# ---------------------------------------------------------------------------
# Typed control-plane records.
# ---------------------------------------------------------------------------

def _record(kind: str, **payload: Any) -> str:
    """Records are canonical JSON strings (hashable: consensus values must be)."""
    return json.dumps({"kind": kind, **payload}, sort_keys=True)


def _parse(rec: str) -> Dict[str, Any]:
    return json.loads(rec)


class ControlPlane:
    """Materialized view over a ``ConsensusLog`` with typed events.

    This is the single source of truth for the training cluster: checkpoint
    manifests, membership epochs, data cursors, and straggler verdicts all
    commit through the paper's fast path before any host acts on them.
    """

    def __init__(self, spec: QuorumSpec, seed: int = 0) -> None:
        self.log = ConsensusLog(spec, seed=seed)

    # -- checkpoints --------------------------------------------------------
    def commit_checkpoint(self, step: int, shards: Dict[str, str],
                          data_cursor: int, host: int = 0) -> SlotOutcome:
        rec = _record("checkpoint", step=step, shards=shards,
                      data_cursor=data_cursor, host=host)
        return self.log.propose(rec)

    def latest_checkpoint(self) -> Optional[Dict[str, Any]]:
        return self._latest("checkpoint")

    # -- membership ---------------------------------------------------------
    def commit_epoch(self, epoch: int, hosts: Sequence[int],
                     mesh_shape: Sequence[int], host: int = 0) -> SlotOutcome:
        rec = _record("epoch", epoch=epoch, hosts=sorted(hosts),
                      mesh_shape=list(mesh_shape), host=host)
        return self.log.propose(rec)

    def current_epoch(self) -> Optional[Dict[str, Any]]:
        return self._latest("epoch")

    # -- data pipeline cursors ----------------------------------------------
    def commit_cursor(self, step: int, cursor: int, host: int = 0) -> SlotOutcome:
        return self.log.propose(_record("cursor", step=step, cursor=cursor,
                                        host=host))

    def latest_cursor(self) -> Optional[Dict[str, Any]]:
        return self._latest("cursor")

    # -- straggler verdicts ---------------------------------------------------
    def commit_straggler_verdict(self, step: int, slow_hosts: Sequence[int],
                                 action: str, host: int = 0) -> SlotOutcome:
        return self.log.propose(_record("straggler", step=step,
                                        slow_hosts=sorted(slow_hosts),
                                        action=action, host=host))

    # -- generic -------------------------------------------------------------
    def _latest(self, kind: str) -> Optional[Dict[str, Any]]:
        best = None
        for slot in sorted(self.log.decided):
            rec = _parse(self.log.decided[slot].value)
            if rec["kind"] == kind:
                best = rec | {"slot": slot}
        return best

    def history(self) -> List[Dict[str, Any]]:
        return [_parse(self.log.decided[s].value) | {"slot": s}
                for s in sorted(self.log.decided)]
