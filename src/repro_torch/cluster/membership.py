"""Elastic cluster membership driven by consensus.

Membership changes (scale-up, scale-down, failure eviction) are *epochs*
committed through the Fast Flexible Paxos control plane.  Every epoch fixes:

* the live host set,
* the device mesh shape the trainer should build (largest (data, model) grid
  that fits the hosts, model axis preserved — elastic data parallelism),
* the quorum spec of the *acceptor group itself* when acceptors change,
  recomputed from the paper's Eqs. 13/14 so the relaxed intersection
  requirements hold at every size.

Hosts act on an epoch only after its commit — a host that misses the commit
keeps training on the old epoch until it observes the new one, and the
gradient all-reduce membership is keyed by epoch id so mixed-epoch steps
cannot silently aggregate.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.quorum import QuorumSpec, ffp_min_q2c, ffp_min_q2f

from .coordinator import ControlPlane


def quorum_policy(n: int) -> QuorumSpec:
    """The paper's §5 tradeoff applied as policy: spend a large phase-1
    quorum (rare) to buy the smallest valid phase-2 quorums (hot path).

    q1 = n - floor(n/4)   (tolerates n/4 crashes for recovery)
    q2f, q2c = minimal per Eqs. 14/13.
    """
    if n < 3:
        raise ValueError("need >= 3 acceptors")
    q1 = n - max(1, n // 4)
    return QuorumSpec(n, q1, ffp_min_q2c(n, q1), ffp_min_q2f(n, q1)).validate()


def plan_mesh(n_hosts: int, model_parallel: int, devices_per_host: int = 4
              ) -> Tuple[int, int]:
    """Largest (data, model) mesh for the host count; model axis fixed by the
    architecture's sharding needs, data axis absorbs elasticity."""
    total = n_hosts * devices_per_host
    if total < model_parallel:
        raise ValueError(f"{total} devices cannot host model_parallel={model_parallel}")
    return total // model_parallel, model_parallel


@dataclass
class MembershipEpoch:
    epoch: int
    hosts: Tuple[int, ...]
    mesh_shape: Tuple[int, int]
    quorums: QuorumSpec


class MembershipManager:
    """Drives epochs through the control plane and exposes the current view."""

    def __init__(self, plane: ControlPlane, initial_hosts: Sequence[int],
                 model_parallel: int = 16, devices_per_host: int = 4) -> None:
        self.plane = plane
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self._epoch = 0
        self.commit(sorted(initial_hosts))

    # ------------------------------------------------------------------ api
    def commit(self, hosts: Sequence[int]) -> MembershipEpoch:
        hosts = sorted(set(hosts))
        self._epoch += 1
        mesh = plan_mesh(len(hosts), self.model_parallel, self.devices_per_host)
        out = self.plane.commit_epoch(self._epoch, hosts, mesh)
        # The committed record is authoritative — a racing epoch proposal may
        # have won the slot; re-read the view.
        return self.current()

    def scale_up(self, new_hosts: Sequence[int]) -> MembershipEpoch:
        cur = self.current()
        return self.commit(list(cur.hosts) + list(new_hosts))

    def scale_down(self, remove: Sequence[int]) -> MembershipEpoch:
        cur = self.current()
        keep = [h for h in cur.hosts if h not in set(remove)]
        return self.commit(keep)

    def evict_failed(self, failed: Sequence[int]) -> MembershipEpoch:
        return self.scale_down(failed)

    def current(self) -> MembershipEpoch:
        rec = self.plane.current_epoch()
        assert rec is not None, "no membership epoch committed yet"
        hosts = tuple(rec["hosts"])
        n_acc = max(3, min(len(hosts), 11))   # acceptor group: <=11 hosts
        return MembershipEpoch(
            epoch=rec["epoch"],
            hosts=hosts,
            mesh_shape=tuple(rec["mesh_shape"]),
            quorums=quorum_policy(n_acc),
        )
