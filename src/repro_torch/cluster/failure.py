"""Failure detection and straggler mitigation for the training cluster.

* ``PhiAccrualDetector`` — the standard phi-accrual detector (Hayashibara et
  al.) over heartbeat inter-arrival times; hosts whose phi exceeds the
  threshold are *suspected* and proposed for eviction through the consensus
  control plane (the eviction itself is an epoch change, so all hosts agree
  on the survivor set before re-forming the mesh).

* ``StragglerPolicy`` — per-step host timing statistics; hosts slower than
  ``quantile + k * IQR`` for ``patience`` consecutive steps receive a
  consensus-committed verdict (``"demote"``: drop from the data-parallel
  group at the next epoch; ``"duplicate"``: backup-task its shard).  Using
  the *fast path* for verdicts means any host can raise one without routing
  through a leader — exactly the paper's leaderless-commit use case — and
  racing verdicts for the same step collapse to one decision via the
  collision-recovery path.
"""
from __future__ import annotations

import math
import statistics
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .coordinator import ControlPlane


class PhiAccrualDetector:
    """Phi-accrual failure detector over heartbeat arrival times."""

    def __init__(self, threshold: float = 8.0, window: int = 100,
                 min_std_ms: float = 5.0) -> None:
        self.threshold = threshold
        self.window = window
        self.min_std_ms = min_std_ms
        self._arrivals: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))
        self._last: Dict[int, float] = {}

    def heartbeat(self, host: int, t_ms: float) -> None:
        if host in self._last:
            self._arrivals[host].append(t_ms - self._last[host])
        self._last[host] = t_ms

    def phi(self, host: int, now_ms: float) -> float:
        if host not in self._last or len(self._arrivals[host]) < 2:
            return 0.0
        gaps = list(self._arrivals[host])
        mean = statistics.fmean(gaps)
        # Floor the std at 20% of the mean interval: perfectly regular
        # heartbeats would otherwise make any jitter look like death.
        std = max(statistics.pstdev(gaps), self.min_std_ms, 0.2 * mean)
        elapsed = now_ms - self._last[host]
        # phi = -log10 P(gap > elapsed) under Normal(mean, std)
        z = (elapsed - mean) / std
        p_later = 0.5 * math.erfc(z / math.sqrt(2.0))
        return -math.log10(max(p_later, 1e-300))

    def suspected(self, hosts: Sequence[int], now_ms: float) -> List[int]:
        return [h for h in hosts if self.phi(h, now_ms) > self.threshold]


@dataclass
class StragglerPolicy:
    """Quantile-gap straggler detection over per-host step durations."""

    plane: ControlPlane
    k_iqr: float = 3.0
    patience: int = 3
    _strikes: Dict[int, int] = field(default_factory=lambda: defaultdict(int))

    def observe_step(self, step: int, host_times_ms: Dict[int, float],
                     reporter: int = 0) -> Optional[List[int]]:
        """Feed one step's per-host durations; returns hosts verdicted slow
        (and commits the verdict through consensus), else None."""
        times = sorted(host_times_ms.values())
        if len(times) < 4:
            return None
        q1 = times[len(times) // 4]
        q3 = times[(3 * len(times)) // 4]
        cutoff = q3 + self.k_iqr * max(q3 - q1, 1e-6)
        slow = [h for h, t in host_times_ms.items() if t > cutoff]
        for h in host_times_ms:
            if h in slow:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
        verdicted = [h for h in slow if self._strikes[h] >= self.patience]
        if not verdicted:
            return None
        self.plane.commit_straggler_verdict(step, verdicted, action="demote",
                                            host=reporter)
        for h in verdicted:
            self._strikes[h] = 0
        return verdicted
