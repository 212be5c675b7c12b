"""Consensus-backed cluster control plane (``repro.cluster`` in the port).

Pure Python over ``repro_torch.core.protocol`` and ``core.quorum``: it runs
on the host and touches no device.  ``ControlPlane`` commits typed cluster
events through a Fast Flexible Paxos log (``ConsensusLog``);
``MembershipManager`` drives epochs through it; ``PhiAccrualDetector`` and
``StragglerPolicy`` raise evictions and verdicts.
"""
from .coordinator import ConsensusLog, ControlPlane
from .membership import MembershipEpoch, MembershipManager
from .failure import PhiAccrualDetector, StragglerPolicy

__all__ = [
    "ConsensusLog", "ControlPlane",
    "MembershipEpoch", "MembershipManager",
    "PhiAccrualDetector", "StragglerPolicy",
]
