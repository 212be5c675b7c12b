"""repro_torch.cluster: the twins of tests/test_cluster.py run against the
port's copy, and fixed-seed parity with the JAX package's repro.cluster.

The control plane is pure Python over the protocol core, so the same
sequence of proposals, races, crashes and membership changes must give
the same ``ControlPlane.history()`` and ``SlotOutcome``s in both packages.
"""
import dataclasses
import json

import pytest

from repro import cluster as jcluster
from repro.cluster import membership as jmembership
from repro.core.quorum import QuorumSpec as JQuorumSpec
from repro_torch import cluster as pcluster
from repro_torch.cluster import membership as pmembership
from repro_torch.cluster import (ConsensusLog, ControlPlane,
                                 MembershipManager, PhiAccrualDetector,
                                 StragglerPolicy)
from repro_torch.cluster.membership import plan_mesh, quorum_policy
from repro_torch.core.quorum import QuorumSpec

SPEC = QuorumSpec.paper_headline(11)


def test_fast_path_commit():
    log = ConsensusLog(SPEC, seed=0)
    out = log.propose("x")
    assert out.fast and out.value == "x" and out.slot == 0
    assert log.stats["fast"] == 1


def test_race_resolves_to_single_value():
    log = ConsensusLog(SPEC, seed=1)
    out = log.propose_racing(["a", "b"])
    assert out.value in ("a", "b")
    assert log.decided[out.slot].value == out.value


def test_forced_collision_recovery():
    log = ConsensusLog(SPEC, seed=2)
    # interleave arrivals so neither value reaches q2f=7 of 11:
    order_a = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10]
    order_b = list(reversed(order_a))
    out = log.propose_racing(["a", "b"], arrival_orders=[order_a, order_b])
    assert out.recovered and not out.fast
    assert out.value in ("a", "b")
    # round-robin interleave: a gets 0..4 + 5, b gets 10..6 -> 6/5 split < 7
    assert log.stats["recovered"] == 1


def test_slot_already_decided_aborts_later_proposals():
    log = ConsensusLog(SPEC, seed=3)
    out1 = log.propose("a", slot=5)
    out2 = log.propose("b", slot=5)
    assert out2.value == "a"
    assert log.stats["aborted_proposals"] == 1


def test_crash_tolerance_and_liveness_loss():
    log = ConsensusLog(SPEC, seed=4)
    for a in range(4):
        log.crash(a)                 # 7 live = exactly q2f
    out = log.propose("x")
    assert out.value == "x"
    log.crash(4)                     # 6 live < q2f AND < q1=9 -> stuck
    with pytest.raises(RuntimeError):
        log.propose("y")


def test_control_plane_records_and_views():
    cp = ControlPlane(SPEC, seed=0)
    cp.commit_checkpoint(10, {"dir": "/ckpt/a"}, data_cursor=10)
    cp.commit_cursor(11, 11)
    cp.commit_checkpoint(20, {"dir": "/ckpt/b"}, data_cursor=20)
    last = cp.latest_checkpoint()
    assert last["step"] == 20 and last["shards"]["dir"] == "/ckpt/b"
    assert cp.latest_cursor()["cursor"] == 11
    kinds = [h["kind"] for h in cp.history()]
    assert kinds == ["checkpoint", "cursor", "checkpoint"]


def test_membership_epochs_and_quorum_rescaling():
    cp = ControlPlane(SPEC, seed=0)
    mm = MembershipManager(cp, initial_hosts=range(8), model_parallel=16,
                           devices_per_host=4)
    e1 = mm.current()
    assert e1.mesh_shape == (2, 16)
    assert e1.quorums.is_valid()
    e2 = mm.scale_up(range(8, 16))
    assert e2.mesh_shape == (4, 16)
    assert e2.epoch == e1.epoch + 1
    e3 = mm.evict_failed([0, 1, 2, 3])
    assert e3.mesh_shape == (3, 16)
    assert len(e3.hosts) == 12
    # acceptor quorums always satisfy the paper's Eqs. 13/14
    for e in (e1, e2, e3):
        assert e.quorums.is_valid()


def test_quorum_policy_valid_across_sizes():
    for n in range(3, 40):
        assert quorum_policy(n).is_valid()


def test_plan_mesh():
    assert plan_mesh(8, 16, 4) == (2, 16)
    with pytest.raises(ValueError):
        plan_mesh(1, 16, 4)


def test_phi_accrual_detector():
    d = PhiAccrualDetector(threshold=8.0)
    for t in range(0, 2000, 100):
        d.heartbeat(1, float(t))
        d.heartbeat(2, float(t) + (t % 300) * 0.1)   # jittery but alive
    assert d.phi(1, 2050.0) < 8.0
    assert d.phi(1, 9000.0) > 8.0
    assert d.suspected([1, 2], 9000.0) == [1, 2]
    assert d.suspected([1, 2], 2050.0) == []


def test_straggler_policy_commits_verdict():
    cp = ControlPlane(SPEC, seed=0)
    sp = StragglerPolicy(cp, patience=3)
    verdicts = []
    for step in range(4):
        times = {h: 100.0 + h * 0.1 for h in range(8)}
        times[5] = 900.0
        v = sp.observe_step(step, times)
        if v:
            verdicts.append((step, v))
    assert verdicts == [(2, [5])]
    hist = cp.history()
    assert hist[-1]["kind"] == "straggler" and hist[-1]["slow_hosts"] == [5]


def test_straggler_transient_spike_not_verdicted():
    cp = ControlPlane(SPEC, seed=0)
    sp = StragglerPolicy(cp, patience=3)
    for step in range(6):
        times = {h: 100.0 for h in range(8)}
        if step == 2:
            times[4] = 900.0          # single spike
        assert sp.observe_step(step, times) is None


# ---------------------------------------------------------------------------
# Fixed-seed parity with the JAX package.
# ---------------------------------------------------------------------------

def _drive(pkg, spec, seed: int):
    """One scripted run of the control plane of ``pkg``: commits of every
    record kind, racing proposals (random and forced splits), crashes and
    recoveries, membership epochs and a straggler verdict.  Returns the
    history, every slot outcome and the log's counters."""
    cp = pkg.ControlPlane(spec, seed=seed)
    log = cp.log
    rec = lambda tag, v: json.dumps({"kind": "race", "tag": tag, "v": v})
    outs = [cp.commit_checkpoint(10, {"dir": "/ckpt/a"}, data_cursor=10)]
    outs.append(cp.commit_cursor(11, 11, host=2))
    for i in range(6):
        outs.append(log.propose_racing([rec(i, v) for v in "abc"]))
    order = list(range(spec.n))
    outs.append(log.propose_racing([rec("x", 0), rec("y", 1)],
                                   arrival_orders=[order, order[::-1]]))
    for a in (1, 6):
        log.crash(a)
    for i in range(4):
        outs.append(log.propose_racing([rec(f"c{i}", v) for v in "ab"]))
    log.recover_node(6)
    outs.append(log.propose(rec("late", 0), slot=40))
    outs.append(log.propose(rec("again", 1), slot=40))
    mm = pkg.MembershipManager(cp, initial_hosts=range(8),
                               model_parallel=16, devices_per_host=4)
    mm.scale_up(range(8, 12))
    mm.evict_failed([3])
    sp = pkg.StragglerPolicy(cp, patience=2)
    for step in range(3):
        times = {h: 100.0 + h for h in range(8)}
        times[6] = 700.0
        sp.observe_step(step, times, reporter=1)
    epoch = dataclasses.asdict(mm.current())
    return (cp.history(), [dataclasses.asdict(o) for o in outs],
            dict(log.stats), sorted(log.decided), epoch)


SPECS = {"paper_headline": lambda Q, m: Q.paper_headline(11),
         "fast_paxos": lambda Q, m: Q.fast_paxos(11),
         "quorum_policy": lambda Q, m: m.quorum_policy(11)}


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_fixed_seed_history_equals_jax(seed, spec):
    got = _drive(pcluster, SPECS[spec](QuorumSpec, pmembership), seed)
    want = _drive(jcluster, SPECS[spec](JQuorumSpec, jmembership), seed)
    assert got == want
    kinds = [h["kind"] for h in got[0]]
    assert {"checkpoint", "cursor", "race", "epoch",
            "straggler"} <= set(kinds)
    assert any(o["recovered"] for o in got[1])
