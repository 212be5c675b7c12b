"""The port's copies of the protocol core (repro_torch.core.protocol,
simulator, model_check) against the live JAX package's modules.

Both are pure Python over ``random.Random``, so they must agree exactly:
on the cases of tests/test_simulator.py the two ``FastPaxosSim``s give the
same results for the same seed (every instance's outcome, value, times and
recovery count), and on the cases of tests/test_model_check.py ``explore``
returns the same verdict, state count, violation and trace.  Exploration
is capped at 20,000 states a case (the BFS order is then compared up to the
cap) to keep each case within a few seconds; "flat_unsafe" finds its
violation only after about 258,000 states, so here it is compared as a
truncated run.
"""
import dataclasses

import pytest

from repro.core import model_check as jmc
from repro.core import quorum as jq
from repro.core import simulator as jsim
from repro_torch.core import model_check as pmc
from repro_torch.core import quorum as pq
from repro_torch.core import simulator as psim

MAX_STATES = 20_000


def _sim_run(sim_mod, q_mod, case):
    spec_fn, seed, kw, drive = case
    sim = sim_mod.FastPaxosSim(spec_fn(q_mod), seed=seed, **kw(sim_mod))
    drive(sim_mod, sim)
    res = sim.run()
    return ([dataclasses.astuple(r) for r in res], sim.recovery_entries,
            {i: s.decided for i, s in sim.instances.items()})


def _race_pair(sim_mod, sim):
    sim.submit(0.0, instance=0, value="A", proposer=0)
    sim.submit(0.05, instance=0, value="B", proposer=1)


def _races(k, pairs, delta=0.2):
    def drive(sim_mod, sim):
        t = 0.0
        for i in range(pairs):
            for p in range(k):
                sim.submit(t + p * delta, instance=i, value=f"v{i}_{p}",
                           proposer=p)
            t += 50.0
    return drive


FFP = lambda q: q.QuorumSpec.paper_headline(11)
FP = lambda q: q.QuorumSpec.fast_paxos(11)
NONE = lambda s: {}
SIM_CASES = {
    "conflict_free_ffp": (FFP, 1, NONE, lambda s, sim:
                          s.conflict_free_workload(sim, 500,
                                                   rate_per_s=1400)),
    "conflict_free_fp": (FP, 7, NONE, lambda s, sim:
                         s.conflict_free_workload(sim, 1500,
                                                  rate_per_s=1400)),
    "conflict_ffp": (FFP, 13, NONE, lambda s, sim: s.conflict_workload(
        sim, 1000, rate_per_s=2700, conflict_frac=0.10)),
    "conflict_fp": (FP, 13, NONE, lambda s, sim: s.conflict_workload(
        sim, 1000, rate_per_s=2700, conflict_frac=0.10)),
    "race_pair": (FFP, 3, NONE, _race_pair),
    "crashed_4": (FFP, 5, lambda s: {"crashed": [0, 1, 2, 3]},
                  lambda s, sim: s.conflict_free_workload(
                      sim, 200, rate_per_s=1000)),
    "crashed_5": (FFP, 5, lambda s: {"crashed": [0, 1, 2, 3, 4]},
                  lambda s, sim: sim.submit(0.0, instance=0, value="A")),
    "lossy": (FFP, 9, lambda s: {"latency": s.LatencyModel(loss_prob=0.05)},
              lambda s, sim: s.conflict_free_workload(
                  sim, 300, rate_per_s=500)),
    "uncoordinated_races": (FFP, 0, lambda s: {"recovery": "uncoordinated"},
                            _races(2, 300)),
    "grid_races": (lambda q: q.ExplicitQuorumSystem.grid(2), 0, NONE,
                   _races(3, 200)),
    "weighted_races": (lambda q: q.WeightedQuorumSystem(
        (2, 1, 1, 1, 1), 5, 2, 4), 4, NONE, _races(2, 300, 0.3)),
}


@pytest.mark.parametrize("name", sorted(SIM_CASES))
def test_simulator_results_equal_jax(name):
    case = SIM_CASES[name]
    got = _sim_run(psim, pq, case)
    want = _sim_run(jsim, jq, case)
    assert got == want
    assert got[0], "the case ran no instance"


def test_latency_stats_equal_jax():
    p = psim.FastPaxosSim(FP(pq), seed=2)
    j = jsim.FastPaxosSim(FP(jq), seed=2)
    psim.conflict_free_workload(p, 100, rate_per_s=1000)
    jsim.conflict_free_workload(j, 100, rate_per_s=1000)
    assert psim.latency_stats(p.run()) == jsim.latency_stats(j.run())


MC_CASES = {
    "valid_n3": (lambda q: q.QuorumSpec(3, 2, 2, 3), {}),
    "broken_eq14": (lambda q: q.QuorumSpec(3, 2, 2, 2), {}),
    "broken_eq13": (lambda q: q.QuorumSpec(3, 1, 2, 3),
                    {"fast_rounds": "none"}),
    "asymmetric_n4": (lambda q: q.QuorumSpec(4, 4, 1, 3), {}),
    "uncoordinated": (lambda q: q.QuorumSpec(3, 2, 2, 3),
                      {"max_round": 3, "uncoordinated": True}),
    "nontriviality": (lambda q: q.QuorumSpec(3, 3, 1, 3), {}),
    "relaxed_n4": (lambda q: sorted(q.all_relaxed_specs(4),
                                    key=lambda s: (s.q1, s.q2c, s.q2f))[0],
                   {}),
    "flat_unsafe": (lambda q: q.QuorumSpec(3, 1, 1, 3), {"max_round": 3}),
    "relaxed_safe": (lambda q: q.RelaxedQuorumSpec(3, 1, 1, 3),
                     {"max_round": 3}),
    "relaxed_uncoordinated": (lambda q: q.RelaxedQuorumSpec(3, 1, 1, 3),
                              {"max_round": 3, "fast_rounds": "odd",
                               "uncoordinated": True}),
    "guard_n4": (lambda q: q.QuorumSpec(4, 2, 3, 4),
                 {"max_round": 3, "uncoordinated": True}),
    "grid_n5": (lambda q: q.ExplicitQuorumSystem.grid(1).embed(5), {}),
    "weighted_n5": (lambda q: q.WeightedQuorumSystem((2, 1, 1, 1, 1), 5, 2,
                                                     4), {}),
}


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_explore_equals_jax(name):
    spec_fn, kw = MC_CASES[name]
    got = pmc.explore(spec_fn(pq), max_states=MAX_STATES, **kw)
    want = jmc.explore(spec_fn(jq), max_states=MAX_STATES, **kw)
    assert (got.ok, got.states, got.violation, got.trace, got.truncated) \
        == (want.ok, want.states, want.violation, want.trace,
            want.truncated)
    if name in ("broken_eq14", "broken_eq13"):
        assert not got.ok and got.violation == "Consistency" and got.trace
