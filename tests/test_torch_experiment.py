"""repro_torch.api (Experiment, Workload, Results) and
repro_torch.montecarlo.scenarios against the live JAX package (repro.api).

Configs are compared exactly (every ``Workload`` constructor's
``to_dict``, both committed scenario JSONs).  The Monte-Carlo backend is
held bit for bit on JAX's draws (``test_torch_engine.inject_jax_draws``;
the port's split keys ``rng.SPLIT_DOMAIN`` map to ``jax.random.split``):
decide bits, winners and latencies equal, summaries to 1e-6 relative (f32
means and interpolated quantiles).  The DES and model-check backends are
pure Python and equal JAX's exactly.  On the port's own draws, Monte-Carlo
and DES agree within 5% on p50 and 0.05 on P(recovery), as
tests/test_sim_cross_validation.py holds the JAX package.
"""
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import quorum as jq
from repro.montecarlo import latency as jlat
from repro.montecarlo import regimes as jreg
from repro.montecarlo import scenarios as jscen
from repro_torch import api
from repro_torch.core import quorum as pq
from repro_torch.montecarlo import latency, regimes, rng, scenarios
from repro_torch.montecarlo.regimes import RegimeStreamSummary
from test_torch_engine import inject_jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples", "scenarios")
CONFIGS = ["diurnal_wan.json", "trace_replay.json"]


def systems(q):
    """The n=5 batch of tests/test_experiment.py, in either package."""
    return [q.QuorumSpec(5, 4, 2, 4), q.ExplicitQuorumSystem.grid(1).embed(5),
            q.WeightedQuorumSystem((2, 1, 1, 1, 1), 5, 2, 4)]


def split_keys(seed: int) -> dict:
    """Port key -> JAX key for an experiment seed and its two split keys."""
    k = jax.random.PRNGKey(seed)
    k_race, k_free = jax.random.split(k)
    root = rng.root(seed)
    return {root: k,
            rng.derive(root, rng.SPLIT_DOMAIN, rng.RACE_SPLIT): k_race,
            rng.derive(root, rng.SPLIT_DOMAIN, rng.FREE_SPLIT): k_free}


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

def _workloads(W, lat, reg):
    trace = {"kind": "empirical", "n_quantiles": 16,
             "trace_ms": [0.3, 0.31, 0.35, 0.5, 0.9, 1.4]}
    return [W.conflict_free(), W.race(), W.race(k=3, delta_ms=0.2),
            W.mixed(conflict_frac=0.3, delta_ms=0.25, k=3), W.wan(),
            W.wan(k=3, inter_region_ms=55.0, n_regions=4, delta_ms=1.0),
            W.lossy(loss_prob=0.02), W.race(delay=lat.ParetoDelay(
                scale_ms=0.8)),
            W.race(delay=trace), W.race(recovery="uncoordinated"),
            W.race(regimes=reg.gray_failure(11, epoch_trials=1024)),
            W.lossy(loss_prob=0.01, delay=lat.ShiftedLognormalDelay(
                0.3, -1.0, 0.5), des_requests=300)]


def test_every_workload_to_dict_equals_jax():
    got = _workloads(api.Workload, latency, regimes)
    want = _workloads(japi.Workload, jlat, jreg)
    for g, w in zip(got, want):
        d = g.to_dict()
        assert json.loads(json.dumps(d)) == json.loads(json.dumps(
            w.to_dict()))
        back = api.Workload.from_dict(json.loads(json.dumps(d)))
        assert back.to_dict() == d


def test_workload_from_dict_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="unknown workload kind"):
        api.Workload.from_dict({"kind": "storm"})
    with pytest.raises(ValueError, match="unknown workload key"):
        api.Workload.from_dict({"k_proposers": 2, "delta": 1})
    with pytest.raises(ValueError, match="unknown delay kind"):
        api.Workload.from_dict({"kind": "race", "delay": {
            "kind": "lossy", "inner": {"kind": "gamma"}}})
    with pytest.raises(ValueError, match="recovery"):
        api.Workload.race(recovery="eager")


@pytest.mark.parametrize("name", CONFIGS)
def test_committed_configs_load_unchanged_and_stream(name):
    path = os.path.join(EXAMPLES, name)
    exp = api.Experiment.from_config(path, device="cpu")
    ref = japi.Experiment.from_config(path)
    assert exp.labels == ref.labels
    assert exp.workload.to_dict() == ref.workload.to_dict()
    assert exp.workload.regimes_for(exp.n).to_config() == \
        ref.workload.regimes_for(ref.n).to_config()
    assert latency.delay_to_config(exp.workload.delay_for(exp.n)) == \
        jlat.delay_to_config(ref.workload.delay_for(ref.n))
    assert (exp.trials, exp.chunk, exp.seed) == (10 ** 6, 16384,
                                                 ref.seed)
    r = dataclasses.replace(exp, trials=20_000, chunk=8_192).run(
        "montecarlo")
    assert isinstance(r.stream, RegimeStreamSummary)
    assert int(r.stream.occupancy.sum()) == 20_000
    assert r.stream.n_trials.tolist() == [20_000] * len(exp.systems)
    for k, v in r.summary.items():
        assert tuple(v.shape) == (len(exp.systems),), k
        assert v.device.type == "cpu"
    assert all(isinstance(x, float) for x in r.to_dict().values())


def test_from_config_takes_shard_and_use_kernel():
    """Both keys of the JAX package's Experiment load, with either value,
    in both packages; on one domain the run equals the one without the
    key (``shard=True`` warns there and streams unsharded, as in JAX)."""
    base = {"systems": [{"kind": "cardinality", "n": 5, "q1": 4, "q2c": 2,
                         "q2f": 4}], "trials": 3_000, "chunk": 1_024,
            "seed": 3}
    plain = api.Experiment.from_config(base, device="cpu")
    assert plain.shard is True
    with pytest.warns(UserWarning, match="only 1 device"):
        want = plain.run("montecarlo").stream
    for key in ("use_kernel", "shard"):
        for val in (False, True):
            cfg = {**base, key: val}
            exp = api.Experiment.from_config(cfg, device="cpu")
            assert getattr(japi.Experiment.from_config(cfg), key) is val
            if key == "shard":
                assert exp.shard is val
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                got = exp.run("montecarlo").stream
            for f in ("n_trials", "n_fast", "n_recovery", "n_undecided",
                      "hist", "max_ms", "mean_ms"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_system_from_config_equals_jax():
    cfgs = [{"kind": "cardinality", "preset": "paper_headline", "n": 11},
            {"kind": "cardinality", "n": 7, "q1": 5, "q2c": 3, "q2f": 5},
            {"kind": "relaxed", "n": 11, "q1": 5, "q2c": 2, "q2f": 9},
            {"kind": "grid", "cols": 4, "rows": 3, "n": 12},
            {"kind": "weighted", "weights": [2, 2, 1, 1, 1], "t1": 6,
             "t2c": 2, "t2f": 5}]
    for c in cfgs:
        p, j = api.system_from_config(c), japi.experiment.system_from_config(c)
        assert type(p).__name__ == type(j).__name__
        pm, jm = p.to_masks(), j.to_masks()
        assert pm.label == jm.label
        for k in ("p1_w", "p1_t", "p2c_w", "p2c_t", "p2f_w", "p2f_t"):
            np.testing.assert_array_equal(np.asarray(getattr(pm, k)),
                                          np.asarray(getattr(jm, k)))
    with pytest.raises(ValueError, match="unknown system kind"):
        api.system_from_config({"kind": "pyramid"})


def test_scenario_builders_equal_jax():
    for pb, jb in ((scenarios.grid_wan(crashed=(0, 1, 2)),
                    jscen.grid_wan(crashed=(0, 1, 2))),
                   (scenarios.weighted_acceptors(crashed=(0,)),
                    jscen.weighted_acceptors(crashed=(0,)))):
        (ps, pm), (js, jm) = pb, jb
        assert (ps.name, ps.n, ps.k_proposers) == (js.name, js.n,
                                                   js.k_proposers)
        np.testing.assert_array_equal(ps.offsets_ms.numpy(),
                                      np.asarray(js.offsets_ms))
        assert latency.delay_to_config(ps.delay) == \
            jlat.delay_to_config(js.delay)
        np.testing.assert_array_equal(np.asarray(pm.p2f_w),
                                      np.asarray(jm.p2f_w))
    for p, j in ((scenarios.wan(), jscen.wan()),
                 (scenarios.lossy_acceptors(0.05),
                  jscen.lossy_acceptors(0.05)),
                 (scenarios.mixed_workload(0.2, 0.3, 3),
                  jscen.mixed_workload(0.2, 0.3, 3)),
                 (scenarios.conflict_free(7), jscen.conflict_free(7))):
        assert (p.name, p.n, p.k_proposers, p.conflict_frac) == \
            (j.name, j.n, j.k_proposers, j.conflict_frac)
        np.testing.assert_array_equal(p.offsets_ms.numpy(),
                                      np.asarray(j.offsets_ms))
        assert latency.delay_to_config(p.delay) == \
            jlat.delay_to_config(j.delay)
    spec = scenarios.RunSpec().merged(trials=10, chunk=None)
    assert (spec.trials, spec.chunk) == (10, None)
    with pytest.raises(ValueError, match="2 proposers"):
        scenarios.k_way_race(1)


# ---------------------------------------------------------------------------
# The Monte-Carlo backend: bit for bit on JAX's draws.
# ---------------------------------------------------------------------------

MC_CASES = {
    "race": (lambda W: W.race(k=2, delta_ms=0.3), (), None),
    "mixed": (lambda W: W.mixed(conflict_frac=0.4, delta_ms=0.2, k=3), (),
              None),
    "conflict_free": (lambda W: W.conflict_free(), (), None),
    "faults": (lambda W: W.race(k=2, delta_ms=0.2), (1,), (1,)),
    "uncoordinated": (lambda W: W.race(k=2, delta_ms=0.2,
                                       recovery="uncoordinated"), (), None),
}


@pytest.mark.parametrize("name", sorted(MC_CASES))
@pytest.mark.parametrize("card", [True, False], ids=["card", "masked"])
def test_montecarlo_bit_identical_on_jax_draws(monkeypatch, name, card):
    wl, faults, crashed = MC_CASES[name]
    pick = (lambda q: [q.QuorumSpec(5, 4, 2, 4), q.QuorumSpec(5, 5, 1, 4)]) \
        if card else systems
    jdelay = jlat.default_delay()
    if crashed:
        m = np.zeros(5, bool)
        m[list(crashed)] = True
        jdelay = jlat.CrashedDelay(jdelay, jnp.asarray(m))
    inject_jax_draws(monkeypatch, split_keys(4), jdelay)
    exp = api.Experiment(systems=pick(pq), workload=wl(api.Workload),
                         faults=faults, samples=3000, seed=4, device="cpu")
    ref = japi.Experiment(systems=pick(jq), workload=wl(japi.Workload),
                          faults=faults, samples=3000, seed=4)
    assert ("q" in exp.lower()) == card
    got, want = exp.run("montecarlo"), ref.run("montecarlo")
    assert got.labels == want.labels
    assert got.fault_tolerance == want.fault_tolerance
    assert set(got.raw) == set(want.raw)
    for f in want.raw:
        np.testing.assert_array_equal(got.raw[f].numpy(),
                                      np.asarray(want.raw[f]), err_msg=f)
    assert set(got.summary) == set(want.summary)
    for k in want.summary:
        np.testing.assert_allclose(got.summary[k].numpy(),
                                   np.asarray(want.summary[k]), rtol=1e-6,
                                   err_msg=k)
    assert got.to_dict().keys() == want.to_dict().keys()


def test_streamed_montecarlo_counts_equal_jax_on_jax_draws(monkeypatch):
    """The streamed backend on JAX's chunk draws: counts and maxima
    equal (histograms are held by tests/test_torch_streaming.py)."""
    trials, chunk = 5000, 2048
    keys = split_keys(2)
    for k, jk in list(keys.items()):
        for i in range(-(-trials // chunk)):
            keys[rng.derive(k, rng.CHUNK_DOMAIN, i)] = jax.random.fold_in(
                jk, i)
    inject_jax_draws(monkeypatch, keys)
    kw = dict(trials=trials, chunk=chunk, seed=2,
              compute_fault_tolerance=False)
    for pick in (systems, lambda q: [q.QuorumSpec(5, 4, 2, 4)]):
        exp = api.Experiment(systems=pick(pq), device="cpu", workload=(
            api.Workload.mixed(conflict_frac=0.5, delta_ms=0.3)), **kw)
        ref = japi.Experiment(systems=pick(jq), shard=False, workload=(
            japi.Workload.mixed(conflict_frac=0.5, delta_ms=0.3)), **kw)
        got, want = exp.run("montecarlo"), ref.run("montecarlo")
        assert got.raw is None and got.stream is not None
        for f in ("n_trials", "n_fast", "n_recovery", "n_undecided",
                  "max_ms"):
            np.testing.assert_array_equal(
                getattr(got.stream, f).numpy(),
                np.asarray(getattr(want.stream, f)), err_msg=f)
        assert set(got.summary) == set(want.summary)


# ---------------------------------------------------------------------------
# DES and model checker: exactly JAX's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", [(), (0, 1)])
def test_des_and_modelcheck_equal_jax(faults):
    def run(W, q, E):
        exp = E(systems=systems(q), faults=faults, max_states=10_000,
                workload=W.mixed(conflict_frac=0.5, delta_ms=0.3,
                                 des_requests=200))
        return [exp.run("des"), exp.run("modelcheck")]

    got = run(api.Workload, pq, api.Experiment)
    want = run(japi.Workload, jq, japi.Experiment)
    for g, w in zip(got, want):
        assert g.backend == w.backend and g.labels == w.labels
        np.testing.assert_equal(g.summary, w.summary)    # NaN == NaN
        assert g.fault_tolerance == w.fault_tolerance
        assert g.safety == w.safety
        np.testing.assert_equal(g.to_dict(), w.to_dict())
    if faults:
        assert got[0].summary["undecided_rate"][0] == 1.0


def test_montecarlo_and_des_agree():
    exp = api.Experiment(systems=systems(pq),
                         workload=api.Workload.race(k=2, delta_ms=0.3),
                         samples=20_000, device="cpu")
    res = api.sweep(exp, ("montecarlo", "des"))
    mc, des = res["montecarlo"], res["des"]
    for i in range(3):
        p50_mc = float(mc.summary["p50_ms"][i])
        p50_des = des.summary["p50_ms"][i]
        assert abs(p50_mc - p50_des) / p50_des < 0.05, (i, p50_mc, p50_des)
        rec_mc = float(mc.summary["recovery_rate"][i])
        assert abs(rec_mc - des.summary["recovery_rate"][i]) < 0.05
    assert mc.fault_tolerance == des.fault_tolerance


def test_guardrails():
    with pytest.raises(ValueError, match="backend"):
        api.Experiment(systems=systems(pq), backend="paxi")
    with pytest.raises(ValueError, match="n<=5"):
        api.Experiment(systems=[pq.QuorumSpec.paper_headline(11)]).run(
            "modelcheck")
    with pytest.raises(ValueError, match="montecarlo backend"):
        api.Experiment(systems=systems(pq), workload=api.Workload.wan(),
                       device="cpu").run("des")
    masks = pq.ExplicitQuorumSystem.grid(1).to_masks().embed(5)
    with pytest.raises(ValueError, match="montecarlo"):
        api.Experiment(systems=[masks]).run("des")
    with pytest.raises(ValueError, match="trials"):
        api.Experiment(systems=systems(pq), trials=0)
    dup = api.Experiment(systems=[pq.QuorumSpec(5, 4, 2, 4)] * 2)
    assert len(set(dup.labels)) == 2


def test_plan_answers_on_the_cpu():
    """The planner's three entry points answer on the experiment's device.
    tests/test_torch_planner.py holds them to JAX."""
    from repro_torch.planner import PlanResult, Planner
    exp = api.Experiment(systems=systems(pq), chunk=1_024, device="cpu")
    for r in (exp.plan(trials=3_000),
              api.plan(n=5, trials=3_000, chunk=1_024, device="cpu")):
        assert isinstance(r, PlanResult) and r.ok and r.frontier_labels
    assert isinstance(api.experiment.default_planner("cpu"), Planner)


def test_frontier_runs_with_regimes_on_cpu():
    exp = api.Experiment.from_config(os.path.join(EXAMPLES, CONFIGS[1]),
                                     device="cpu")
    fr = exp.frontier(trials=10_000)
    assert fr.labels == exp.labels
    assert isinstance(fr.streams["race"], RegimeStreamSummary)
    assert np.isfinite(fr.values[:, :3]).all()


# ---------------------------------------------------------------------------
# python -m repro_torch.api
# ---------------------------------------------------------------------------

def _api(*args, **env):
    e = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch.api", *args],
                          cwd=ROOT, env=e, capture_output=True, text=True,
                          timeout=600)


def test_api_main_smoke_on_cpu_and_refusal_without_device():
    proc = _api("--smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "api OK"
    for b in ("montecarlo", "des", "modelcheck"):
        assert sum(ln.startswith(f"[{b}] ") for ln in lines) == 4, b
    proc = _api("--smoke", "--config",
                os.path.join(EXAMPLES, CONFIGS[0]), "--device", "cpu")
    assert proc.returncode == 0 and proc.stdout.endswith("api OK\n"), \
        proc.stderr
    proc = _api("--smoke", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and "api OK" not in proc.stdout
