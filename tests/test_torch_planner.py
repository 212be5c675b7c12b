"""repro_torch.planner against the live JAX package (repro.planner).

Four layers, as tests/test_planner.py has them:

  * the pure-numpy search code (``default_schedule``, the noise margins,
    ``prune_survivors``, ``successive_halving`` with an injected scorer)
    equals JAX's exactly on the same inputs;
  * ``engine_key`` equals JAX's field by field (but for the device field,
    which replaces ``use_kernel``), and ``_delay_token`` tells delay models
    apart by content;
  * ``Planner._recommend`` of both packages, given the same frontier
    values and race quantiles, returns the same ``PlanResult`` but for
    ``wall_s``, ``cold`` and ``engine_compiles``;
  * the port's own engine cache, search, planner and server on the CPU
    (the kernels' plain versions), with JAX's ``query_server`` as the
    client of the port's ``PlannerServer``.

Small sizes throughout: n=7, the schedule ((2000, 2.0), (20000, 2.0)),
chunk 4096.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from repro.frontier import families as jfam
from repro.frontier import pareto as jpareto
from repro.frontier import score as jscore
from repro.montecarlo import engine as jengine
from repro.montecarlo import regimes as jreg
from repro.planner import cache as jcache
from repro.planner import service as jservice
from repro_torch import api
from repro_torch.core.quorum import QuorumSpec
from repro_torch.frontier import families, pareto
from repro_torch.frontier import score as pscore
from repro_torch.frontier.score import default_axes, score_systems
from repro_torch.kernels.quorum_tally import ops as qt_ops
from repro_torch.montecarlo import engine, latency, regimes, traces
from repro_torch.planner import (EngineCache, PlanQuery, Planner,
                                 PlannerServer, Rung, default_schedule,
                                 engine_key, prune_survivors, search,
                                 successive_halving)
from repro_torch.planner import cache
from repro_torch.parallel.sharding import trial_mesh

# the packages export a function ``search`` that shadows the module's name
jsearch = importlib.import_module("repro.planner.search")
psearch = importlib.import_module("repro_torch.planner.search")
CPU = "cpu"
SMALL = dict(n=7, chunk=4_096, seed=0, device=CPU)
SMALL_SCHEDULE = ((2_000, 2.0), (20_000, 2.0))


# ---------------------------------------------------------------------------
# The pure-numpy search code equals JAX's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eta", [2, 3, 10, 100])
@pytest.mark.parametrize("final", [1, 5_000, 10_000, 99_999, 123_457,
                                   1_000_000, 10_000_000])
def test_default_schedule_equals_jax(final, eta):
    for min_trials in (1, 1_000, 10_000):
        for slack in (0.5, 1.0, 2.0):
            got = default_schedule(final, eta=eta, min_trials=min_trials,
                                   slack=slack)
            want = jsearch.default_schedule(final, eta=eta,
                                            min_trials=min_trials,
                                            slack=slack)
            assert [(r.trials, r.slack) for r in got] == \
                [(r.trials, r.slack) for r in want]


def test_margins_equal_jax():
    for slack in (0.25, 0.5, 1.0, 2.0, 3.5):
        for trials in (1, 7, 1_000, 20_000, 123_457, 10 ** 6, 10 ** 7):
            assert psearch.rate_margin(slack, trials) == \
                jsearch.rate_margin(slack, trials)
            for tail in (0.5, 0.1, 0.001, 1e-4, 1e-9):
                assert psearch.quantile_margin_cells(slack, trials, tail) \
                    == jsearch.quantile_margin_cells(slack, trials, tail)
    assert psearch.STOCHASTIC_AXES == jsearch.STOCHASTIC_AXES
    assert psearch.DEFAULT_SLACK == jsearch.DEFAULT_SLACK


def _random_values(seed: int, m: int = 40) -> np.ndarray:
    """Seeded (M, 6) frontier values with NaNs, ties and duplicate rows:
    latencies on a coarse grid (exact ties), rates in steps of 1/64,
    integral crash budgets."""
    r = np.random.default_rng(seed)
    v = np.empty((m, 6))
    v[:, 0] = 1.0 + r.integers(0, 6, m) * 0.01
    v[:, 1] = 2.0 + r.integers(0, 8, m) * 0.05
    v[:, 2] = r.integers(0, 16, m) / 64.0
    v[:, 3:] = r.integers(0, 4, (m, 3))
    v[r.random(m) < 0.1, 0] = np.nan
    v[r.random(m) < 0.1, 1] = np.nan
    dup = r.integers(0, m, m // 5)
    v[r.integers(0, m, m // 5)] = v[dup]
    return v


@pytest.mark.parametrize("seed", range(6))
def test_prune_survivors_equals_jax(seed):
    vals = _random_values(seed)
    for trials in (1_000, 20_000, 10 ** 6):
        for slack in (0.05, 0.5, 2.0):
            p_axes = default_axes(precision=0.01, trials=trials)
            j_axes = jscore.default_axes(precision=0.01, trials=trials)
            got = prune_survivors(vals, p_axes, Rung(trials, slack))
            want = jsearch.prune_survivors(vals, j_axes,
                                           jsearch.Rung(trials, slack))
            np.testing.assert_array_equal(got, want)
    # a survivor set that actually prunes: the check is not vacuous
    keep = prune_survivors(vals, default_axes(0.01, 10 ** 6),
                           Rung(10 ** 6, 0.05))
    assert 0 < keep.sum() < len(vals)


@dataclasses.dataclass
class _Fake:
    """A FrontierResult-shaped scorer output for one package."""
    labels: tuple
    axes: tuple
    values: np.ndarray
    mask_fn: object

    @property
    def mask(self):
        return self.mask_fn(self.values, self.axes)

    @property
    def frontier_labels(self):
        return tuple(l for l, m in zip(self.labels, self.mask) if m)


def _synthetic_scorer(axes, mask_fn, log):
    """Deterministic values per (member, trials): a member's truth plus
    noise shrinking with the trial count, seeded by both."""
    def scorer(alive, trials):
        rows = []
        for mbr in alive:
            r = np.random.default_rng(1_000_003 * mbr + trials)
            noise = 1.0 / math.sqrt(trials)
            rows.append([1.0 + (mbr % 7) * 0.03 + r.normal() * noise,
                         2.0 + (mbr % 5) * 0.1 + r.normal() * noise,
                         (mbr % 11) / 40.0 + abs(r.normal()) * noise,
                         mbr % 3, mbr % 4, (mbr // 3) % 3])
        log.append((trials, tuple(alive)))
        return _Fake(tuple(f"s{m}" for m in alive), axes,
                     np.array(rows, np.float64), mask_fn)
    return scorer


@pytest.mark.parametrize("ladder", [(2_000, 20_000), (500, 5_000, 50_000),
                                    (100, 1_000, 10_000, 100_000)])
def test_successive_halving_equals_jax(ladder):
    members = list(range(60))
    sched_p = [Rung(t, 0.5) for t in ladder]
    sched_j = [jsearch.Rung(t, 0.5) for t in ladder]
    log_p, log_j = [], []
    got = successive_halving(members, sched_p, _synthetic_scorer(
        default_axes(0.01, ladder[-1]), pareto.pareto_mask, log_p))
    want = jsearch.successive_halving(members, sched_j, _synthetic_scorer(
        jscore.default_axes(0.01, ladder[-1]), jpareto.pareto_mask, log_j))
    assert log_p == log_j
    assert got.members == want.members
    assert got.frontier_labels == want.frontier_labels
    strip = lambda r: {k: v for k, v in r.to_dict().items() if k != "wall_s"}
    assert [strip(r) for r in got.rungs] == [strip(r) for r in want.rungs]
    assert (got.scored_trials, got.exhaustive_trials) == \
        (want.scored_trials, want.exhaustive_trials)
    assert got.budget_fraction == want.budget_fraction
    assert got.rungs[0].n_survivors < len(members)


def test_successive_halving_rejects_bad_schedules():
    with pytest.raises(ValueError):
        successive_halving(["a"], [], lambda m, t: None)
    with pytest.raises(ValueError):
        successive_halving(["a"], [Rung(100), Rung(100)], lambda m, t: None)
    with pytest.raises(ValueError):
        successive_halving([], [Rung(100)], lambda m, t: None)
    with pytest.raises(ValueError):
        Rung(0)
    with pytest.raises(ValueError):
        Rung(100, slack=0.0)


# ---------------------------------------------------------------------------
# engine_key and _delay_token.
# ---------------------------------------------------------------------------

def _tables(family: str, n: int):
    """Both packages' mask tables of ``family`` at n, members embedded into
    n as the scorer embeds them."""
    p = engine.build_mask_table(
        pscore._as_masks(families.family(family, n), n)[0], device=CPU)
    j = jengine.build_mask_table(
        jscore._as_masks(jfam.family(family, n), n)[0])
    return p, j


KEY_CASES = [
    # (family, n, trials, chunk, k_max, regimes, recovery)
    ("cardinality", 7, 50_000, 4_096, "auto", False, "coordinated"),
    ("cardinality", 7, 52_000, 4_096, "auto", False, "coordinated"),
    ("cardinality", 7, 1_000, 4_096, "auto", False, "coordinated"),
    ("cardinality", 7, 50_000, 4_096, "auto", False, "uncoordinated"),
    ("cardinality", 7, 50_000, 4_096, None, False, "coordinated"),
    ("cardinality", 7, 50_000, 4_096, (7, 7, 7), False, "coordinated"),
    ("weighted", 7, 30_000, 4_096, "auto", False, "coordinated"),
    ("grid", 9, 30_000, 8_192, "auto", False, "uncoordinated"),
    ("weighted", 7, 1_000, 4_096, "auto", True, "coordinated"),
    ("cardinality", 7, 30_000, 4_096, "auto", True, "uncoordinated"),
]


@pytest.mark.parametrize("case", KEY_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_engine_key_equals_jax(case):
    family, n, trials, chunk, k_max, with_regimes, recovery = case
    p_table, j_table = _tables(family, n)
    p_reg = regimes.gray_failure(n, epoch_trials=1024) if with_regimes \
        else None
    j_reg = jreg.gray_failure(n, epoch_trials=1024) if with_regimes \
        else None
    got = engine_key(p_table, n=n, k_proposers=2, trials=trials,
                     chunk=chunk, precision=0.01, k_max=k_max,
                     regimes=p_reg, recovery=recovery)
    want = jcache.engine_key(j_table, n=n, k_proposers=2, trials=trials,
                             chunk=chunk, precision=0.01, shard=False,
                             use_kernel=False, k_max=k_max, regimes=j_reg,
                             recovery=recovery)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name if f.name != "use_kernel" else "device"
                     for f in dataclasses.fields(want)]
    for f in names:
        if f != "device":
            assert getattr(got, f) == getattr(want, f), f
    assert got.device == CPU


def test_engine_key_modes_and_shared_chunk_count():
    table = _tables("cardinality", 7)[0]
    kw = dict(n=7, k_proposers=2, chunk=4_096, precision=0.01,
              k_max="auto")
    streamed = engine_key(table, trials=50_000, **kw)
    assert streamed.mode == "stream" and streamed.layout_pairs > 0
    assert streamed.n_chunks == -(-50_000 // 4_096)
    mat = engine_key(table, trials=1_000, **kw)
    assert mat.mode == "materialize" and mat.n_chunks == 1_000
    assert engine_key(table, trials=52_000, **kw) == streamed
    assert streamed.table_sig[0] == ("p1_t", (len(families.family(
        "cardinality", 7)), 1), "float32")
    # shard: ndev is the domain count the query runs on (1 on one domain,
    # D on an explicit D-domain mesh), a sharded key counts one domain's
    # chunks and never materializes -- JAX's key, mesh for mesh.
    j_table = _tables("cardinality", 7)[1]
    jkw = dict(kw, use_kernel=False)
    for shard, ndev in ((True, 1), (trial_mesh(CPU, domains=3), 3),
                        (trial_mesh(CPU, domains=1), 1)):
        for trials in (50_000, 1_000):
            got = engine_key(table, trials=trials, shard=shard, **kw)
            want = jcache.engine_key(j_table, trials=trials, shard=shard,
                                     **jkw)
            assert got.ndev == ndev
            for f in dataclasses.fields(got):
                if f.name != "device":
                    assert getattr(got, f.name) == getattr(want, f.name)
    sharded = engine_key(table, trials=50_000,
                         shard=trial_mesh(CPU, domains=3), **kw)
    assert sharded.n_chunks == -(-(-(-50_000 // 3)) // 4_096)
    assert engine_key(table, trials=1_000, shard=trial_mesh(
        CPU, domains=3), **kw).mode == "stream"


def _delay_pairs(n: int = 7):
    """Per delay kind (and the regime chain): a factory of a model from
    one parameter, so equal parameters build equal contents."""
    wan = lambda x: latency.WanDelay.symmetric(x, n, 2, 3)
    trace = lambda x: traces.EmpiricalDelay.from_trace(
        [0.3, 0.31, 0.35, 0.5, 0.9, x], n_quantiles=16)
    crashed = lambda x: latency.CrashedDelay(
        latency.ShiftedLognormalDelay(),
        latency.crash_mask(n, [0, 3] if x == 1.0 else [0, 4]))
    return {
        "lognormal": lambda x: latency.ShiftedLognormalDelay(base_ms=x),
        "pareto": lambda x: latency.ParetoDelay(alpha=2.0 + x),
        "wan": wan,
        "lossy": lambda x: latency.LossyDelay(wan(30.0), loss_prob=x / 100),
        "crashed": crashed,
        "empirical": trace,
        "regimes": lambda x: regimes.gray_failure(n, loss_prob=x / 50),
    }


@pytest.mark.parametrize("kind", ["lognormal", "pareto", "wan", "lossy",
                                  "crashed", "empirical", "regimes"])
def test_delay_token_follows_content(kind):
    make = _delay_pairs()[kind]
    a, b, c = make(1.0), make(1.0), make(2.0)
    assert cache._delay_token(a) == cache._delay_token(b)
    assert cache._delay_token(a) != cache._delay_token(c)
    assert cache._delay_token(None) == b"default"
    assert cache._delay_token(a) != cache._delay_token(None)


def test_delay_token_covers_every_registered_kind_and_ignores_caches():
    assert set(latency.delay_kinds()) <= set(_delay_pairs())
    wan = latency.WanDelay.symmetric(30.0, 7, 2, 3)
    before = cache._delay_token(wan)
    wan._base((4, 7, 2), latency.PROPOSAL)       # fills the hop-table cache
    assert wan._bases and cache._delay_token(wan) == before
    # one leaf of a tensor changes the token; the same values as another
    # dtype do too
    w2 = dataclasses.replace(wan, acceptor_region=wan.acceptor_region
                             .flip(0))
    assert cache._delay_token(w2) != before
    w3 = dataclasses.replace(wan, acceptor_region=wan.acceptor_region
                             .to(torch.int32))
    assert cache._delay_token(w3) != before


# ---------------------------------------------------------------------------
# _recommend parity.
# ---------------------------------------------------------------------------

class _Race:
    def __init__(self, q9999):
        self.q9999 = q9999

    def quantile(self, q):
        assert q == 0.9999
        return self.q9999


def _search_result(pkg, vals, q9999, n: int = 7):
    """One package's SearchResult over the n=7 cardinality family with the
    given frontier values and p99.99 race quantiles."""
    fam, score, par, srch = pkg
    members = fam.cardinality_family(n)[:len(vals)]
    labels = tuple(m.label for m in members)
    axes = score.default_axes(0.01, 20_000)
    fr = par.FrontierResult(labels=labels, axes=axes, values=vals,
                            mask=par.pareto_mask(vals, axes),
                            streams={"race": _Race(q9999)})
    rungs = (srch.RungReport(2_000, 78, len(vals), 0.1, 3),
             srch.RungReport(20_000, len(vals), len(vals), 0.2, 1))
    return srch.SearchResult(frontier=fr, members=members, rungs=rungs,
                             scored_trials=78 * 2_000 + len(vals) * 20_000,
                             exhaustive_trials=78 * 20_000)


def _rec_values(seed: int, m: int = 24):
    v = _random_values(seed, m)
    v[:, 0] = np.abs(v[:, 0])
    q = 3.0 + np.random.default_rng(seed).random(m)
    q[np.isnan(v[:, 1])] = np.nan
    return v, q


REC_QUERIES = [dict(objective=o, faults=f) for o in
               ("race_p999_ms", "fast_p50_ms", "p_recovery")
               for f in ({}, {"classic": 1}, {"fast": 1, "phase1": 2},
                         {"fast": 9})]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("qi", range(len(REC_QUERIES)))
def test_recommend_equals_jax(seed, qi):
    vals, q9999 = _rec_values(seed)
    q = REC_QUERIES[qi]
    p_sr = _search_result((families, pscore, pareto, psearch), vals,
                          torch.as_tensor(q9999, dtype=torch.float32))
    j_sr = _search_result((jfam, jscore, jpareto, jsearch), vals,
                          np.asarray(q9999, np.float32))
    got = Planner(device=CPU)._recommend(PlanQuery(n=7, **q), p_sr)
    want = jservice.Planner()._recommend(jservice.PlanQuery(n=7, **q), j_sr)
    skip = ("wall_s", "cold", "engine_compiles")
    g = {k: v for k, v in got.to_dict().items() if k not in skip}
    w = {k: v for k, v in want.to_dict().items() if k not in skip}
    np.testing.assert_equal(g, w)
    if q["faults"] == {"fast": 9}:
        assert not got.ok and "no frontier system" in got.reason


# ---------------------------------------------------------------------------
# The port's engine cache, search, planner and server (CPU).
# ---------------------------------------------------------------------------

def _small_members():
    return families.cardinality_family(7)


def test_engine_cache_memo_and_direct_scores():
    ec = EngineCache()
    members = _small_members()
    r1 = ec.score(members, trials=9_000, **SMALL)
    direct = score_systems(members, trials=9_000, **SMALL)
    np.testing.assert_array_equal(r1.values, direct.values)
    assert r1.labels == direct.labels
    assert r1.engine_compiles == 0        # the CPU builds no launch plan
    r2 = ec.score(members, trials=9_000, **SMALL)
    assert ec.memo_hits == 1 and r2.engine_compiles == 0
    np.testing.assert_array_equal(r1.values, r2.values)
    r3 = ec.score(members, trials=9_000, **dict(SMALL, seed=1))
    assert ec.memo_misses == 2
    assert not np.array_equal(r1.values[:, :2], r3.values[:, :2])
    assert ec.stats_dict()["engine_keys"] == 1.0
    assert cache.trace_total() == qt_ops.launch_plans() == 0


def test_search_small_matches_direct_frontier():
    members = _small_members()
    sr = search(members, final_trials=20_000,
                schedule=(Rung(2_000, 2.0), Rung(20_000, 2.0)), **SMALL)
    direct = score_systems(members, trials=20_000, **SMALL)
    assert set(sr.frontier_labels) == set(direct.frontier_labels)
    assert 0 < sr.budget_fraction < 1.0
    assert sr.rungs[0].n_survivors < len(members)
    # final-rung rows equal the direct scores on every axis
    didx = {l: i for i, l in enumerate(direct.labels)}
    for row, label in enumerate(sr.frontier.labels):
        np.testing.assert_array_equal(sr.frontier.values[row],
                                      direct.values[didx[label]])


def _small_query(**over):
    q = dict(n=7, family="cardinality", trials=20_000,
             schedule=SMALL_SCHEDULE, chunk=4_096, seed=0)
    q.update(over)
    return q


def test_planner_repeat_geometry_answered_from_the_cached_search():
    planner = Planner(device=CPU)
    r1 = planner.plan(_small_query(faults={"classic": 1}))
    assert r1.ok and r1.cold and r1.engine_compiles == 0
    r2 = planner.plan(_small_query(faults={"fast": 1},
                                   objective="fast_p50_ms"))
    assert r2.ok and not r2.cold and r2.engine_compiles == 0
    assert r2.fault_tolerance["fast"] >= 1
    assert r1.fault_tolerance["classic"] >= 1
    assert r2.recommended in r1.frontier_labels
    assert planner.search_misses == 1 and planner.search_hits == 1
    assert r1.system["type"] == "QuorumSpec"
    assert r1.predicted_ms["race_p9999"] >= r1.predicted_ms["race_p999"]
    # use_kernel selects nothing: the same search answers it
    r3 = planner.plan(_small_query(use_kernel=True))
    assert not r3.cold and planner.search_misses == 1


def test_planner_impossible_budget_reports_not_ok():
    r = Planner(device=CPU).plan(_small_query(faults={"fast": 7}))
    assert not r.ok and "no frontier system" in r.reason
    assert r.frontier_labels


def test_plan_group_batches_same_geometry():
    planner = Planner(device=CPU)
    qs = [PlanQuery.from_dict(_small_query(faults={"classic": 1})),
          PlanQuery.from_dict(_small_query(faults={"fast": 1}))]
    rs = planner.plan_group(qs)
    assert len(rs) == 2 and all(r.ok for r in rs)
    assert planner.search_misses == 1
    assert rs[0].cold and rs[1].cold and rs[1].wall_s == 0.0
    with pytest.raises(ValueError):
        planner.plan_group([qs[0],
                            PlanQuery.from_dict(_small_query(seed=5))])


def test_query_validation():
    with pytest.raises(ValueError):
        PlanQuery(objective="p42")
    with pytest.raises(ValueError):
        PlanQuery(faults={"phase9": 1})
    with pytest.raises(ValueError):
        PlanQuery.from_dict({"nope": 1})
    with pytest.raises(ValueError):
        PlanQuery(trials=0)
    assert PlanQuery(shard=True).shard is True
    assert PlanQuery(shard=trial_mesh(CPU, domains=2)).shard.size == 2
    PlanQuery(use_kernel=True, shard=False)      # JAX-shaped fields parse


def test_api_plan_and_experiment_plan():
    planner = Planner(device=CPU)
    r = api.plan(_small_query(faults={"classic": 1}), planner=planner)
    assert r.ok and r.system["type"] == "QuorumSpec"
    exp = api.Experiment(systems=[QuorumSpec.paper_headline(7)],
                         workload=api.Workload.race(k=2, delta_ms=0.2),
                         chunk=4_096, device=CPU)
    r2 = exp.plan(faults={"classic": 1}, trials=20_000,
                  schedule=SMALL_SCHEDULE, planner=planner)
    assert r2.ok and not r2.cold and r2.engine_compiles == 0
    assert planner.search_misses == 1
    # the process-wide planner of the experiment's device
    r3 = exp.plan(faults={"classic": 1}, trials=20_000,
                  schedule=SMALL_SCHEDULE)
    assert r3.recommended == r.recommended
    assert api.default_planner(CPU) is api.default_planner(CPU)
    assert api.default_planner(CPU).device == torch.device(CPU)
    r4 = api.plan(_small_query(faults={"classic": 1}), device=CPU)
    assert not r4.cold
    with pytest.raises(ValueError, match="planner runs on"):
        api.plan(_small_query(), planner=planner, device="meta")


def test_experiment_plan_folds_crashed_acceptors_into_the_delay():
    planner = Planner(device=CPU)
    exp = api.Experiment(systems=[QuorumSpec.paper_headline(7)],
                         workload=api.Workload.lossy(loss_prob=0.01, k=2,
                                                     delta_ms=0.2),
                         faults=(0,), chunk=4_096, device=CPU)
    r = exp.plan(trials=20_000, schedule=SMALL_SCHEDULE, planner=planner)
    ((gkey, sr),) = planner._searches.items()
    d = latency.CrashedDelay(latency.LossyDelay(
        latency.ShiftedLognormalDelay(), 0.01), latency.crash_mask(7, [0]))
    assert gkey[4] == cache._delay_token(d)
    assert r.frontier_labels


# ---------------------------------------------------------------------------
# The wire: JAX's client against the port's server.
# ---------------------------------------------------------------------------

def test_jax_client_against_port_server():
    srv = PlannerServer(device=CPU, port=0, batch_window_s=0.01)
    srv.start()
    try:
        ask = lambda p: jservice.query_server(p, port=srv.port)
        assert ask({"op": "ping"}) == {"ok": True, "op": "ping"}
        q = {"op": "plan", **_small_query(faults={"classic": 1}),
             "shard": False, "use_kernel": False}
        q["schedule"] = [list(r) for r in SMALL_SCHEDULE]
        r1 = ask(q)
        assert r1["ok"] and r1["cold"] and r1["engine_compiles"] == 0
        assert set(r1) == set(jservice.PlanResult(ok=True).to_dict()) | {
            "ok"}
        r2 = ask(dict(q, faults={"fast": 1}))
        assert r2["ok"] and not r2["cold"] and r2["engine_compiles"] == 0
        assert r2["frontier_labels"] == r1["frontier_labels"]
        stats = ask({"op": "stats"})
        assert stats["ok"] and stats["search_misses"] == 1.0
        assert stats["search_hits"] == 1.0 and stats["device"] == CPU
        assert stats["trace_counts"] == {"launch_plans": 0}
        bad = ask({"op": "plan", "objective": "nope"})
        assert not bad["ok"] and "objective" in bad["error"]
        # shard=True on the server's one domain runs unsharded (with JAX's
        # warning): the same search, answered from the cache
        shard = ask(dict(q, shard=True))
        assert shard["ok"] and not shard["cold"]
        for k in ("recommended", "frontier_labels", "predicted_ms"):
            assert shard[k] == r1[k], k
        assert ask({"op": "bogus"})["ok"] is False
    finally:
        srv.shutdown()


def test_server_takes_a_planner_or_a_device():
    with pytest.raises(ValueError, match="not both"):
        PlannerServer(planner=Planner(device=CPU), device=CPU, port=0)
    srv = PlannerServer(planner=Planner(device=CPU), port=0)
    srv.start()
    try:
        assert srv.planner.device == torch.device(CPU)
    finally:
        srv.shutdown()
