"""The multi-process trial mesh (repro_torch.parallel, the streams'
``shard=``) against the live JAX package, on the CPU.

JAX's sharded path does not run under this container's jax, so the port
is held to JAX's per-device body and merge algebra on JAX's unsharded
path: with JAX's draws injected (domain d's key maps to
``fold_in(fold_in(jkey, DEVICE_FOLD_DOMAIN), d)``, its chunk c to
``fold_in`` of that by c), a D-domain stream of the port equals JAX's
per-domain ``shard=False`` streams of ``T // D + (d < T % D)`` trials,
merged in order with JAX's ``StreamSummary.merge``.  And to DESIGN.md
§10's layout invariance: 2 processes x 2 domains over gloo give the same
bits as 1 x 4.

Tolerances: counts and maxima exact; histograms exact up to latencies
within 4 ulp of a bucket edge (``assert_hist_match``, as in
test_torch_streaming.py); the mean to 1e-5 relative (f32 sums in another
order).  Across layouts everything is the same bits, the mean included.
"""
import functools
import os
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.montecarlo import latency as jlat
from repro.montecarlo import regimes as jreg
from repro.montecarlo import streaming as jstream
from repro_torch.core.quorum import QuorumSpec
from repro_torch.frontier import cardinality_family, score_systems
from repro_torch.montecarlo import engine, regimes, rng, streaming
from repro_torch.parallel import distributed, sharding
from repro_torch.parallel.sharding import TrialMesh, trial_mesh
from test_torch_engine import _jax_draw_race, _t, inject_jax_draws, tables
from test_torch_quorum_tally import assert_hist_match
from test_torch_streaming import OFFSETS, decided_latencies, stream_keys

CPU = "cpu"
D, TRIALS, CHUNK = 3, 30_011, 2_048      # each domain streams 5 chunks
INT_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided")


def shares(trials: int, d: int):
    return [trials // d + (1 if g < trials % d else 0) for g in range(d)]


def jax_domain_key(jkey, g):
    return jax.random.fold_in(
        jax.random.fold_in(jkey, jnp.int32(jstream.DEVICE_FOLD_DOMAIN)), g)


def domain_keys(key, jkey, trials, chunk, d=D):
    """Port key -> JAX key for every domain and each of its chunks."""
    keys = {}
    for g, t_d in enumerate(shares(trials, d)):
        keys.update(stream_keys(rng.derive(key, rng.DEVICE_FOLD_DOMAIN, g),
                                jax_domain_key(jkey, g), t_d, chunk))
    return keys


def jax_merged(run, jkey, trials, d=D):
    """JAX's per-domain ``shard=False`` streams merged in domain order."""
    return functools.reduce(
        lambda a, b: a.merge(b),
        [run(jax_domain_key(jkey, g), t_d)
         for g, t_d in enumerate(shares(trials, d))])


def assert_matches(port, jax_s, lat_of, what):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_s, f)),
                                      err_msg=f"{what} {f}")
    np.testing.assert_array_equal(port.max_ms.numpy(),
                                  np.asarray(jax_s.max_ms), err_msg=what)
    assert_hist_match(port.hist.numpy(), np.asarray(jax_s.hist), lat_of,
                      what=what)
    np.testing.assert_allclose(port.mean_ms.numpy(),
                               np.asarray(jax_s.mean_ms), rtol=1e-5,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The trial split and the keys.
# ---------------------------------------------------------------------------

def _spy_domains(monkeypatch):
    calls = []
    inner = streaming._domain_plan

    def spy(path, key, table, delay, offsets, *, trials, materialize, **kw):
        calls.append((key, trials, materialize))
        return inner(path, key, table, delay, offsets, trials=trials,
                     materialize=materialize, **kw)

    monkeypatch.setattr(streaming, "_domain_plan", spy)
    return calls


@pytest.mark.parametrize("trials,d", [(30_011, 3), (7, 4), (3, 4),
                                      (4_096, 1), (1_000, 2)])
def test_trial_split_and_domain_keys(monkeypatch, trials, d):
    """Domain g takes T // D + (g < T % D) trials under key
    derive(key, DEVICE_FOLD_DOMAIN, g); an empty domain runs nothing, and
    a sharded run never takes the materializing shortcut."""
    calls = _spy_domains(monkeypatch)
    table = engine.build_mask_table([QuorumSpec(5, 4, 2, 4)], device=CPU)
    key = rng.root(9)
    s = streaming.fast_path_stream(key, table, n=5, trials=trials,
                                   chunk=4_096, shard=trial_mesh(CPU, d))
    want = shares(trials, d)
    assert sum(want) == trials
    assert calls == [(rng.derive(key, rng.DEVICE_FOLD_DOMAIN, g), t, False)
                     for g, t in enumerate(want) if t > 0]
    assert int(s.n_trials[0]) == trials
    assert int(s.hist.sum()) == int(s.n_decided[0])


def _np_derive(key: int, domain: int, index: np.ndarray) -> np.ndarray:
    """``rng.derive`` vectorized over ``index`` (uint64 splitmix64)."""
    def mix(z):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))
    with np.errstate(over="ignore"):
        base = mix(np.uint64(key) ^ mix(np.uint64(domain)))
        return mix(base ^ index.astype(np.uint64)) & np.uint64((1 << 63) - 1)


def test_device_and_chunk_key_domains_disjoint():
    """The twin of JAX's test_streaming.py:441: domain keys never equal a
    chunk key of the same stream, for 2^20 chunks and 4096 domains."""
    key = rng.root(0)
    chunks = _np_derive(key, rng.CHUNK_DOMAIN, np.arange(1 << 20))
    devs = _np_derive(key, rng.DEVICE_FOLD_DOMAIN, np.arange(4_096))
    for i in (0, 1, 4_095):
        assert int(devs[i]) == rng.derive(key, rng.DEVICE_FOLD_DOMAIN, i)
        assert int(chunks[i]) == rng.derive(key, rng.CHUNK_DOMAIN, i)
    assert np.unique(devs).size == devs.size
    assert np.intersect1d(chunks, devs).size == 0


# ---------------------------------------------------------------------------
# Parity with JAX's per-device body and merge.
# ---------------------------------------------------------------------------

def _lat_of_domains(path, key, table, trials, chunk, recovery, d=D):
    per = [decided_latencies(path, rng.derive(key, rng.DEVICE_FOLD_DOMAIN, g),
                             table, n=table["p1_w"].shape[-1], k_proposers=2,
                             trials=t_d, chunk=chunk, recovery=recovery)
           for g, t_d in enumerate(shares(trials, d))]
    return lambda m: np.concatenate([f(m) for f in per])


@pytest.mark.parametrize("path,kind,recovery", [
    ("race", "card", "coordinated"), ("race", "card", "uncoordinated"),
    ("race", "mixed", "coordinated"), ("fast_path", "card", None),
    ("classic_path", "card", None), ("fast_path", "mixed", None)])
def test_sharded_stream_equals_jax_per_domain_streams(monkeypatch, path,
                                                      kind, recovery):
    """card race: race_card_hist a chunk; mixed race: the fused stream
    kernel's plain version; fast / classic: the shared-column lowering
    (card) or the materialized outcomes (mixed)."""
    port_t, jax_t = tables(kind)
    n = port_t["p1_w"].shape[-1]
    key, jkey = rng.root(41), jax.random.PRNGKey(41)
    inject_jax_draws(monkeypatch, domain_keys(key, jkey, TRIALS, CHUNK))
    mesh = trial_mesh(CPU, D)
    if path == "race":
        got = streaming.race_stream(key, port_t, OFFSETS, n=n, k_proposers=2,
                                    trials=TRIALS, chunk=CHUNK, shard=mesh,
                                    recovery=recovery)
        want = jax_merged(lambda k, t: jstream.race_stream(
            k, jax_t, jnp.asarray(OFFSETS), n=n, k_proposers=2, trials=t,
            chunk=CHUNK, shard=False, recovery=recovery), jkey, TRIALS)
    else:
        got = getattr(streaming, path + "_stream")(
            key, port_t, n=n, trials=TRIALS, chunk=CHUNK, shard=mesh)
        want = jax_merged(lambda k, t: getattr(jstream, path + "_stream")(
            k, jax_t, n=n, trials=t, chunk=CHUNK, shard=False), jkey, TRIALS)
    lat_of = _lat_of_domains(path, key, port_t, TRIALS, CHUNK,
                             recovery or "coordinated")
    assert_matches(got, want, lat_of, f"{path} {kind} {recovery}")
    assert got.n_trials.tolist() == [TRIALS] * port_t["p1_w"].shape[0]


def test_sharded_regime_stream_equals_jax_per_domain_streams(monkeypatch):
    """Each domain's Markov chain runs under its own domain key; occupancy
    merges by SUM and each regime's slice as a summary.  JAX's chain
    (``MarkovRegimes.sequence`` of ``fold_in(k_d, REGIME_FOLD_DOMAIN)``)
    and JAX's draws under JAX's mixed environment are injected."""
    port_t, jax_t = tables("card")
    n = port_t["p1_w"].shape[-1]
    kw = dict(epoch_trials=1_024, p_fail=0.2, p_recover=0.3)
    p_reg, j_reg = regimes.gray_failure(n, **kw), jreg.gray_failure(n, **kw)
    j_bound = j_reg.bound(jlat.default_delay())
    key, jkey = rng.root(43), jax.random.PRNGKey(43)
    keys = domain_keys(key, jkey, TRIALS, CHUNK)

    def sequence(self, k, n_epochs):
        zs = j_reg.sequence(jax.random.fold_in(
            keys[k], jnp.int32(jstream.REGIME_FOLD_DOMAIN)), n_epochs)
        return torch.from_numpy(np.asarray(zs, np.int32))

    def draw_race(gen, offsets, delay, *, n, k_proposers, samples,
                  recovery="coordinated"):
        jd = j_bound.mixed_delay(jnp.asarray(delay.rid.numpy()))
        raw = _jax_draw_race(keys[gen.initial_seed()],
                             jnp.asarray(offsets.numpy()), jd, n=n,
                             k_proposers=k_proposers, samples=samples,
                             recovery=recovery)
        return {k: _t(v) for k, v in raw.items()}

    seen = []
    update = streaming.StreamSummary.update

    def spy(self, out, valid):                 # the decided latencies
        seen.append((out, valid))
        return update(self, out, valid)

    monkeypatch.setattr(regimes.MarkovRegimes, "sequence", sequence)
    monkeypatch.setattr(engine, "_draw_race", draw_race)
    monkeypatch.setattr(streaming.StreamSummary, "update", spy)
    got = streaming.race_stream(key, port_t, OFFSETS, n=n, k_proposers=2,
                                trials=TRIALS, chunk=CHUNK,
                                shard=trial_mesh(CPU, D), regimes=p_reg)
    want = jax_merged(lambda k, t: jstream.race_stream(
        k, jax_t, jnp.asarray(OFFSETS), n=n, k_proposers=2, trials=t,
        chunk=CHUNK, shard=False, regimes=j_reg), jkey, TRIALS)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(want.occupancy))
    assert int(got.occupancy.sum()) == TRIALS
    assert int((got.occupancy > 0).sum()) >= 2
    for r in range(p_reg.n_regimes):
        def lat_of(m, r=r):
            return np.concatenate([
                o["latency_ms"][m][(o["reached_fast"][m] | o["recovery"][m])
                                   & v[r]].numpy() for o, v in seen])
        assert_matches(got.regime(r), want.regime(r), lat_of, f"regime {r}")


# ---------------------------------------------------------------------------
# Mesh resolution, trials < D, the merge identity.
# ---------------------------------------------------------------------------

def test_resolve_mesh_single_domain_warns_or_shards(monkeypatch):
    """JAX's test_streaming.py:473: shard=True on one domain warns and runs
    unsharded; False and None are silent; an explicit mesh is honored."""
    monkeypatch.delenv(sharding.ENV_DOMAINS_PER_PROCESS, raising=False)
    dev = torch.device(CPU)
    with pytest.warns(UserWarning, match="only 1 device"):
        assert streaming._resolve_mesh(True, dev) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert streaming._resolve_mesh(False, dev) is None
        assert streaming._resolve_mesh(None, dev) is None
        one = trial_mesh(CPU, 1)
        assert streaming._resolve_mesh(one, dev) is one
        monkeypatch.setenv(sharding.ENV_DOMAINS_PER_PROCESS, "3")
        mesh = streaming._resolve_mesh(True, dev)
    assert mesh.size == 3 and mesh.shape == {sharding.TRIAL_AXIS: 3}
    assert [g for g, _ in mesh.domains] == [0, 1, 2]
    assert all(d == dev for _, d in mesh.domains)
    with pytest.raises(TypeError):
        streaming._resolve_mesh("yes", dev)
    with pytest.raises(ValueError):
        TrialMesh(size=2, domains=((2, dev),))


def test_explicit_single_domain_mesh_honored(monkeypatch):
    """JAX's test_streaming.py:493: a 1-domain mesh runs the sharded path
    (domain keys, other draws): the same trial totals, p50 within 5%."""
    calls = _spy_domains(monkeypatch)
    table = engine.build_mask_table([QuorumSpec.paper_headline(11),
                                     QuorumSpec.fast_paxos(11)], device=CPU)
    kw = dict(n=11, k_proposers=2, trials=10_007, chunk=2_048)
    key = rng.root(5)
    st = streaming.race_stream(key, table, OFFSETS, shard=trial_mesh(CPU, 1),
                               **kw)
    assert calls == [(rng.derive(key, rng.DEVICE_FOLD_DOMAIN, 0), 10_007,
                      False)]
    un = streaming.race_stream(key, table, OFFSETS, shard=False, **kw)
    assert st.n_trials.tolist() == un.n_trials.tolist() == [10_007] * 2
    assert not torch.equal(st.hist, un.hist)         # other draws
    p_st, p_un = st.quantile(0.5), un.quantile(0.5)
    assert bool(((p_st - p_un).abs() / p_un < 0.05).all())


def test_trials_below_domain_count_and_zero_identity(monkeypatch):
    """JAX's test_streaming.py:516-552: 3 trials on 4 domains (the last
    domain empty) stay exact; zeros() is the merge's identity."""
    calls = _spy_domains(monkeypatch)
    table = engine.build_mask_table([QuorumSpec.paper_headline(11)],
                                    device=CPU)
    st = streaming.fast_path_stream(rng.root(2), table, n=11, trials=3,
                                    chunk=64, shard=trial_mesh(CPU, 4))
    assert len(calls) == 3
    assert int(st.n_trials[0]) == int(st.n_fast[0]) == 3
    assert int(st.hist.sum()) == 3
    assert bool(torch.isfinite(st.max_ms).all())
    assert bool(torch.isfinite(st.mean_ms).all())
    base = streaming.race_stream(rng.root(3), table, OFFSETS, n=11,
                                 k_proposers=2, trials=4_000, chunk=1_024,
                                 shard=False)
    zero = streaming.StreamSummary.zeros(1, base.precision)
    for merged in (base.merge(zero), zero.merge(base),
                   streaming._mesh_merge([base, zero], trial_mesh(CPU, 2),
                                         torch.device(CPU)),
                   streaming._mesh_merge([zero, base], trial_mesh(CPU, 2),
                                         torch.device(CPU))):
        for f in INT_FIELDS + ("hist", "max_ms"):
            assert torch.equal(getattr(merged, f), getattr(base, f)), f
        assert bool(torch.isfinite(merged.mean_ms).all())
        torch.testing.assert_close(merged.mean_ms, base.mean_ms, rtol=1e-6,
                                   atol=0.0)


# ---------------------------------------------------------------------------
# Process layouts over gloo.
# ---------------------------------------------------------------------------

LAYOUT_TRIALS = 20_011


def test_two_by_two_bit_identical_to_one_by_four():
    """DESIGN.md §10 through the port's launcher: the fixed workload on
    2 processes x 2 domains and on 1 x 4 (both over gloo, as subprocesses)
    and in this process on a 4-domain mesh: every field the same bits."""
    with tempfile.TemporaryDirectory() as td:
        multi = distributed.run_stream_layout(
            2, 2, os.path.join(td, "p2x2.npz"), trials=LAYOUT_TRIALS,
            device=CPU, timeout_s=240)
        single = distributed.run_stream_layout(
            1, 4, os.path.join(td, "p1x4.npz"), trials=LAYOUT_TRIALS,
            device=CPU, timeout_s=240)
    assert int(multi["process_count"]) == 2
    assert int(single["process_count"]) == 1
    assert int(multi["global_devices"]) == int(single["global_devices"]) == 4
    key, table, offsets = distributed.workload("fixed", CPU)
    local = streaming.race_stream(key, table, offsets, n=11, k_proposers=2,
                                  trials=LAYOUT_TRIALS, chunk=2_048,
                                  shard=trial_mesh(CPU, 4)).to_numpy()
    for f in streaming._FIELDS:
        np.testing.assert_array_equal(multi[f], single[f], err_msg=f)
        np.testing.assert_array_equal(multi[f], local[f], err_msg=f)
    assert (multi["n_trials"] == LAYOUT_TRIALS).all()
    assert (multi["n_fast"] + multi["n_recovery"] + multi["n_undecided"]
            == LAYOUT_TRIALS).all()
    for q in ("p50_ms", "p999_ms", "p9999_ms"):
        np.testing.assert_array_equal(multi[q], single[q], err_msg=q)
        assert np.isfinite(multi[q]).all(), q


def test_selftest_and_launcher_failures(monkeypatch):
    outs = distributed.launch_local(
        2, 2, [distributed.sys.executable, "-m",
               "repro_torch.parallel.distributed", "selftest", "--device",
               CPU], timeout_s=120)
    assert all("4 global domains" in o and "(want 6) OK" in o for o in outs)
    with pytest.raises(RuntimeError, match="rc=3"):
        distributed.launch_local(2, 1, [distributed.sys.executable, "-c",
                                        "import sys; sys.exit(3)"],
                                 timeout_s=60)
    # a port taken between the probe and the bind: retried on a fresh one
    tries = []

    def once(*a, **k):
        tries.append(1)
        if len(tries) == 1:
            raise RuntimeError("[proc 0 rc=1] The server socket has failed "
                               "to listen on any local network address. "
                               "(errno: 98 - Address already in use)")
        return ["ok"]

    monkeypatch.setattr(distributed, "_launch_once", once)
    assert distributed.launch_local(1, 1, ["x"]) == ["ok"] and len(tries) == 2
    with pytest.raises(ValueError):
        distributed.launch_local(0, 1, ["x"])


def test_initialize_and_info_single_process(monkeypatch):
    for k in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
              distributed.ENV_DOMAINS_PER_PROCESS):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device=CPU) == distributed.DistInfo(
        0, 1, 1, 1)
    monkeypatch.setenv(distributed.ENV_DOMAINS_PER_PROCESS, "4")
    got = distributed.info(CPU)
    assert (got.local_device_count, got.global_device_count) == (4, 4)
    assert not got.is_multiprocess


# ---------------------------------------------------------------------------
# The front doors: score_systems, Experiment, api.frontier, the planner.
# ---------------------------------------------------------------------------

def test_front_doors_with_an_explicit_mesh():
    from repro_torch import api
    from repro_torch.planner import EngineCache, Planner

    mesh = trial_mesh(CPU, 3)
    members = cardinality_family(5)
    table = engine.build_mask_table([m.masks() for m in members], device=CPU)
    kw = dict(trials=9_001, chunk=1_024, seed=4, device=CPU)
    fr = score_systems(members, shard=mesh, **kw)
    key = rng.root(4)
    race = streaming.race_stream(
        rng.derive(key, rng.PASS_DOMAIN, rng.RACE_PASS), table,
        [0.0, 0.2], n=5, k_proposers=2, trials=9_001, chunk=1_024,
        shard=mesh)
    fast = streaming.fast_path_stream(
        rng.derive(key, rng.PASS_DOMAIN, rng.FAST_PASS), table, n=5,
        trials=9_001, chunk=1_024, shard=mesh)
    for got, want in ((fr.streams["race"], race), (fr.streams["fast"], fast)):
        for f in streaming._FIELDS:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    un = score_systems(members, shard=False, **kw)
    assert not torch.equal(un.streams["race"].hist, race.hist)
    fr2 = api.frontier(members, trials=9_001, chunk=1_024, seed=4,
                       shard=mesh, device=CPU)
    np.testing.assert_array_equal(fr2.values, fr.values)

    exp = api.Experiment(systems=[m.system for m in members[:3]],
                         workload=api.Workload.race(k=2, delta_ms=0.2),
                         trials=9_001, chunk=1_024, seed=4, shard=mesh,
                         device=CPU)
    got = exp.run("montecarlo").stream
    want = streaming.race_stream(
        rng.derive(key, rng.SPLIT_DOMAIN, rng.RACE_SPLIT), exp.lower(),
        [0.0, 0.2], n=5, k_proposers=2, trials=9_001, chunk=1_024,
        shard=mesh)
    for f in streaming._FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    # the planner: a sharded query scores on the mesh, and the memo never
    # hands an unsharded result to a query that runs sharded
    cache = EngineCache()
    a = cache.score(members, shard=False, **kw)
    b = cache.score(members, shard=trial_mesh(CPU, 1), **kw)
    c = cache.score(members, shard=mesh, **kw)
    assert cache.memo_misses == 3 and cache.memo_hits == 0
    assert not torch.equal(a.streams["race"].hist, b.streams["race"].hist)
    np.testing.assert_array_equal(c.values, fr.values)
    r = Planner(device=CPU).plan(n=5, trials=9_001, chunk=1_024, seed=4,
                                 shard=mesh, schedule=[[3_001, 1.0],
                                                       [9_001, 1.0]])
    assert r.ok and set(r.frontier_labels) <= set(fr.labels)
