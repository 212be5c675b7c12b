"""repro_torch.montecarlo.engine (and rng, latency) against the live JAX
engine (repro.montecarlo.engine).

Draws are the seam: JAX draws come from threefry, the port's from Philox,
so the two are compared by distribution (quantiles within 1%, rates within
3 sigma binomial).  Everything after the draws is compared exactly:
``inject_jax_draws`` makes the port's three draw functions return JAX's
arrays for the same key, and then decide bits, winners and latencies must
be bit-identical.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quorum as jq
from repro.frontier import families as jfam
from repro.montecarlo import engine as jeng
from repro.montecarlo import latency as jlat
from repro_torch.core import quorum as pq
from repro_torch.frontier import families as pfam
from repro_torch.montecarlo import engine, latency, rng

_jax_draw_race = jax.jit(jeng._draw_race, static_argnames=(
    "n", "k_proposers", "samples", "recovery"))
_jax_fast_draws = jax.jit(jeng._fast_path_draws,
                          static_argnames=("n", "samples"))
_jax_classic_draws = jax.jit(jeng._classic_path_draws,
                             static_argnames=("n", "samples"))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def inject_jax_draws(monkeypatch, keys, jax_delay=None):
    """Make the port's draw functions return JAX's draws: a generator seeded
    with port key k draws exactly what JAX draws from ``keys[k]``."""
    jax_delay = jax_delay if jax_delay is not None else jlat.default_delay()

    def key_of(gen):
        return keys[gen.initial_seed()]

    def draw_race(gen, offsets, delay, *, n, k_proposers, samples,
                  recovery="coordinated"):
        raw = _jax_draw_race(key_of(gen), jnp.asarray(offsets.numpy()),
                             jax_delay, n=n, k_proposers=k_proposers,
                             samples=samples, recovery=recovery)
        return {k: _t(v) for k, v in raw.items()}

    def fast_draws(gen, delay, n, samples):
        return _t(_jax_fast_draws(key_of(gen), jax_delay, n=n,
                                  samples=samples))

    def classic_draws(gen, delay, n, samples):
        d0, path = _jax_classic_draws(key_of(gen), jax_delay, n=n,
                                      samples=samples)
        return _t(d0), _t(path)

    monkeypatch.setattr(engine, "_draw_race", draw_race)
    monkeypatch.setattr(engine, "_fast_path_draws", fast_draws)
    monkeypatch.setattr(engine, "_classic_path_draws", classic_draws)


def batch(pkg: str, kind: str):
    """The same quorum-system batch built by either package, as masks."""
    fam, q = (pfam, pq) if pkg == "port" else (jfam, jq)
    if kind == "card":
        return [m.masks() for m in fam.cardinality_family(5)]
    if kind == "grid":
        return [m.masks(9) for m in fam.grid_family(9)]
    if kind == "weighted":
        return [m.masks() for m in fam.weighted_family(7)]
    n = 6                                                  # mixed
    card = [fam.Member(f"card.{t}", s) for t, s in
            (("headline", q.QuorumSpec.paper_headline(n)),
             ("fast_paxos", q.QuorumSpec.fast_paxos(n)),
             ("majority", q.QuorumSpec.majority_fast(n)))]
    return [m.masks(n) for m in card + fam.grid_family(n)
            + fam.weighted_family(n)]


def tables(kind: str, specialize: bool = True):
    port = engine.build_mask_table(batch("port", kind), device="cpu",
                                   specialize=specialize)
    jax_t = jeng.build_mask_table(batch("jax", kind), specialize=specialize)
    return port, jax_t


# ---------------------------------------------------------------------------
# Mask tables.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["card", "grid", "weighted", "mixed"])
def test_mask_table_and_depths_match_jax(kind):
    port, jax_t = tables(kind)
    assert set(port) == set(jax_t)
    for k in jax_t:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(jax_t[k]))
        assert port[k].dtype == (torch.int32 if k == "q" else torch.float32)
    assert engine.saturation_depths(port) == jeng.saturation_depths(jax_t)
    carried = engine.table_from_numpy(
        {k: np.asarray(v) for k, v in jax_t.items()}, device="cpu")
    assert set(carried) == set(port)
    for k in port:
        assert torch.equal(carried[k], port[k])


def test_mask_table_rejects_mixed_cluster_sizes():
    with pytest.raises(ValueError, match="mixes cluster sizes"):
        engine.build_mask_table([pq.QuorumSpec(5, 3, 3, 4),
                                 pq.QuorumSpec(7, 5, 3, 5)], device="cpu")


# ---------------------------------------------------------------------------
# Everything after the draws is bit-identical.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crash", [False, True])
@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_race_bit_identical_on_jax_draws(monkeypatch, kind, recovery, crash):
    port_t, jax_t = tables(kind)
    n = port_t["p1_w"].shape[-1]
    jdelay, crashed = jlat.default_delay(), None
    if crash:
        crashed = np.zeros(n, bool)
        crashed[[1, n - 1]] = True
        jdelay = jlat.CrashedDelay(jdelay, jnp.asarray(crashed))
    key, jkey = rng.root(21), jax.random.PRNGKey(21)
    inject_jax_draws(monkeypatch, {key: jkey}, jdelay)
    offsets = [0.0, 0.2]
    got = engine.race(key, port_t, offsets, n=n, k_proposers=2,
                      samples=3000, recovery=recovery)
    want = jeng.race(jkey, jax_t, jnp.asarray(offsets), jdelay, n=n,
                     k_proposers=2, samples=3000, recovery=recovery)
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]),
                                      err_msg=f)
    if crash:
        assert bool(got["undecided"].any() or got["recovery"].any())


@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_fast_and_classic_paths_bit_identical_on_jax_draws(monkeypatch,
                                                           kind):
    port_t, jax_t = tables(kind)
    n = port_t["p1_w"].shape[-1]
    key, jkey = rng.root(22), jax.random.PRNGKey(22)
    inject_jax_draws(monkeypatch, {key: jkey})
    np.testing.assert_array_equal(
        engine.fast_path(key, port_t, n=n, samples=2000).numpy(),
        np.asarray(jeng.fast_path(jkey, jax_t, n=n, samples=2000)))
    np.testing.assert_array_equal(
        engine.classic_path(key, port_t, n=n, samples=2000).numpy(),
        np.asarray(jeng.classic_path(jkey, jax_t, n=n, samples=2000)))


def test_summarize_matches_jax_on_jax_draws(monkeypatch):
    port_t, jax_t = tables("card")
    key, jkey = rng.root(23), jax.random.PRNGKey(23)
    inject_jax_draws(monkeypatch, {key: jkey})
    got = engine.summarize(engine.race(key, port_t, [0.0, 0.2], n=5,
                                       k_proposers=2, samples=2000))
    want = jeng.summarize(jeng.race(jkey, jax_t, jnp.asarray([0.0, 0.2]),
                                    n=5, k_proposers=2, samples=2000))
    assert set(got) == set(want)
    for k in want:      # f32 means and interpolated quantiles: 1e-6 rel
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The port's own lowerings agree with each other.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
def test_masked_and_q_lowerings_bit_identical(recovery):
    systems = batch("port", "card")
    q = engine.build_mask_table(systems, device="cpu")
    masked = engine.build_mask_table(systems, device="cpu", specialize=False)
    assert "q" in q and "q" not in masked
    key = rng.root(5)
    a = engine.race(key, q, [0.0, 0.2], n=5, k_proposers=2, samples=4000,
                    recovery=recovery)
    b = engine.race(key, masked, [0.0, 0.2], n=5, k_proposers=2,
                    samples=4000, recovery=recovery)
    for f in a:
        assert torch.equal(a[f], b[f]), f
    assert torch.equal(engine.fast_path(key, q, n=5, samples=4000),
                       engine.fast_path(key, masked, n=5, samples=4000))
    assert torch.equal(engine.classic_path(key, q, n=5, samples=4000),
                       engine.classic_path(key, masked, n=5, samples=4000))


# ---------------------------------------------------------------------------
# The port's own sampler, by distribution.
# ---------------------------------------------------------------------------

def test_lognormal_sampler_quantiles_within_1pct_of_jax():
    n = 100_000
    d = latency.default_delay().sample_hops(rng.generator(rng.root(1), "cpu"),
                                            (n,))
    j = np.asarray(jlat.default_delay().sample_hops(jax.random.PRNGKey(1),
                                                    (n,)))
    qs = [0.01, 0.1, 0.5, 0.9, 0.99]
    np.testing.assert_allclose(np.quantile(d.numpy(), qs),
                               np.quantile(j, qs), rtol=0.01)


def test_lossy_and_crashed_delays():
    gen = rng.generator(rng.root(2), "cpu")
    lossy = latency.LossyDelay(latency.default_delay(), loss_prob=0.05)
    d = lossy.sample_hops(gen, (100_000,))
    rate = float((d == latency.LOST_MS).float().mean())
    assert abs(rate - 0.05) < 3 * math.sqrt(0.05 * 0.95 / 100_000)
    crashed = torch.tensor([False, True, False, False, True])
    cd = latency.CrashedDelay(latency.default_delay(), crashed)
    for kind, shape in ((latency.PROPOSAL, (50, 5, 2)),
                        (latency.TO_LEARNER, (50, 5)),
                        (latency.FROM_COORDINATOR, (50, 5)),
                        (latency.TO_COORDINATOR, (50, 5))):
        x = cd.sample_hops(gen, shape, kind)
        lost = (x == latency.LOST_MS)
        assert bool(lost[:, [1, 4]].all()) and not bool(lost[:, [0, 2, 3]]
                                                        .any())
    x = cd.sample_hops(gen, (50,), latency.CLIENT_TO_LEADER)
    assert not bool((x == latency.LOST_MS).any())


def test_recovery_rate_within_3_sigma_of_jax():
    """Own draws on both sides: P(recovery) of three systems at 10^5
    samples agree within 3 sigma of the difference of two binomials."""
    n, S = 7, 100_000
    specs_p = [pq.QuorumSpec(n, 7, 1, 4), pq.QuorumSpec(n, 5, 3, 5),
               pq.QuorumSpec.fast_paxos(n)]
    specs_j = [jq.QuorumSpec(s.n, s.q1, s.q2c, s.q2f) for s in specs_p]
    got = engine.race(rng.root(3), engine.build_mask_table(specs_p,
                                                           device="cpu"),
                      [0.0, 0.2], n=n, k_proposers=2, samples=S)
    want = jeng.race(jax.random.PRNGKey(3), jeng.build_mask_table(specs_j),
                     jnp.asarray([0.0, 0.2]), n=n, k_proposers=2, samples=S)
    p_port = got["recovery"].double().mean(-1).numpy()
    p_jax = np.asarray(want["recovery"], np.float64).mean(-1)
    p = (p_port + p_jax) / 2
    sigma = np.sqrt(2 * p * (1 - p) / S)
    assert (np.abs(p_port - p_jax) <= 3 * sigma + 1e-12).all(), (
        p_port, p_jax, sigma)


# ---------------------------------------------------------------------------
# Keys.
# ---------------------------------------------------------------------------

def test_key_domains_are_disjoint_and_seed_generators():
    root = rng.root(0)
    chunks = {rng.derive(root, rng.CHUNK_DOMAIN, i) for i in range(1 << 16)}
    devices = {rng.derive(rng.derive(root, rng.DEVICE_FOLD_DOMAIN, 0),
                          rng.CHUNK_DOMAIN, d) for d in range(1024)}
    passes = {rng.derive(root, rng.PASS_DOMAIN, p) for p in range(3)}
    regimes = {rng.derive(root, rng.REGIME_FOLD_DOMAIN, e)
               for e in range(1024)}
    splits = {rng.derive(root, rng.SPLIT_DOMAIN, s)
              for s in (rng.RACE_SPLIT, rng.FREE_SPLIT)}
    assert len(chunks) == 1 << 16 and len(splits) == 2
    for other in (devices, passes, regimes, splits):
        assert not chunks & other
    assert not devices & passes
    for a, b in ((splits, devices), (splits, passes), (splits, regimes),
                 (regimes, devices), (regimes, passes)):
        assert not a & b
    # the split keys' own chunk streams are disjoint from the root's
    for k in splits:
        assert not chunks & {rng.derive(k, rng.CHUNK_DOMAIN, i)
                             for i in range(1 << 12)}
    assert all(0.0 <= rng.uniform(k) < 1.0 for k in regimes)
    assert rng.derive(root, rng.CHUNK_DOMAIN, 3) == rng.derive(
        rng.root(0), rng.CHUNK_DOMAIN, 3)
    key = rng.derive(root, rng.PASS_DOMAIN, rng.RACE_PASS)
    assert 0 <= key < 2 ** 63
    assert rng.generator(key, "cpu").initial_seed() == key
    a = torch.randn(5, generator=rng.generator(key, "cpu"))
    b = torch.randn(5, generator=rng.generator(key, "cpu"))
    assert torch.equal(a, b)
