"""repro_torch.montecarlo.regimes and the streams' ``regimes=`` argument
against the live JAX package (repro.montecarlo.regimes / streaming).

The chain is exact: on shared uniforms the port's step equals JAX's
(``regimes.py:187-192``: f32 cumulative rows, ``searchsorted(side=
"right")`` clipped to R - 1), and configs equal JAX's.  The port's own
streams are held to their contracts: a single-regime stream is the i.i.d.
stream (counts, histograms and maxima the same bits), occupancy does not
depend on the chunk, the slices merge to the marginal.  Against JAX's own
draws the per-regime P(recovery) agrees within 3 sigma of the difference
of two binomials.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quorum import QuorumSpec as JQuorumSpec
from repro.montecarlo import build_mask_table as jbuild
from repro.montecarlo import regimes as jreg
from repro.montecarlo import streaming as jstream
from repro_torch.core.quorum import QuorumSpec
from repro_torch.montecarlo import engine, latency, regimes, rng, streaming
from test_torch_engine import tables

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "scenarios")
INT_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms")
OFFS = [0.0, 0.25]


def _only():
    return regimes.MarkovRegimes(names=("only",), delays=(None,),
                                 transition=torch.ones((1, 1)))


def _committed_regimes(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        cfg = json.load(f)
    n = cfg["systems"][0]["n"]
    return cfg["workload"]["regimes"], n


# ---------------------------------------------------------------------------
# The chain.
# ---------------------------------------------------------------------------

def _jax_chain(reg, u):
    """JAX's step (regimes.py:187-192) on the given uniforms."""
    cum = jnp.cumsum(reg.transition.astype(jnp.float32), axis=1)
    z, zs = reg.start, []
    for e in range(len(u)):
        zs.append(z)
        z = int(jnp.clip(jnp.searchsorted(cum[z], jnp.float32(u[e]),
                                          side="right"),
                         0, reg.n_regimes - 1))
    return np.asarray(zs, np.int32)


@pytest.mark.parametrize("which", ["gray", "diurnal_wan", "trace_replay"])
def test_chain_equals_jax_step_on_shared_uniforms(which):
    if which == "gray":
        port = regimes.gray_failure(11, p_fail=0.2, p_recover=0.3)
        ref = jreg.gray_failure(11, p_fail=0.2, p_recover=0.3)
    else:
        cfg, n = _committed_regimes(which + ".json")
        port = regimes.MarkovRegimes.from_config(cfg, n)
        ref = jreg.MarkovRegimes.from_config(cfg, n)
    r = np.random.default_rng(5)
    # uniforms as the port draws them (24-bit), and exact row boundaries
    u = (r.integers(0, 1 << 24, 400) / float(1 << 24)).astype(np.float32)
    cum = np.cumsum(np.asarray(ref.transition, np.float32), axis=1)
    u = np.concatenate([u, cum[:, :-1].ravel().astype(np.float32)])
    np.testing.assert_array_equal(port.chain(u), _jax_chain(ref, u))


def test_chain_prefix_property_and_start():
    reg = dataclasses.replace(regimes.gray_failure(11, p_fail=0.2,
                                                   p_recover=0.3), start=2)
    key = rng.root(9)
    short, long = reg.sequence(key, 10), reg.sequence(key, 50)
    assert short.dtype == torch.int32
    assert torch.equal(short, long[:10]) and int(short[0]) == 2


def test_chain_identity_transition_pins_and_frequencies_settle():
    reg = dataclasses.replace(regimes.gray_failure(11), start=1,
                              transition=torch.eye(3))
    assert bool((reg.sequence(rng.root(0), 20) == 1).all())
    # stationary law of gray_failure(p_fail=0.1, p_recover=0.3):
    # (0.6, 0.15, 0.25)
    reg = regimes.gray_failure(11, p_fail=0.1, p_recover=0.3)
    freq = np.bincount(reg.sequence(rng.root(0), 20_000).numpy(),
                       minlength=3) / 20_000
    np.testing.assert_allclose(freq, [0.6, 0.15, 0.25], atol=0.03)


def test_validate_rejects_what_jax_rejects():
    reg = regimes.gray_failure(11)
    with pytest.raises(ValueError, match="sum to 1"):
        dataclasses.replace(reg, transition=torch.full((3, 3), 0.5)
                            ).validate()
    with pytest.raises(ValueError, match="unique"):
        dataclasses.replace(reg, names=("a", "a", "b")).validate()
    with pytest.raises(ValueError, match="start"):
        dataclasses.replace(reg, start=3).validate()
    with pytest.raises(ValueError, match="epoch_trials"):
        dataclasses.replace(reg, epoch_trials=0).validate()


# ---------------------------------------------------------------------------
# Configs.
# ---------------------------------------------------------------------------

def test_to_config_equals_jax():
    port = regimes.gray_failure(11, epoch_trials=1024)
    ref = jreg.gray_failure(11, epoch_trials=1024)
    assert port.to_config() == ref.to_config()
    cfg = json.loads(json.dumps(port.to_config()))
    assert regimes.MarkovRegimes.from_config(cfg, 11).to_config() == \
        port.to_config()
    with pytest.raises(ValueError, match="cluster size"):
        regimes.MarkovRegimes.from_config(cfg)
    for name in ("diurnal_wan.json", "trace_replay.json"):
        cfg, n = _committed_regimes(name)
        got = regimes.MarkovRegimes.from_config(cfg, n).to_config()
        want = jreg.MarkovRegimes.from_config(cfg, n).to_config()
        assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


# ---------------------------------------------------------------------------
# Regime streams: the port's contracts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["race", "fast_path", "classic_path"])
@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_single_regime_bit_identical_to_iid(kind, path):
    table, _ = tables(kind)
    n = table["p1_w"].shape[-1]
    kw = dict(n=n, trials=5000, chunk=2048)
    if path == "race":
        run = lambda **r: streaming.race_stream(rng.root(7), table, OFFS,
                                                k_proposers=2, **kw, **r)
    else:
        fn = getattr(streaming, path + "_stream")
        run = lambda **r: fn(rng.root(7), table, **kw, **r)
    plain, mod = run(), run(regimes=_only())
    assert isinstance(mod, regimes.RegimeStreamSummary)
    assert mod.occupancy.tolist() == [5000]
    for f in INT_FIELDS:
        assert torch.equal(getattr(plain, f), getattr(mod, f)), f
    torch.testing.assert_close(mod.mean_ms, plain.mean_ms, rtol=1e-5,
                               atol=0.0)


def _race(key, trials, chunk, reg):
    table = engine.build_mask_table([QuorumSpec.paper_headline(11)],
                                    device="cpu")
    return streaming.race_stream(key, table, OFFS, n=11, k_proposers=2,
                                 trials=trials, chunk=chunk, regimes=reg)


def test_occupancy_does_not_change_with_chunk():
    reg = regimes.gray_failure(5, epoch_trials=1000, p_fail=0.1,
                               p_recover=0.3)
    table, _ = tables("card")
    occ = {c: streaming.fast_path_stream(rng.root(5), table, n=5,
                                         trials=37_111, chunk=c,
                                         regimes=reg).occupancy
           for c in (4_096, 8_192, 16_384)}
    assert int(occ[4_096].sum()) == 37_111
    assert bool((occ[4_096] > 0).sum() >= 2)
    assert torch.equal(occ[4_096], occ[8_192])
    assert torch.equal(occ[4_096], occ[16_384])


def test_slices_merge_to_the_marginal_and_report():
    reg = regimes.gray_failure(11, epoch_trials=2_048, p_fail=0.1,
                               p_recover=0.3)
    s = _race(rng.root(3), 30_000, 8_192, reg)
    tot = s.total()
    per = [s.regime(i) for i in range(s.n_regimes)]
    assert int(tot.n_trials[0]) == 30_000
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist"):
        assert torch.equal(sum(getattr(p, f) for p in per),
                           getattr(tot, f)), f
    assert torch.equal(torch.stack([p.n_trials[0] for p in per]),
                       s.occupancy)
    assert torch.equal(s.regime("partitioned").hist, per[2].hist)
    rep = s.merge(_race(rng.root(4), 10_000, 8_192, reg)).report()
    assert rep["names"] == ["baseline", "degraded", "partitioned"]
    assert sum(rep["occupancy"]) == 40_000
    assert abs(sum(rep["occupancy_frac"]) - 1.0) < 1e-9
    other = dataclasses.replace(s, names=("x", "y", "z"))
    with pytest.raises(ValueError, match="regime sets"):
        s.merge(other)


def test_mixed_delay_draws_each_regime_from_the_one_generator():
    """With R > 1 every model draws from the chunk's generator in turn:
    two regimes of the same model still see different draws."""
    model = latency.default_delay()
    rid = torch.tensor([0, 1, 0, 1])
    mixed = regimes._RegimeMixedDelay((model, model), rid)
    got = mixed.sample_hops(rng.generator(rng.root(1), "cpu"), (4, 3))
    gen = rng.generator(rng.root(1), "cpu")
    first, second = model.sample_hops(gen, (4, 3)), model.sample_hops(gen,
                                                                      (4, 3))
    assert torch.equal(got[0::2], first[0::2])
    assert torch.equal(got[1::2], second[1::2])
    single = regimes._RegimeMixedDelay((model,), rid)
    assert torch.equal(single.sample_hops(rng.generator(rng.root(1), "cpu"),
                                          (4, 3)), first)


def test_regime_config_dict_and_deferred_wrappers():
    cfg, n = _committed_regimes("diurnal_wan.json")
    reg = regimes.MarkovRegimes.from_config(cfg, n)
    assert reg.delays[0] is None
    bound = reg.bound(latency.default_delay())
    assert isinstance(bound.delays[0], latency.ShiftedLognormalDelay)
    assert isinstance(bound.delays[2], latency.CrashedDelay)
    table = engine.build_mask_table([QuorumSpec.paper_headline(12)],
                                    device="cpu")
    s = streaming.race_stream(rng.root(1), table, OFFS, n=12, k_proposers=2,
                              trials=20_000, chunk=8_192, regimes=cfg)
    assert int(s.occupancy.sum()) == 20_000
    assert int(s.n_trials[0]) == 20_000


# ---------------------------------------------------------------------------
# Against JAX's own draws: per-regime rates.
# ---------------------------------------------------------------------------

def test_per_regime_recovery_within_3_sigma_of_jax():
    trials = 200_000
    specs = [(9, 3, 7), (9, 5, 7)]
    port_t = engine.build_mask_table([QuorumSpec(11, *q) for q in specs],
                                     device="cpu")
    jax_t = jbuild([JQuorumSpec(11, *q) for q in specs])
    kw = dict(epoch_trials=1024, p_fail=0.1, p_recover=0.3)
    got = streaming.race_stream(rng.root(11), port_t, OFFS, n=11,
                                k_proposers=2, trials=trials, chunk=65_536,
                                regimes=regimes.gray_failure(11, **kw))
    want = jstream.race_stream(jax.random.PRNGKey(11), jax_t,
                               jnp.asarray(OFFS), None, n=11, k_proposers=2,
                               trials=trials, chunk=65_536, shard=False,
                               regimes=jreg.gray_failure(11, **kw))
    assert int(got.occupancy.sum()) == int(np.asarray(want.occupancy).sum())
    for r in range(3):
        gp, wj = got.regime(r), want.regime(r)
        n_p = gp.n_trials.double().numpy()
        n_j = np.asarray(wj.n_trials, np.float64)
        assert (n_p > 1000).all() and (n_j > 1000).all(), (r, n_p, n_j)
        p_p = gp.n_recovery.double().numpy() / n_p
        p_j = np.asarray(wj.n_recovery, np.float64) / n_j
        p = (p_p * n_p + p_j * n_j) / (n_p + n_j)
        sigma = np.sqrt(p * (1 - p) * (1 / n_p + 1 / n_j))
        assert (np.abs(p_p - p_j) <= 3 * sigma + 1e-12).all(), (
            r, p_p, p_j, sigma)
