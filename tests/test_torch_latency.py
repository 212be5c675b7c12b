"""repro_torch.montecarlo.latency and traces against the live JAX models
(repro.montecarlo.latency, repro.montecarlo.traces).

Draws are the seam: the two packages' samplers agree in distribution, so
10^5-sample quantiles are held within 1% relative of JAX's.  Pareto and
the WAN jitter are held at the 1st to 90th percentiles (``BODY``): two
independent samples' 99th percentiles differ by about 1.8% (Pareto) and
0.7% (the jitter's lognormal, sigma 0.4) at one sigma at 10^5 draws, and
by at most 0.5% at the 90th.  The WAN placement tables, the empirical
quantile grids and every JSON config are held exactly equal.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.montecarlo import latency as jlat
from repro.montecarlo import traces as jtr
from repro_torch.montecarlo import latency, rng, traces

N = 100_000
QS = [0.01, 0.1, 0.5, 0.9, 0.99]
BODY = [0.01, 0.1, 0.5, 0.9]
TRACE = [0.31, 0.29, 0.35, 0.42, 0.3, 0.33, 0.5, 0.28, 0.37, 0.31, 0.44,
         0.3, 0.32, 0.61, 0.29, 0.34, 0.4, 0.31, 0.55, 0.3, 0.95, 1.4, 2.2]


def _gen(seed: int) -> torch.Generator:
    return rng.generator(rng.root(seed), "cpu")


def _quantiles_close(port: torch.Tensor, ref, qs=QS, rtol=0.01):
    np.testing.assert_allclose(np.quantile(port.numpy().ravel(), qs),
                               np.quantile(np.asarray(ref).ravel(), qs),
                               rtol=rtol)


def test_pareto_quantiles_within_1pct_of_jax():
    d = latency.ParetoDelay().sample_hops(_gen(1), (N,))
    j = jlat.ParetoDelay().sample_hops(jax.random.PRNGKey(1), (N,))
    assert float(d.min()) >= 0.25
    _quantiles_close(d, j, qs=BODY)


def _wans(k=2, n=11):
    """The same symmetric and hand-placed WAN model in both packages."""
    ow = [[0.0, 12.5, 40.0], [12.5, 0.0, 22.0], [40.0, 22.0, 0.0]]
    acc, prop = [0, 2, 1, 1, 0, 2, 2, 1, 0, 0, 1], [2, 0]
    port = [latency.WanDelay.symmetric(30.0, n, k, 3),
            latency.WanDelay(torch.tensor(ow), torch.tensor(acc),
                             torch.tensor(prop), learner_region=1)]
    ref = [jlat.WanDelay.symmetric(30.0, n, k, 3),
           jlat.WanDelay(jnp.asarray(ow, jnp.float32),
                         jnp.asarray(acc, jnp.int32),
                         jnp.asarray(prop, jnp.int32), jnp.int32(1))]
    return port, ref


# proposal hops at the placement's K, at K + 1 (the wrap-around: proposer 2
# sits where proposer 0 does) and at one proposer (the fast path).
HOPS = [(latency.PROPOSAL, (N // 22, 11, 2)),
        (latency.PROPOSAL, (N // 33, 11, 3)),
        (latency.PROPOSAL, (N // 11, 11, 1)),
        (latency.TO_LEARNER, (N // 11, 11)),
        (latency.FROM_COORDINATOR, (N // 11, 11)),
        (latency.TO_COORDINATOR, (N // 11, 11)),
        (latency.CLIENT_TO_LEADER, (N,))]


@pytest.mark.parametrize("kind,shape", HOPS,
                         ids=[f"{k}-{s[-1]}" for k, s in HOPS])
def test_wan_base_tables_equal_and_jitter_within_1pct(kind, shape):
    for i, (p, j) in enumerate(zip(*_wans())):
        base_p, base_j = p._base(shape, kind), j._base(shape, kind)
        np.testing.assert_array_equal(
            np.broadcast_to(base_p.numpy(), shape),
            np.broadcast_to(np.asarray(base_j), shape))
        d = p.sample_hops(_gen(2 + i), shape, kind)
        dj = j.sample_hops(jax.random.PRNGKey(2 + i), shape, kind)
        assert d.shape == shape and d.dtype == torch.float32
        _quantiles_close(d - base_p, np.asarray(dj) - np.asarray(base_j),
                         qs=BODY)


def test_wan_proposal_wraps_around_the_placement():
    wan = latency.WanDelay.symmetric(30.0, 5, 2, 3)
    base = wan._base((1, 5, 5), latency.PROPOSAL)[0]       # (n, K)
    for k in range(5):
        assert torch.equal(base[:, k], base[:, k % 2])


def test_wan_rejects_an_unknown_hop():
    with pytest.raises(ValueError, match="unknown hop kind"):
        latency.WanDelay.symmetric(30.0, 5, 2).sample_hops(_gen(0), (3, 5),
                                                          "sideways")


@pytest.mark.parametrize("trace,q", [(TRACE, 64), (TRACE, 256),
                                     ([0.7], 8),
                                     (list(np.linspace(0.1, 9.0, 501)), 33)])
def test_empirical_grid_equals_jax(trace, q):
    p = traces.EmpiricalDelay.from_trace(trace, q)
    j = jtr.EmpiricalDelay.from_trace(trace, q)
    assert p.probs.dtype == p.values_ms.dtype == torch.float32
    np.testing.assert_array_equal(p.probs.numpy(), np.asarray(j.probs))
    np.testing.assert_array_equal(p.values_ms.numpy(),
                                  np.asarray(j.values_ms))
    qq = [0.0, 0.123, 0.5, 0.77, 1.0]
    np.testing.assert_allclose(p.quantile(qq).numpy(),
                               np.asarray(j.quantile(jnp.asarray(qq))),
                               rtol=1e-6)


def test_empirical_quantiles_within_1pct_of_jax():
    """Quantiles within 1% where the trace's quantile function is flat;
    in its steep tail (0.61 -> 2.2 ms over the top 15%), where a 0.3%
    wobble of probability moves a quantile by several percent, the two
    samples' CDFs at the trace's upper quantiles agree within 3 sigma of
    the difference of two binomials."""
    p = traces.EmpiricalDelay.from_trace(TRACE, 64)
    j = jtr.EmpiricalDelay.from_trace(TRACE, 64)
    d = p.sample_hops(_gen(4), (N // 11, 11), latency.TO_LEARNER)
    dj = np.asarray(j.sample_hops(jax.random.PRNGKey(4), (N // 11, 11)))
    assert float(d.min()) >= min(TRACE) and float(d.max()) <= max(TRACE)
    _quantiles_close(d, dj, qs=[0.1, 0.25, 0.5, 0.75])
    for x in np.quantile(TRACE, [0.8, 0.9, 0.95, 0.99]):
        fp = float((d <= float(x)).double().mean())
        fj = float((dj <= x).mean())
        f = (fp + fj) / 2
        assert abs(fp - fj) <= 3 * np.sqrt(2 * f * (1 - f) / d.numel()), (
            x, fp, fj)


def test_empirical_rejects_what_jax_rejects():
    for bad in ([], [0.3, float("nan")], [0.3, -1.0]):
        with pytest.raises(ValueError):
            traces.EmpiricalDelay.from_trace(bad)
    with pytest.raises(ValueError, match="non-decreasing"):
        traces.EmpiricalDelay(torch.tensor([0.0, 0.5, 1.0]),
                              torch.tensor([1.0, 0.5, 2.0])).validate()


def test_delay_kinds_equal_jax():
    assert latency.delay_kinds() == jlat.delay_kinds()


def _models():
    """(port model, JAX model) pairs of every registered kind, wrappers
    nested."""
    pw, jw = _wans()
    crashed = [False, True, False, False, True, False, False, False, False,
               True, False]
    pe = traces.EmpiricalDelay.from_trace(TRACE, 16)
    je = jtr.EmpiricalDelay.from_trace(TRACE, 16)
    return [
        (latency.ShiftedLognormalDelay(), jlat.ShiftedLognormalDelay()),
        (latency.ShiftedLognormalDelay(0.3, -1.1, 0.6),
         jlat.ShiftedLognormalDelay(0.3, -1.1, 0.6)),
        (latency.ParetoDelay(scale_ms=0.8), jlat.ParetoDelay(scale_ms=0.8)),
        (pw[0], jw[0]), (pw[1], jw[1]),
        (pe, je),
        (latency.LossyDelay(pe, 0.02), jlat.LossyDelay(je, 0.02)),
        (latency.CrashedDelay(latency.LossyDelay(pw[0], 0.005),
                              torch.tensor(crashed)),
         jlat.CrashedDelay(jlat.LossyDelay(jw[0], 0.005),
                           jnp.asarray(crashed))),
    ]


@pytest.mark.parametrize("i", range(8))
def test_delay_to_config_equals_jax_and_round_trips(i):
    port, ref = _models()[i]
    cfg = latency.delay_to_config(port)
    want = jlat.delay_to_config(ref)
    assert json.loads(json.dumps(cfg)) == json.loads(json.dumps(want))
    # port -> config -> port, and JAX's config -> port, give the config back
    assert latency.delay_to_config(latency.delay_from_config(cfg, 11)) == cfg
    assert latency.delay_to_config(latency.delay_from_config(
        json.loads(json.dumps(want)), 11)) == cfg


def test_delay_from_config_shorthands_and_errors():
    cfg = {"kind": "wan", "inter_region_ms": 55.0, "n_regions": 3}
    assert latency.delay_to_config(latency.delay_from_config(cfg, 12)) == \
        jlat.delay_to_config(jlat.delay_from_config(cfg, 12))
    with pytest.raises(ValueError, match="cluster size"):
        latency.delay_from_config(cfg)
    trace = {"kind": "empirical", "n_quantiles": 64, "trace_ms": TRACE}
    assert latency.delay_to_config(latency.delay_from_config(trace)) == \
        jlat.delay_to_config(jlat.delay_from_config(trace))
    with pytest.raises(ValueError, match="unknown delay kind"):
        latency.delay_from_config({"kind": "gamma"})
    with pytest.raises(TypeError, match="unregistered"):
        latency.delay_to_config(object())
    model = latency.ParetoDelay()
    assert latency.delay_from_config(model) is model
    assert latency.delay_from_config(None) is None


def test_to_device_moves_once_and_keeps_what_is_placed():
    for port, _ in _models():
        assert latency.to_device(port, "cpu") is port
    model = latency.CrashedDelay(latency.WanDelay.symmetric(30.0, 5, 2),
                                 torch.tensor([True, False, False, False,
                                               False]))
    moved = latency.to_device(model, torch.device("meta"))
    assert moved is not model and moved.crashed.device.type == "meta"
    assert moved.inner.oneway_ms.device.type == "meta"
    assert model.crashed.device.type == "cpu"
