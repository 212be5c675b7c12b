"""repro_torch.montecarlo.streaming against the live JAX streaming entry
points (repro.montecarlo.streaming, ``shard=False``).

With JAX's chunk draws injected (chunk c of the port's stream draws what
JAX's chunk c draws from ``fold_in(key, c)``), every lowering of the port
-- the sort-free cardinality race (tally_decide), the fused masked race
(stream_tally_decide_hist, plain version on the CPU), the full-sort path,
and the fast / classic paths -- must give the same counts, maxima and
histograms as JAX's, with trials > chunk and a ragged last chunk, and in
the T <= chunk materializing case.

Tolerances: counts and maxima exact; histograms exact up to latencies
within 4 ulp of a bucket edge (XLA's and torch's CPU ``log`` may differ in
the last ulp; ``assert_hist_match`` finds and reports them); the running
mean to 1e-5 relative (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.montecarlo import streaming as jstream
from repro_torch.montecarlo import engine, rng, streaming
from test_torch_engine import inject_jax_draws, tables
from test_torch_quorum_tally import assert_hist_match, near_edge

TRIALS, CHUNK = 5000, 2048          # 3 chunks, the last one ragged
OFFSETS = [0.0, 0.2]
INT_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided")


def stream_keys(key, jkey, trials, chunk):
    """Port key -> JAX key for the whole stream and each of its chunks."""
    keys = {key: jkey}
    for i in range(-(-trials // chunk)):
        keys[rng.derive(key, rng.CHUNK_DOMAIN, i)] = jax.random.fold_in(
            jkey, i)
    return keys


def decided_latencies(path, key, table, *, n, k_proposers, trials, chunk,
                      recovery="coordinated"):
    """System m's decided latencies over the stream, from the port's
    materialized outcomes on the same (injected) draws."""
    outs = []
    if trials <= chunk:
        if path == "race":
            outs.append((engine.race(key, table, OFFSETS, n=n,
                                     k_proposers=k_proposers,
                                     samples=trials, recovery=recovery),
                         torch.ones(trials, dtype=torch.bool)))
    else:
        lanes = torch.arange(chunk)
        for i in range(-(-trials // chunk)):
            gen = rng.generator(rng.derive(key, rng.CHUNK_DOMAIN, i), "cpu")
            out = streaming._chunk_outcomes(
                path, gen, table, torch.tensor(OFFSETS), None, n=n,
                k_proposers=k_proposers, chunk=chunk, recovery=recovery)
            outs.append((out, lanes < min(chunk, trials - i * chunk)))

    def lat_of(m):
        parts = []
        for out, valid in outs:
            keep = (out["reached_fast"][m] | out["recovery"][m]) & valid
            parts.append(out["latency_ms"][m][keep].numpy())
        return np.concatenate(parts)
    return lat_of


def assert_summary_match(port, jax_s, lat_of, what):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(jax_s, f)),
                                      err_msg=f"{what} {f}")
    np.testing.assert_array_equal(port.max_ms.numpy(),
                                  np.asarray(jax_s.max_ms))
    assert_hist_match(port.hist.numpy(), np.asarray(jax_s.hist), lat_of,
                      what=what)
    np.testing.assert_allclose(port.mean_ms.numpy(),
                               np.asarray(jax_s.mean_ms), rtol=1e-5)


def _run_pair(monkeypatch, path, kind, *, trials=TRIALS, chunk=CHUNK,
              k_max="auto", recovery="coordinated", seed=31):
    port_t, jax_t = tables(kind)
    n = port_t["p1_w"].shape[-1]
    key, jkey = rng.root(seed), jax.random.PRNGKey(seed)
    inject_jax_draws(monkeypatch, stream_keys(key, jkey, trials, chunk))
    if path == "race":
        got = streaming.race_stream(key, port_t, OFFSETS, n=n, k_proposers=2,
                                    trials=trials, chunk=chunk, k_max=k_max,
                                    recovery=recovery)
        want = jstream.race_stream(jkey, jax_t, jnp.asarray(OFFSETS), n=n,
                                   k_proposers=2, trials=trials, chunk=chunk,
                                   shard=False, k_max=k_max,
                                   recovery=recovery)
    else:
        p_fn = getattr(streaming, path + "_stream")
        j_fn = getattr(jstream, path + "_stream")
        got = p_fn(key, port_t, n=n, trials=trials, chunk=chunk, k_max=k_max)
        want = j_fn(jkey, jax_t, n=n, trials=trials, chunk=chunk,
                    shard=False, k_max=k_max)
    lat_of = decided_latencies(path, key, port_t, n=n, k_proposers=2,
                               trials=trials, chunk=chunk, recovery=recovery)
    assert_summary_match(got, want, lat_of, f"{path} {kind} {k_max}")
    assert int(got.n_trials.min()) == trials
    return got


@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_race_stream_matches_jax(monkeypatch, kind, recovery):
    """card: _race_card_update through tally_decide; mixed: the fused
    stream_tally_decide_hist lowering."""
    _run_pair(monkeypatch, "race", kind, recovery=recovery)


@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_full_sort_race_stream_matches_jax(monkeypatch, kind):
    _run_pair(monkeypatch, "race", kind, k_max=None)


@pytest.mark.parametrize("path", ["fast_path", "classic_path"])
@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_fast_and_classic_streams_match_jax(monkeypatch, path, kind):
    _run_pair(monkeypatch, path, kind)


@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_small_stream_is_the_materializing_path(monkeypatch, kind):
    _run_pair(monkeypatch, "race", kind, trials=1500, chunk=2048)


# ---------------------------------------------------------------------------
# The summary itself.
# ---------------------------------------------------------------------------

def test_summary_round_trip_queries_and_merge_match_jax(monkeypatch):
    port_t, jax_t = tables("card")
    key, jkey = rng.root(32), jax.random.PRNGKey(32)
    a = jstream.race_stream(jkey, jax_t, jnp.asarray(OFFSETS), n=5,
                            k_proposers=2, trials=TRIALS, chunk=CHUNK,
                            shard=False)
    b = jstream.race_stream(jax.random.PRNGKey(33), jax_t,
                            jnp.asarray(OFFSETS), n=5, k_proposers=2,
                            trials=3000, chunk=CHUNK, shard=False)
    leaves = lambda s: {f: np.asarray(getattr(s, f))
                        for f in streaming._FIELDS}
    pa = streaming.StreamSummary.from_numpy(leaves(a))
    pb = streaming.StreamSummary.from_numpy(leaves(b))
    for f, v in pa.to_numpy().items():
        np.testing.assert_array_equal(v, leaves(a)[f])
    qs = [0.5, 0.9, 0.99, 0.999]
    # bucket_value's f32 pow may differ from XLA's in the last ulp.
    np.testing.assert_allclose(pa.quantile(qs).numpy(),
                               np.asarray(a.quantile(jnp.asarray(qs))),
                               rtol=1e-6)
    got, want = pa.summary(), a.summary()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    merged, jmerged = pa.merge(pb), a.merge(b)
    for f in INT_FIELDS + ("hist", "max_ms"):
        np.testing.assert_array_equal(getattr(merged, f).numpy(),
                                      np.asarray(getattr(jmerged, f)))
    np.testing.assert_allclose(merged.mean_ms.numpy(),
                               np.asarray(jmerged.mean_ms), rtol=1e-6)


def test_sketch_quantiles_within_precision_of_exact():
    r = np.random.default_rng(4)
    lat = (0.3 + np.exp(r.normal(-0.5, 0.8, (3, 20_000)))).astype(np.float32)
    out = {"latency_ms": torch.from_numpy(lat),
           "reached_fast": torch.ones(lat.shape, dtype=torch.bool),
           "recovery": torch.zeros(lat.shape, dtype=torch.bool),
           "undecided": torch.zeros(lat.shape, dtype=torch.bool)}
    s = streaming.StreamSummary.from_outcomes(out, 0.01)
    for q in (0.5, 0.95, 0.99, 0.999):
        est = s.quantile(q).numpy()
        exact = np.quantile(lat, q, axis=-1, method="inverted_cdf")
        assert (np.abs(est - exact) <= 0.01 * exact * (1 + 1e-5)).all(), q


def test_bucket_index_matches_jax_off_bucket_edges():
    r = np.random.default_rng(5)
    x = np.concatenate([0.25 + np.exp(-1.2 + 0.55 * r.standard_normal(
        500_000)) * 3, r.uniform(1e-3, 1e4, 500_000)]).astype(np.float32)
    got = streaming.bucket_index(torch.from_numpy(x), 0.01).numpy()
    want = np.asarray(jstream.bucket_index(jnp.asarray(x), 0.01))
    differ = got != want
    edge = near_edge(x)
    assert not (differ & ~edge).any()
    assert (np.abs(got - want) <= 1).all()
    if differ.any():
        print(f"{int(differ.sum())} of {x.size} values within 4 ulp of a "
              f"bucket edge land one bucket over")


def test_resolve_k_sat():
    table, _ = tables("mixed")
    depths = engine.saturation_depths(table)
    assert streaming._resolve_k_sat(table, "auto", 6) == depths
    assert streaming._resolve_k_sat(table, None, 6) is None
    assert streaming._resolve_k_sat(table, 6, 6) == (6, 6, 6)
    with pytest.raises(ValueError, match="below the table's saturation"):
        streaming._resolve_k_sat(table, (1, 1, 1), 6)


@pytest.mark.parametrize("kind", ["card", "mixed"])
def test_sort_free_lowerings_match_full_sort_on_own_draws(kind):
    table, _ = tables(kind)
    n = table["p1_w"].shape[-1]
    for path in ("race", "fast_path", "classic_path"):
        runs = []
        for k_max in ("auto", None):
            if path == "race":
                runs.append(streaming.race_stream(
                    rng.root(8), table, OFFSETS, n=n, k_proposers=2,
                    trials=TRIALS, chunk=CHUNK, k_max=k_max))
            else:
                runs.append(getattr(streaming, path + "_stream")(
                    rng.root(8), table, n=n, trials=TRIALS, chunk=CHUNK,
                    k_max=k_max))
        for f in INT_FIELDS + ("hist", "max_ms"):
            assert torch.equal(getattr(runs[0], f), getattr(runs[1], f)), (
                path, f)
