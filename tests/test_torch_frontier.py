"""The slice as a whole: repro_torch.frontier against the live JAX frontier
(repro.frontier), plus the copied framework-free modules and the sweep's
entry point.

With JAX's draws injected into both stream passes, ``score_systems`` of the
port and of JAX must agree on labels, frontier mask, every integer stream
field and the maxima; histograms exactly up to bucket-edge latencies (see
test_torch_quorum_tally); axis values to 1e-6 relative (sketch quantiles
are bucket representatives computed with f32 ``pow``).
"""
import jax
import numpy as np
import pytest

from repro.core import quorum as jq
from repro.frontier import families as jfam
from repro.frontier import pareto as jpareto
from repro.frontier import score as jscore
from repro_torch.core import quorum as pq
from repro_torch.frontier import families as pfam
from repro_torch.frontier import pareto as ppareto
from repro_torch.frontier import score_systems
from repro_torch.frontier import __main__ as sweep_module
from repro_torch.frontier.__main__ import main as sweep_main
from repro_torch.frontier.__main__ import run_relaxed
from repro_torch.montecarlo import engine, rng
from test_torch_engine import inject_jax_draws
from test_torch_streaming import (assert_summary_match, decided_latencies,
                                  stream_keys)


def members(pkg: str, kind: str):
    fam, q = (pfam, pq) if pkg == "port" else (jfam, jq)
    if kind == "card":
        return fam.cardinality_family(5)
    n = 6
    card = [fam.Member(f"card.{t}", s) for t, s in
            (("headline", q.QuorumSpec.paper_headline(n)),
             ("fast_paxos", q.QuorumSpec.fast_paxos(n)),
             ("majority", q.QuorumSpec.majority_fast(n)))]
    return card + fam.grid_family(n) + fam.weighted_family(n)


@pytest.mark.parametrize("kind,recovery,trials", [
    ("card", "coordinated", 5000),
    ("card", "uncoordinated", 5000),
    ("mixed", "coordinated", 5000),
    ("mixed", "uncoordinated", 5000),
    ("mixed", "coordinated", 1500),          # T <= chunk: materializing
])
def test_score_systems_matches_jax_on_jax_draws(monkeypatch, kind, recovery,
                                                trials):
    chunk, seed = 2048, 3
    key = rng.root(seed)
    k_fast = rng.derive(key, rng.PASS_DOMAIN, rng.FAST_PASS)
    k_race = rng.derive(key, rng.PASS_DOMAIN, rng.RACE_PASS)
    j_fast, j_race = jax.random.split(jax.random.PRNGKey(seed))
    keys = stream_keys(k_fast, j_fast, trials, chunk)
    keys.update(stream_keys(k_race, j_race, trials, chunk))
    inject_jax_draws(monkeypatch, keys)
    got = score_systems(members("port", kind), trials=trials, chunk=chunk,
                        seed=seed, recovery=recovery, device="cpu")
    want = jscore.score_systems(members("jax", kind), trials=trials,
                                chunk=chunk, seed=seed, recovery=recovery,
                                shard=False)
    assert got.labels == want.labels
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    np.testing.assert_allclose(got.values, np.asarray(want.values),
                               rtol=1e-6)
    table = engine.build_mask_table([m.masks(6 if kind == "mixed" else 5)
                                     for m in members("port", kind)],
                                    device="cpu")
    n = table["p1_w"].shape[-1]
    for p, path, k in (("fast", "fast_path", k_fast),
                       ("race", "race", k_race)):
        lat_of = decided_latencies(path, k, table, n=n, k_proposers=2,
                                   trials=trials, chunk=chunk,
                                   recovery=recovery)
        assert_summary_match(got.streams[p], want.streams[p], lat_of,
                             f"{kind} {p}")
    assert set(got.wall_s) == {"fast", "race"}


def test_score_systems_needs_an_explicit_cpu_device():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score_systems(members("port", "card"), trials=100)


# ---------------------------------------------------------------------------
# The copied framework-free modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 6, 9, 11, 12])
def test_families_match_jax(n):
    """Labels and masks at every n; the brute-force crash budgets (slow at
    large n) up to n = 9."""
    for name in pfam.FAMILIES:
        got, want = pfam.family(name, n), jfam.family(name, n)
        assert [m.label for m in got] == [m.label for m in want]
        for a, b in zip(got, want):
            ma, mb = a.masks(n), b.masks(n)
            for k in ("p1_w", "p1_t", "p2c_w", "p2c_t", "p2f_w", "p2f_t"):
                np.testing.assert_array_equal(getattr(ma, k), getattr(mb, k))
            if n <= 9:
                assert ma.fault_tolerance() == mb.fault_tolerance()


def test_pareto_mask_matches_jax_on_random_scores():
    r = np.random.default_rng(9)
    for _ in range(20):
        vals = r.integers(0, 6, (40, 4)).astype(np.float64) * 0.37
        vals[r.random(vals.shape) < 0.05] = np.nan
        axes_p = (ppareto.Axis("a", eps=0.01, relative=True),
                  ppareto.Axis("b", eps=0.3), ppareto.Axis("c", maximize=True),
                  ppareto.Axis("d"))
        axes_j = tuple(jpareto.Axis(a.name, a.maximize, a.eps, a.relative)
                       for a in axes_p)
        np.testing.assert_array_equal(ppareto.pareto_mask(vals, axes_p),
                                      jpareto.pareto_mask(vals, axes_j))


# ---------------------------------------------------------------------------
# The sweep's entry point, at --smoke size on the CPU.
# ---------------------------------------------------------------------------

def test_sweep_entry_point_smoke_on_cpu(monkeypatch, capsys):
    """The CLI end to end, its checks included, cut to 2*10^5 trials per
    pass to stay quick on the CPU."""
    monkeypatch.setattr(sweep_module, "TRIALS_SMOKE", 200_000)
    sweep_main(["--smoke", "--device", "cpu"])
    rows = dict(line.split(",", 1) for line in
                capsys.readouterr().out.strip().splitlines())
    assert rows["sweep.n_valid_configs"] == "271"
    assert rows["sweep.trials"] == "200000"
    assert rows["sweep.streamed_vs_perspec_checked"] == "3"
    assert int(rows["sweep.n_frontier_systems"]) >= 11


def test_relaxed_entry_point_smoke_on_cpu(monkeypatch):
    monkeypatch.setattr(sweep_module, "TRIALS_SMOKE", 100_000)
    out = run_relaxed(quick=True, device="cpu")
    rows = dict(out["rows"])
    assert rows["relaxed.n_joint_systems"] == 396
    assert rows["relaxed.n_relaxed_on_frontier"] > 0
