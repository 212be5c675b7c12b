"""The cardinality race chunk (``streaming._race_card_update``) through
``race_card_hist`` on the CPU, where the op runs its plain version.

``parent_update`` below is the chunk as it was composed before the op
existed (``engine._sample_race``'s presorts, the tally_decide winner,
``_win_sorted``, the scatters and one-hot products, then the gathers); it
is the oracle.  On the same draws, ``ref.race_card_hist`` and the unchanged
epilogue must give the same summary, and the op's seven tensors the
parent's on every cell the epilogue reads (the fast side's j < v; the op
leaves the others zero and -inf).  Shapes: n in {5, 11, 12, 130}, K in {2,
3, 9}, k_sat below n, both recovery rules, a ragged ``valid``.  Then
``race_stream`` against JAX's on injected JAX draws, at the n=11 sweep's
own table with ``k_max="auto"``.

Tolerances: integers and maxima exact; sums (f32, the same adds in another
grouping on the card) to 1e-5 relative; JAX's histograms as
``test_torch_streaming`` holds them (a latency within 4 ulp of a bucket
edge may land one bucket over).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.frontier import cardinality_family as j_cardinality_family
from repro.montecarlo import engine as jeng
from repro.montecarlo import streaming as jstream
from repro_torch.frontier import cardinality_family
from repro_torch.kernels.quorum_tally import ops
from repro_torch.montecarlo import engine, rng, streaming
from repro_torch.montecarlo.engine import UNDECIDED_MS
from repro_torch.montecarlo.streaming import _suffix, bucket_index
from repro_torch.sketch import occurrences
from test_torch_engine import inject_jax_draws
from test_torch_streaming import (assert_summary_match, decided_latencies,
                                  stream_keys)

OFFSETS = [0.0, 0.2]
INT_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist")


def parent_tensors(gen, table, layout, offsets, delay, valid, *, n,
                   k_proposers, chunk, k_sat, recovery, bins, precision):
    """The parent's per-chunk tensors, composed as before the op: FH, Fsum,
    Fmax, cnt, RH, Rsum, Rmax (FH, Fsum and Fmax on every cell)."""
    k2f = k_sat[2]
    draws = engine._sample_race(gen, offsets, delay, n=n,
                                k_proposers=k_proposers, samples=chunk,
                                card=True, k_sat=k_sat, recovery=recovery)
    pairs = layout[0].long()
    P_ = pairs.shape[0]
    B = bins
    win = engine._win_sorted(draws)
    C = win.shape[0]
    V = k2f + 1
    nfin = (win < UNDECIDED_MS).sum(dim=-1)
    fcap = torch.minimum(draws["max_cnt"].long(), nfin)
    vkey = torch.where(valid, fcap, V)
    oh = (vkey[:, None] == torch.arange(V)[None, :]).to(torch.float32)
    bwin = bucket_index(win, precision).long()
    fkey = (torch.arange(k2f)[None, :] * (V + 1) + vkey[:, None]) * B + bwin
    FH = occurrences(fkey, k2f * (V + 1) * B).reshape(k2f, V + 1, B)[:, :V]
    Fsum = win.T @ oh
    Fmax = torch.full((V + 1, k2f), -math.inf).scatter_reduce_(
        0, vkey[:, None].expand(C, k2f), win, "amax")[:V].T
    cnt = occurrences(vkey, V + 1)[:V]
    t_rec = (draws["sorted_arrive"][:, pairs[:, 0] - 1]
             + draws["sorted_classic"][:, pairs[:, 1] - 1])
    dec = t_rec < UNDECIDED_MS
    brec = torch.where(dec, bucket_index(t_rec, precision).long(), B)
    rkey = (torch.arange(P_)[None, :] * (V + 1) + vkey[:, None]) * (B + 1) \
        + brec
    RH = occurrences(rkey, P_ * (V + 1) * (B + 1)).reshape(
        P_, V + 1, B + 1)[:, :V]
    Rsum = torch.where(dec, t_rec, 0.0).T @ oh
    Rmax = torch.full((V + 1, P_), -math.inf).scatter_reduce_(
        0, vkey[:, None].expand(C, P_), torch.where(dec, t_rec, -math.inf),
        "amax")[:V].T
    return FH, Fsum, Fmax, cnt, RH, Rsum, Rmax


def parent_update(state, gen, table, layout, offsets, delay, valid, *, n,
                  k_proposers, chunk, k_sat, recovery="coordinated"):
    """The parent's ``_race_card_update``, verbatim after its tensors."""
    pair_of_m = layout[1]
    q2f = table["q"][:, 2].long()
    B = state.bins
    FH, Fsum, Fmax, cnt, RH, Rsum, Rmax = parent_tensors(
        gen, table, layout, offsets, delay, valid, n=n,
        k_proposers=k_proposers, chunk=chunk, k_sat=k_sat, recovery=recovery,
        bins=B, precision=state.precision)
    hist_fast = _suffix(FH, 1)[q2f - 1, q2f]
    sum_fast = _suffix(Fsum, 1)[q2f - 1, q2f]
    SFmax = torch.flip(torch.cummax(torch.flip(Fmax, (1,)), dim=1).values,
                       (1,))
    max_fast = SFmax[q2f - 1, q2f]
    n_fast = _suffix(cnt, 0)[q2f]
    rec_rows = torch.cumsum(RH, dim=1, dtype=torch.int32)[pair_of_m,
                                                          q2f - 1]
    hist_rec = rec_rows[:, :B]
    n_und = rec_rows[:, B]
    n_rec = hist_rec.sum(dim=-1, dtype=torch.int32)
    sum_rec = torch.cumsum(Rsum, dim=1)[pair_of_m, q2f - 1]
    max_rec = torch.cummax(Rmax, dim=1).values[pair_of_m, q2f - 1]
    n_valid = valid.sum().to(torch.int32).expand(q2f.shape)
    return state._absorb(
        n_trials=n_valid, n_fast=n_fast, n_recovery=n_rec,
        n_undecided=n_und, cnt=(n_fast + n_rec).to(torch.float32),
        lat_sum=sum_fast + sum_rec,
        lat_max=torch.maximum(max_fast, max_rec),
        hist=hist_fast + hist_rec)


def q_table(n: int, M: int, qmax: tuple, seed: int) -> dict:
    """M cardinality thresholds (q1, q2c, q2f), each in [1, its qmax], the
    maxima present: all that ``_race_card_update`` reads of a table."""
    r = np.random.default_rng(seed)
    q = np.stack([r.integers(1, m + 1, M) for m in qmax], axis=1)
    q[0] = qmax
    return {"q": torch.as_tensor(q.astype(np.int32))}


def sweep_table() -> dict:
    return engine.build_mask_table([m.masks() for m in
                                    cardinality_family(11)], device="cpu")


# (n, K, systems or "sweep", q maxima (None: n each), chunk, valid trials)
CASES = [
    (5, 2, 6, None, 300, 300),
    (11, 2, "sweep", None, 512, 389),
    (12, 3, 9, (9, 7, 8), 400, 277),
    (130, 9, 5, (130, 100, 40), 200, 141),
]


def _case(n, K, M, qmax, chunk, recovery):
    if M == "sweep":
        table = sweep_table()
        k_sat = streaming._resolve_k_sat(table, "auto", n)
    else:                       # the q maxima: saturation_depths' k_sat
        table = q_table(n, M, qmax or (n, n, n), n + K)
        k_sat = tuple(int(k) for k in table["q"].amax(dim=0))
    layout = streaming._card_layout(table, recovery)
    return table, k_sat, layout


@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
@pytest.mark.parametrize("n,K,M,qmax,chunk,nvalid", CASES)
def test_race_card_update_matches_parent(n, K, M, qmax, chunk, nvalid,
                                         recovery):
    """ref.race_card_hist + the epilogue against the parent's chunk, on the
    same draws, from a fresh state and folded into a nonzero one."""
    table, k_sat, layout = _case(n, K, M, qmax, chunk, recovery)
    offsets = torch.tensor([0.0, 0.2, 0.35][:K] + [0.5] * max(0, K - 3))
    delay = streaming.default_delay()
    valid = torch.arange(chunk) < nvalid
    m = table["q"].shape[0]
    got = want = streaming.StreamSummary.zeros(m)
    for i in range(2):
        key = rng.derive(rng.root(40 + n), rng.CHUNK_DOMAIN, i)
        kw = dict(n=n, k_proposers=K, chunk=chunk, k_sat=k_sat,
                  recovery=recovery)
        got = streaming._race_card_update(got, rng.generator(key, "cpu"),
                                          table, layout, offsets, delay,
                                          valid, **kw)
        want = parent_update(want, rng.generator(key, "cpu"), table, layout,
                             offsets, delay, valid, **kw)
    for f in INT_FIELDS + ("max_ms",):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.mean_ms, want.mean_ms, rtol=1e-5,
                               atol=0.0)
    assert int(got.n_trials.min()) == 2 * nvalid
    assert int(got.n_decided.sum()) > 0


@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
@pytest.mark.parametrize("n,K,M,qmax,chunk,nvalid", CASES)
def test_race_card_hist_tensors_match_parent(n, K, M, qmax, chunk, nvalid,
                                             recovery):
    """The op's seven tensors against the parent's: every cell the
    epilogue reads equal (sums to 1e-5), the fast side's j >= v cells zero
    and -inf."""
    table, k_sat, layout = _case(n, K, M, qmax, chunk, recovery)
    offsets = torch.tensor([0.0, 0.2, 0.35][:K] + [0.5] * max(0, K - 3))
    delay = streaming.default_delay()
    valid = torch.arange(chunk) < nvalid
    bins = streaming.sketch_bins(0.01)
    key = rng.root(50 + n)
    ks = k_sat if recovery == "coordinated" else (k_sat[0], k_sat[2],
                                                  k_sat[2])
    raw = engine._draw_race(rng.generator(key, "cpu"), offsets, delay, n=n,
                            k_proposers=K, samples=chunk, recovery=recovery)
    got = ops.race_card_hist(raw["votes"], raw["arrive"], raw["classic"],
                             valid, layout[0], n_values=K, k_sat=ks,
                             precision=0.01, bins=bins,
                             undecided_ms=float(UNDECIDED_MS))
    want = parent_tensors(rng.generator(key, "cpu"), table, layout, offsets,
                          delay, valid, n=n, k_proposers=K, chunk=chunk,
                          k_sat=k_sat, recovery=recovery, bins=bins,
                          precision=0.01)
    FH, Fsum, Fmax, cnt, RH, Rsum, Rmax = got
    k2f, V, P = k_sat[2], k_sat[2] + 1, layout[0].shape[0]
    assert FH.shape == (k2f, V, bins) and RH.shape == (P, V, bins + 1)
    assert Fsum.shape == Fmax.shape == (k2f, V)
    assert Rsum.shape == Rmax.shape == (P, V) and cnt.shape == (V,)
    assert FH.dtype == RH.dtype == cnt.dtype == torch.int32
    below = torch.arange(k2f)[:, None] < torch.arange(V)[None, :]
    assert torch.equal(FH[below], want[0][below])
    assert torch.equal(Fmax[below], want[2][below])
    torch.testing.assert_close(Fsum[below], want[1][below], rtol=1e-5,
                               atol=0.0)
    assert not FH[~below].any() and not Fsum[~below].any()
    assert bool(torch.isneginf(Fmax[~below]).all())
    for a, b in ((cnt, want[3]), (RH, want[4]), (Rmax, want[6])):
        assert torch.equal(a, b)
    torch.testing.assert_close(Rsum, want[5], rtol=1e-5, atol=0.0)
    assert int(cnt.sum()) == nvalid
    assert int(RH.sum()) == nvalid * P


def test_race_card_hist_refuses_what_the_reference_refuses():
    votes = torch.zeros((8, 5), dtype=torch.int32)
    z = torch.zeros((8, 5))
    for ks in ((6, 6, 6), (0, 1, 1), (1, 1)):
        with pytest.raises(ValueError, match="k_sat"):
            ops.race_card_hist(votes, z, z, torch.ones(8, dtype=torch.bool),
                               torch.ones((1, 2), dtype=torch.int32),
                               n_values=2, k_sat=ks, precision=0.01,
                               bins=10, undecided_ms=5e8)


@pytest.mark.parametrize("pair", [(0, 1), (1, 0), (4, 2), (2, 4)])
def test_race_card_hist_refuses_pairs_out_of_range(pair):
    """A recovery pair outside [1, k1] x [1, k_rec] is refused, not wrapped
    to the last column or clamped."""
    votes = torch.zeros((8, 5), dtype=torch.int32)
    z = torch.zeros((8, 5))
    pairs = torch.tensor([(1, 1), pair], dtype=torch.int32)
    with pytest.raises(ValueError, match="recovery pairs"):
        ops.race_card_hist(votes, z, z, torch.ones(8, dtype=torch.bool),
                           pairs, n_values=2, k_sat=(3, 3, 3),
                           precision=0.01, bins=10, undecided_ms=5e8)


@pytest.mark.parametrize("recovery", ["coordinated", "uncoordinated"])
def test_sweep_race_stream_matches_jax(monkeypatch, recovery):
    """race_stream on the n=11 sweep's 271-system table with JAX's chunk
    draws injected, against JAX's race_stream: 3 chunks, the last ragged."""
    trials, chunk = 2600, 1024
    port_t = sweep_table()
    jax_t = jeng.build_mask_table([m.masks() for m in
                                   j_cardinality_family(11)])
    key, jkey = rng.root(61), jax.random.PRNGKey(61)
    inject_jax_draws(monkeypatch, stream_keys(key, jkey, trials, chunk))
    got = streaming.race_stream(key, port_t, OFFSETS, n=11, k_proposers=2,
                                trials=trials, chunk=chunk, k_max="auto",
                                recovery=recovery)
    want = jstream.race_stream(jkey, jax_t, jnp.asarray(OFFSETS), n=11,
                               k_proposers=2, trials=trials, chunk=chunk,
                               shard=False, k_max="auto", recovery=recovery)
    lat_of = decided_latencies("race", key, port_t, n=11, k_proposers=2,
                               trials=trials, chunk=chunk, recovery=recovery)
    assert_summary_match(got, want, lat_of, f"sweep race {recovery}")
    assert int(got.n_trials.min()) == trials
