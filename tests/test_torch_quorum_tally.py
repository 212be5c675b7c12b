"""Plain PyTorch versions of the quorum-tally kernels (repro_torch) against
the JAX package's oracles (repro.kernels.quorum_tally.ref) and, in one small
case each, its Pallas kernels in interpret mode -- over the shape lists of
tests/test_kernels.py.  Inputs are made with numpy from a seed.

Tolerances: every integer output is compared exactly.  f32 latency sums
are compared to 1e-5 relative (the two sides reduce in different orders).
Sketch buckets come from ``log``, and XLA's and torch's CPU ``log`` may
differ in the last ulp: a latency within 4 ulp of a bucket edge may land one
bucket over.  ``assert_hist_match`` allows exactly that, finds those trials
and says so; any other histogram difference fails.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quorum_tally import kernel as jax_kernel
from repro.kernels.quorum_tally import ref as jax_ref
from repro.montecarlo.engine import saturation_depths as jax_depths
from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.montecarlo import streaming

from chip_smoke import masked_inputs

BINS = streaming.sketch_bins(0.01)
UND = 5e8


# ---------------------------------------------------------------------------
# Bucket-edge helpers (shared with the other test_torch_* files).
# ---------------------------------------------------------------------------

def near_edge(lat, precision: float = 0.01, ulps: int = 4) -> np.ndarray:
    """Bool mask of latencies within ``ulps`` f32 ulps of a sketch bucket
    edge, where XLA's and torch's ``log`` may bucket them differently."""
    x = np.maximum(np.asarray(lat, np.float64), streaming.SKETCH_MIN_MS)
    log_g = math.log(streaming.sketch_gamma(precision))
    r = np.log(x / streaming.SKETCH_MIN_MS) / log_g
    ulp_x = np.spacing(x.astype(np.float32)).astype(np.float64)
    ulp_r = np.spacing(r.astype(np.float32)).astype(np.float64)
    tol = ulps * (ulp_x / x / log_g + ulp_r)
    return np.abs(r - np.round(r)) <= tol


def assert_hist_match(h_port, h_ref, lat_of=None, precision=0.01, what=""):
    """Histograms equal, except that a latency within 4 ulp of a bucket edge
    may sit one bucket over.  ``lat_of(m)`` returns system m's decided
    latencies; it is called only when the histograms differ."""
    hp = np.asarray(h_port, np.int64)
    hr = np.asarray(h_ref, np.int64)
    assert hp.shape == hr.shape, (hp.shape, hr.shape)
    if np.array_equal(hp, hr):
        return
    assert lat_of is not None, f"{what}: histograms differ"
    log_g = math.log(streaming.sketch_gamma(precision))
    for m in np.flatnonzero((hp != hr).any(axis=-1)):
        lat = np.asarray(lat_of(m), np.float64)
        edge = near_edge(lat, precision)
        r = np.log(np.maximum(lat[edge], streaming.SKETCH_MIN_MS)
                   / streaming.SKETCH_MIN_MS) / log_g
        allowed = {int(b) for e in np.round(r) for b in (e, e + 1)}
        diff = hp[m] - hr[m]
        moved = set(np.flatnonzero(diff).tolist())
        assert moved <= allowed and np.abs(diff).sum() <= 2 * edge.sum(), (
            f"{what}: system {m} histogram differs in buckets "
            f"{sorted(moved)} beyond {int(edge.sum())} bucket-edge latencies")
        warnings.warn(f"{what}: system {m}: {int(edge.sum())} latencies lie "
                      f"within 4 ulp of a bucket edge and moved one bucket "
                      f"(buckets {sorted(moved)})")


def t(x, dtype=None):
    """numpy -> CPU torch tensor."""
    return torch.as_tensor(np.asarray(x, dtype))


def stream_inputs(seed: int, S: int, n: int, M: int, G: int, K: int,
                  quarters: bool = False):
    """tests/test_kernels.py's stream inputs made with numpy: integral
    weights, arrival times quantized to force ties, ~10% lost 2b lanes,
    trailing padding trials.  ``quarters``: weights and thresholds in
    quarters instead (non-integral, yet every partial sum exact in f32, so
    any order of addition gives the same crossing)."""
    r = np.random.default_rng(seed)
    votes = r.integers(-1, K, (S, n)).astype(np.int32)
    arrive = (np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
              ).astype(np.float32)
    classic = (np.floor(np.exp(r.standard_normal((S, n))) * 8.0) / 4.0
               ).astype(np.float32)
    val_arr = (np.floor(np.exp(r.standard_normal((S, K, n))) * 8.0) / 4.0
               + 0.25).astype(np.float32)
    lost = (votes[:, None, :] != np.arange(K)[None, :, None]) \
        | (r.random((S, K, n)) < 0.1)
    val_arr = np.where(lost, np.float32(1e9), val_arr)
    masks = []
    for _ in range(3):
        if quarters:
            masks.append((r.integers(0, 9, (M, G, n)) / 4.0
                          ).astype(np.float32))
            masks.append((r.integers(1, 4 * n + 8, (M, G)) / 4.0
                          ).astype(np.float32))
        else:
            masks.append(r.integers(0, 3, (M, G, n)).astype(np.float32))
            masks.append(r.integers(1, n + 2, (M, G)).astype(np.float32))
    valid = np.arange(S) < S - S // 7
    return [votes, val_arr, arrive, classic, *masks, valid]


def _port_stream(args, **kw):
    return ref.stream_tally_decide_hist(*[t(a) for a in args], **kw)


_jax_stream_jit = jax.jit(jax_ref.stream_tally_decide_hist,
                          static_argnames=("n_values", "k_sat", "precision",
                                           "bins", "undecided_ms"))


def _jax_stream(args, **kw):
    return _jax_stream_jit(*[jnp.asarray(a) for a in args], **kw)


def _assert_stream_equal(port, jax_out, args, kw, what):
    h_p, s_p = port
    h_j, s_j = jax_out

    def lat_of(m):
        d = ref.stream_decide(*[t(a) for a in args],
                              n_values=kw["n_values"], k_sat=kw["k_sat"],
                              undecided_ms=kw["undecided_ms"])
        keep = (d["fast"] | d["recovery"])[m]
        return d["latency_ms"][m][keep].numpy()

    assert_hist_match(h_p.numpy(), np.asarray(h_j), lat_of, what=what)
    for f in ("n_fast", "n_recovery", "n_undecided"):
        np.testing.assert_array_equal(s_p[f].numpy(), np.asarray(s_j[f]),
                                      err_msg=f"{what} {f}")
    np.testing.assert_array_equal(s_p["max_ms"].numpy(),
                                  np.asarray(s_j["max_ms"]))
    np.testing.assert_allclose(s_p["sum_ms"].numpy(),
                               np.asarray(s_j["sum_ms"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# tally_decide
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V", [2, 3, 4])
@pytest.mark.parametrize("S,n,q", [(100, 11, 7), (2049, 11, 9), (500, 7, 4)])
def test_tally_decide_matches_jax(S, n, q, V):
    votes = np.random.default_rng(S + V).integers(-1, V, (S, n)
                                                  ).astype(np.int32)
    got = ref.tally_decide(t(votes), V, q)
    want = jax_ref.tally_decide(jnp.asarray(votes), V, q)
    for g, w in zip(got, want):
        assert g.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tally_decide_ignores_missing_votes():
    votes = t([[0, 1, -1, -1, 0], [-1, -1, -1, -1, -1]], np.int32)
    counts, winner, max_cnt, reached = ref.tally_decide(votes, 2, 2)
    assert counts.tolist() == [[2, 1], [0, 0]]
    assert max_cnt.tolist() == [2, 0]
    assert int(winner[0]) == 0
    assert bool(reached[0]) and not bool(reached[1])


# ---------------------------------------------------------------------------
# masked_tally
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 4, 12])
@pytest.mark.parametrize("S,n,V", [(257, 9, 2), (1100, 11, 3), (100, 6, 4)])
def test_masked_tally_matches_jax(S, n, V, G):
    """Random integral weights, -1 votes, and (G >= 4) an all-padding row
    that must never be satisfied."""
    r = np.random.default_rng(S * 7 + G)
    votes = r.integers(-1, V, (S, n)).astype(np.int32)
    w = r.integers(0, 4, (G, n)).astype(np.float32)
    th = r.integers(1, n + 2, (G,)).astype(np.float32)
    if G >= 4:
        w[-1] = 0.0
        th[-1] = 2.0 ** 30
    got = ref.masked_tally(t(votes), t(w), t(th), V)
    want = jax_ref.masked_tally(jnp.asarray(votes), jnp.asarray(w),
                                jnp.asarray(th), V)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if G >= 4:
        assert bool((got[:, -1] == -1).all())


def test_masked_tally_explicit_grid_rows():
    from repro_torch.core.quorum import ExplicitQuorumSystem
    masks = ExplicitQuorumSystem.grid(3).to_masks()
    votes = np.full((3, 9), -1, np.int32)
    votes[0, :6] = 1
    votes[1, :6] = 1
    votes[1, 3] = 0
    votes[2, :] = 0
    got = ref.masked_tally(t(votes), t(masks.p2f_w), t(masks.p2f_t), 2)
    want = jax_ref.masked_tally(jnp.asarray(votes), jnp.asarray(masks.p2f_w),
                                jnp.asarray(masks.p2f_t), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0].max()) == 1 and int((got[0] >= 0).sum()) == 1
    assert bool((got[1] == -1).all()) and bool((got[2] == 0).all())


def test_masked_tally_lowest_value_wins_ties():
    got = ref.masked_tally(t([[0, 0, 1, 1]], np.int32),
                           torch.ones((1, 4)), t([2.0], np.float32), 2)
    assert int(got[0, 0]) == 0


# ---------------------------------------------------------------------------
# stream_tally_decide_hist
# ---------------------------------------------------------------------------

# (S, n, M, G, K, k_sat, quarters); the last three are the edges the CUDA
# kernel is held to on the card (G = 12 rows, K = 8 values, non-integral
# weights), held here also to JAX's Pallas kernel in interpret mode.
STREAM_CASES = [
    (300, 11, 2, 3, 2, (4, 5, 6), False),
    (1025, 9, 1, 6, 3, (9, 9, 9), False),
    (513, 7, 3, 1, 2, (2, 3, 2), False),
    (700, 11, 4, 2, 2, (11, 1, 7), False),
    (260, 12, 3, 12, 2, (12, 6, 9), False),
    (200, 9, 2, 4, 8, (9, 7, 9), False),
    (300, 11, 3, 5, 3, (11, 8, 10), True),
]


@pytest.mark.parametrize(
    "S,n,M,G,K,k_sat,quarters", STREAM_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}-k_sat{i}"
         + ("-quarters" if c[6] else "") for i, c in enumerate(STREAM_CASES)])
def test_stream_tally_decide_hist_matches_jax(S, n, M, G, K, k_sat, quarters):
    args = stream_inputs(S * 13 + M, S, n, M, G, K, quarters)
    kw = dict(n_values=K, k_sat=k_sat, precision=0.01, bins=BINS,
              undecided_ms=UND)
    port = _port_stream(args, **kw)
    what = f"stream {(S, n, M, G, K, k_sat, quarters)}"
    _assert_stream_equal(port, _jax_stream(args, **kw), args, kw, what)
    if G == 12 or K == 8 or quarters:
        jax_out = jax_kernel.stream_tally_decide_hist(
            *[jnp.asarray(a) for a in args], interpret=True, **kw)
        _assert_stream_equal(port, jax_out, args, kw,
                             what + " vs interpret kernel")
    h, s = port
    valid = int(args[-1].sum())
    np.testing.assert_array_equal(
        (s["n_fast"] + s["n_recovery"] + s["n_undecided"]).numpy(),
        np.full((M,), valid))
    np.testing.assert_array_equal(h.sum(-1).numpy(),
                                  (s["n_fast"] + s["n_recovery"]).numpy())


def test_stream_depth_saturation_invariance():
    """Past the table's saturation depths, k_sat changes nothing."""
    S, n, M, G, K = 400, 9, 2, 2, 2
    args = stream_inputs(11, S, n, M, G, K)
    w1, t1, w2c, t2c, w2f, t2f = args[4:10]
    depths = jax_depths({"p1_w": w1, "p1_t": t1, "p2c_w": w2c, "p2c_t": t2c,
                         "p2f_w": w2f, "p2f_t": t2f})
    kw = dict(n_values=K, precision=0.01, bins=BINS, undecided_ms=UND)
    h_a, s_a = _port_stream(args, k_sat=depths, **kw)
    h_b, s_b = _port_stream(args, k_sat=(n, n, n), **kw)
    assert torch.equal(h_a, h_b)
    for f in ("n_fast", "n_recovery", "n_undecided"):
        assert torch.equal(s_a[f], s_b[f])


def test_stream_all_invalid_block():
    args = stream_inputs(3, 128, 5, 1, 2, 2)
    args[-1] = np.zeros((128,), bool)
    h, s = _port_stream(args, n_values=2, k_sat=(3, 3, 3), precision=0.01,
                        bins=BINS, undecided_ms=UND)
    assert int(h.sum()) == 0 and int(s["n_fast"].sum()) == 0
    assert bool(torch.isneginf(s["max_ms"]).all())


# ---------------------------------------------------------------------------
# JAX's Pallas kernels in interpret mode, one small case each.
# ---------------------------------------------------------------------------

def test_plain_versions_match_jax_interpret_kernels():
    r = np.random.default_rng(5)
    votes = r.integers(-1, 3, (300, 11)).astype(np.int32)
    got = ref.tally_decide(t(votes), 3, 6)
    want = jax_kernel.tally_decide(jnp.asarray(votes), 3, jnp.int32(6),
                                   interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = r.integers(0, 3, (5, 11)).astype(np.float32)
    th = r.integers(1, 12, (5,)).astype(np.float32)
    np.testing.assert_array_equal(
        ref.masked_tally(t(votes), t(w), t(th), 3).numpy(),
        np.asarray(jax_kernel.masked_tally(jnp.asarray(votes),
                                           jnp.asarray(w), jnp.asarray(th),
                                           3, interpret=True)))
    args = stream_inputs(7, 300, 11, 2, 3, 2)
    kw = dict(n_values=2, k_sat=(4, 5, 6), precision=0.01, bins=BINS,
              undecided_ms=UND)
    jax_out = jax_kernel.stream_tally_decide_hist(
        *[jnp.asarray(a) for a in args], interpret=True, **kw)
    _assert_stream_equal(_port_stream(args, **kw), jax_out, args, kw,
                         "stream vs interpret kernel")


# ---------------------------------------------------------------------------
# Any K and any n: JAX's kernels pad n to 128 lanes and take any K; the
# port's plain versions (and its CUDA kernels, on the card) take the same.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,K", [(11, 9), (130, 2), (12, 12)])
def test_tally_decide_any_k_and_n_matches_jax_interpret(n, K):
    votes = np.random.default_rng(n * 100 + K).integers(
        -1, K, (96, n)).astype(np.int32)
    q = n // 3
    got = ref.tally_decide(t(votes), K, q)
    want = jax_kernel.tally_decide(jnp.asarray(votes), K, jnp.int32(q),
                                   interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,K", [(11, 9), (130, 2), (12, 12)])
def test_masked_tally_any_k_and_n_matches_jax_interpret(n, K):
    """Weights in quarters (exact sums in any order), thresholds reachable
    by one value's voters, and a padding row."""
    r = np.random.default_rng(n * 10 + K)
    votes = r.integers(-1, K, (64, n)).astype(np.int32)
    w = (r.integers(0, 9, (6, n)) / 4.0).astype(np.float32)
    th = (r.integers(1, 4 * n // K + 8, (6,)) / 4.0).astype(np.float32)
    w[-1], th[-1] = 0.0, 2.0 ** 30
    got = ref.masked_tally(t(votes), t(w), t(th), K)
    want = jax_kernel.masked_tally(jnp.asarray(votes), jnp.asarray(w),
                                   jnp.asarray(th), K, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[:, -1] == -1).all()) and bool((got[:, :-1] >= 0).any())


# The edges of the card's masked_tally design, held here to JAX's oracle and
# its Pallas kernel in interpret mode (chip_smoke.masked_inputs' rows, small
# sizes): thresholds <= 0, where an unvoted value (sum 0) answers; negative
# weights; K > n; K = 8 (a trial of 8 distinct values); unit and mixed rows
# at n = 33, past one 32-lane word.  (name, S, n, G, K, rows)
MASKED_EDGE_CASES = [
    ("t_nonpositive", 96, 12, 12, 3, "nonpositive"),
    ("negative_weights", 96, 11, 12, 3, "negative"),
    ("K_above_n", 64, 12, 8, 70, "mixed"),
    ("K_8", 96, 12, 8, 8, "negative"),
    ("unit_n33", 96, 33, 10, 3, "unit"),
    ("mixed_n33", 64, 33, 10, 40, "nonpositive"),
]


@pytest.mark.parametrize("case", MASKED_EDGE_CASES,
                         ids=[c[0] for c in MASKED_EDGE_CASES])
def test_masked_tally_edges_match_jax_interpret(case):
    """Equal to JAX's oracle and interpret kernel; a row with t <= 0 is
    answered wherever some value id below K went unvoted."""
    votes, w, th, K = masked_inputs(case, torch.device("cpu"))
    got = ops.masked_tally(votes, w, th, K)
    assert torch.equal(got, ref.masked_tally(votes, w, th, K))
    args = [jnp.asarray(x.numpy()) for x in (votes, w, th)]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ref.masked_tally(*args, K)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_kernel.masked_tally(*args, K,
                                                        interpret=True)))
    counts = ref.tally_votes(votes, K)
    unvoted = (counts == 0).any(dim=-1)                   # (S,)
    low = th <= 0                                         # (G,)
    assert bool((got[unvoted][:, low] >= 0).all())
    if case[-1] != "unit":
        # some answers are values that no acceptor of the trial voted
        ans = got.clamp(min=0).long()
        unvoted_answer = (got >= 0) & (torch.gather(counts, 1, ans) == 0)
        assert bool(unvoted_answer.any())


@pytest.mark.parametrize("K,want", [(4, 2), (2, -1), (1, -1)])
def test_masked_tally_lowest_unvoted_value(K, want):
    """Negative weights: values 0 and 1 are voted and sum to -2 and -1,
    below t = -0.5; value 2 is unvoted and sums to 0, which reaches it.  A
    positive row with t = -0.0 answers 0, voted or not."""
    votes = t([[0, 0, 1, -1]], np.int32)
    w = t([[-1.0, -1.0, -1.0, -1.0], [1.0, 0.5, 0.0, 2.0]], np.float32)
    th = t([-0.5, -0.0], np.float32)
    got = ops.masked_tally(votes, w, th, K)
    assert got.tolist() == [[want, 0]]
    args = [jnp.asarray(x.numpy()) for x in (votes, w, th)]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_kernel.masked_tally(*args, K,
                                                        interpret=True)))


@pytest.mark.parametrize("n,K", [(11, 1), (33, 4), (12, 8), (31, 9),
                                 (12, 70)])
def test_tally_votes_each_k_matches_jax_interpret(n, K):
    """K = 1 .. 8 (the card's K-specialised instances) and past them."""
    votes = np.random.default_rng(n * 7 + K).integers(
        -1, K, (70, n)).astype(np.int32)
    got = ops.tally_votes(t(votes), K)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_kernel.tally_votes(jnp.asarray(votes), K,
                                                       interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref.tally_votes(jnp.asarray(votes), K)))


def test_stream_any_k_matches_jax_interpret():
    """K = 9 values, past one pass of 8."""
    args = stream_inputs(9, 128, 11, 2, 3, 9)
    kw = dict(n_values=9, k_sat=(11, 9, 10), precision=0.01, bins=BINS,
              undecided_ms=UND)
    jax_out = jax_kernel.stream_tally_decide_hist(
        *[jnp.asarray(a) for a in args], interpret=True, **kw)
    _assert_stream_equal(_port_stream(args, **kw), jax_out, args, kw,
                         "stream K=9 vs interpret kernel")


@pytest.mark.parametrize("k_sat", [(6, 6, 6), (0, 0, 0)])
def test_stream_refuses_k_sat_out_of_range_on_cpu(k_sat):
    """As JAX's kernel does: a k_sat component outside [1, n] is refused
    with ValueError (before, the plain version clamped 6 to n = 5 and
    raised IndexError for 0)."""
    args = [t(a) for a in stream_inputs(0, 64, 5, 2, 3, 2)]
    kw = dict(n_values=2, k_sat=k_sat, precision=0.01, bins=BINS,
              undecided_ms=UND)
    with pytest.raises(ValueError, match="k_sat"):
        ops.stream_tally_decide_hist(*args, **kw)
    with pytest.raises(ValueError, match="k_sat"):
        jax_kernel.stream_tally_decide_hist(
            *[jnp.asarray(a.numpy()) for a in args], interpret=True, **kw)


def test_stream_refuses_chunks_of_2_24_trials_on_cpu():
    """A chunk of 2^24 trials would overflow exact f32 counts (JAX refuses
    it too); stride-0 views keep the inputs small."""
    S, n, K = 2 ** 24, 3, 2
    z = lambda *shape: torch.zeros((1,) * len(shape)).expand(*shape)
    w = torch.ones((1, 1, n))
    with pytest.raises(ValueError, match="overflows"):
        ops.stream_tally_decide_hist(
            torch.zeros((1, 1), dtype=torch.int32).expand(S, n),
            z(S, K, n), z(S, n), z(S, n), w, torch.ones((1, 1)), w,
            torch.ones((1, 1)), w, torch.ones((1, 1)),
            torch.ones((1,), dtype=torch.bool).expand(S), n_values=K,
            k_sat=(n, n, n), precision=0.01, bins=BINS, undecided_ms=UND)


# ---------------------------------------------------------------------------
# Dispatch: the tensor's device decides, nothing falls back.
# ---------------------------------------------------------------------------

def test_ops_runs_plain_versions_on_cpu_without_launching():
    ops.reset_launches()
    votes = t(np.random.default_rng(0).integers(-1, 2, (64, 5)), np.int32)
    for g, w in zip(ops.tally_decide(votes, 2, 3),
                    ref.tally_decide(votes, 2, 3)):
        assert torch.equal(g, w)
    w = torch.ones((2, 5))
    th = t([3.0, 9.0], np.float32)
    assert torch.equal(ops.masked_tally(votes, w, th, 2),
                       ref.masked_tally(votes, w, th, 2))
    assert torch.equal(ops.tally_votes(votes, 2), ref.tally_votes(votes, 2))
    assert ops.LAUNCHES == {"tally_votes": 0, "tally_decide": 0,
                            "masked_tally": 0, "stream_tally_decide_hist": 0,
                            "race_card_hist": 0, "masked_sat": 0,
                            "sorted_prefix": 0, "col_sketch": 0}


def test_ops_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA or"):
        ops.tally_decide(torch.zeros((4, 5), dtype=torch.int32,
                                     device="meta"), 2, 3)


@pytest.mark.parametrize("call", ["tally_votes", "tally_decide",
                                  "masked_tally", "stream", "race_card"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run a CPU tensor, and raise before building."""
    votes = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "tally_votes":
            kernel.tally_votes(votes, 2)
        elif call == "tally_decide":
            kernel.tally_decide(votes, 2, 3)
        elif call == "masked_tally":
            kernel.masked_tally(votes, torch.ones((1, 5)), torch.ones(1), 2)
        elif call == "race_card":
            kernel.race_card_hist(
                votes, torch.zeros((8, 5)), torch.zeros((8, 5)),
                torch.ones(8, dtype=torch.bool),
                torch.ones((1, 2), dtype=torch.int32), n_values=2,
                k_sat=(1, 1, 1), precision=0.01, bins=BINS, undecided_ms=UND)
        else:
            z = torch.zeros((1, 1, 5))
            kernel.stream_tally_decide_hist(
                votes, torch.zeros((8, 2, 5)), torch.zeros((8, 5)),
                torch.zeros((8, 5)), z, z[0], z, z[0], z, z[0],
                torch.ones(8, dtype=torch.bool), n_values=2, k_sat=(1, 1, 1),
                precision=0.01, bins=BINS, undecided_ms=UND)
