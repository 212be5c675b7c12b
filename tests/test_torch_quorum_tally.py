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


def stream_inputs(seed: int, S: int, n: int, M: int, G: int, K: int):
    """tests/test_kernels.py's stream inputs made with numpy: integral
    weights, arrival times quantized to force ties, ~10% lost 2b lanes,
    trailing padding trials."""
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

@pytest.mark.parametrize("S,n,M,G,K,k_sat", [
    (300, 11, 2, 3, 2, (4, 5, 6)),
    (1025, 9, 1, 6, 3, (9, 9, 9)),
    (513, 7, 3, 1, 2, (2, 3, 2)),
    (700, 11, 4, 2, 2, (11, 1, 7)),
])
def test_stream_tally_decide_hist_matches_jax(S, n, M, G, K, k_sat):
    args = stream_inputs(S * 13 + M, S, n, M, G, K)
    kw = dict(n_values=K, k_sat=k_sat, precision=0.01, bins=BINS,
              undecided_ms=UND)
    port = _port_stream(args, **kw)
    _assert_stream_equal(port, _jax_stream(args, **kw), args, kw,
                         f"stream {(S, n, M, G, K, k_sat)}")
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
    assert ops.LAUNCHES == {"tally_decide": 0, "masked_tally": 0,
                            "stream_tally_decide_hist": 0}


def test_ops_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA or"):
        ops.tally_decide(torch.zeros((4, 5), dtype=torch.int32,
                                     device="meta"), 2, 3)


@pytest.mark.parametrize("call", ["tally_decide", "masked_tally", "stream"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run a CPU tensor, and raise before building."""
    votes = torch.zeros((8, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "tally_decide":
            kernel.tally_decide(votes, 2, 3)
        elif call == "masked_tally":
            kernel.masked_tally(votes, torch.ones((1, 5)), torch.ones(1), 2)
        else:
            z = torch.zeros((1, 1, 5))
            kernel.stream_tally_decide_hist(
                votes, torch.zeros((8, 2, 5)), torch.zeros((8, 5)),
                torch.zeros((8, 5)), z, z[0], z, z[0], z, z[0],
                torch.ones(8, dtype=torch.bool), n_values=2, k_sat=(1, 1, 1),
                precision=0.01, bins=BINS, undecided_ms=UND)
