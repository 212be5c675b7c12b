"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one; they import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Integer outputs must be equal; the fused kernel's f32 latency sum reduces
per-block partials, so it is compared to 1e-5 relative; maxima are exact.
The SSD kernel is held to its plain chunked version and to the recurrence
at the JAX kernel tests' tolerances (1e-3 f32, 3e-2 with bf16 xw); its
tensor-core instance (bf16 xw, B and C) also to its plain emulation, y to
3e-2 times max(|plain|, min(1, max|plain|)) (y is rounded to bf16; the
serving shapes' y reach about 10, where one bf16 ulp is 0.0625), the f32
state to 1e-3 times min(1, max|plain|).  Flash attention is held to its
plain version on f32 inputs at the JAX kernel tests' 2e-5 (f32) and 2e-2
(bf16: the output is rounded to bf16), and its bf16 tensor-core instance
to its plain emulation at 2e-2 too; RMSNorm at 1e-5 (f32) and 5e-2 (bf16),
each times max(1, |plain|) (outputs reach about 20, where one bf16 ulp is
0.125).  The tests of the tensor-core instances check their own launch
counters.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import model as model_mod
from repro_torch.models.ssm import ssd_chunked
from repro_torch.montecarlo import streaming

from chip_smoke import (COL_SKETCH_CASES, MASKED_CASES, MASKED_SAT_CASES,
                        RACE_CARD_CASES, TALLY_VOTES_CASES, col_sketch_inputs,
                        masked_inputs, masked_sat_inputs, race_card_inputs,
                        sequential_sat, ssd_test_inputs, stream_test_inputs)

BINS = streaming.sketch_bins(0.01)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("V", [2, 3, 4])
@pytest.mark.parametrize("S,n,q", [(100, 11, 7), (2049, 11, 9), (500, 7, 4),
                                   (16384, 11, 6)])
def test_tally_decide_kernel(cuda, S, n, q, V):
    g = torch.Generator(device=cuda).manual_seed(S + V)
    votes = torch.randint(-1, V, (S, n), generator=g, device=cuda,
                          dtype=torch.int32)
    for a, b in zip(kernel.tally_decide(votes, V, q),
                    ref.tally_decide(votes, V, q)):
        assert torch.equal(a, b)


# Beyond the old 8-value, 128-acceptor kernels: K past one pass of 8 values,
# n past masked_tally's staged chunk of 128 lanes (and past 256, the
# byte-wide orders of the stream kernel), trial counts that are no multiple
# of a block's 64 (or 32) trials, and ties, which a run of many values
# makes common.
ANY_KN_CASES = [(300, 11, 9), (300, 12, 12), (257, 11, 33), (500, 129, 2),
                (300, 130, 2), (200, 257, 3), (200, 300, 2), (100, 300, 9),
                (16383, 11, 2), (1000, 12, 17)]


@pytest.mark.parametrize("S,n,V", ANY_KN_CASES)
def test_tally_decide_kernel_any_k_and_n(cuda, S, n, V):
    r = np.random.default_rng(S + n + V)
    votes = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32),
                            device=cuda)
    for a, b in zip(kernel.tally_decide(votes, V, n // 3),
                    ref.tally_decide(votes, V, n // 3)):
        assert torch.equal(a, b)


def test_tally_decide_kernel_unaligned_rows(cuda):
    """Votes that do not start on 16 bytes."""
    r = np.random.default_rng(3)
    base = torch.as_tensor(r.integers(-1, 3, (1000 * 11 + 1,)).astype(
        np.int32), device=cuda)
    votes = base[1:].view(1000, 11)
    for a, b in zip(kernel.tally_decide(votes, 3, 5),
                    ref.tally_decide(votes, 3, 5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,n,V", ANY_KN_CASES)
def test_masked_tally_kernel_any_k_and_n(cuda, S, n, V):
    """Weights in quarters: every sum exact in f32, in any order."""
    r = np.random.default_rng(S * 3 + n + V)
    G = 40
    votes = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32),
                            device=cuda)
    w = torch.as_tensor((r.integers(0, 9, (G, n)) / 4.0).astype(np.float32),
                        device=cuda)
    t = torch.as_tensor((r.integers(1, 4 * n // V + 8, (G,)) / 4.0).astype(
        np.float32), device=cuda)
    assert torch.equal(kernel.masked_tally(votes, w, t, V),
                       ref.masked_tally(votes, w, t, V))


@pytest.mark.parametrize("G", [1, 4, 12, 70])
@pytest.mark.parametrize("S,n,V", [(257, 9, 2), (1100, 11, 3), (100, 6, 4),
                                   (8192, 12, 2)])
def test_masked_tally_kernel(cuda, S, n, V, G):
    r = np.random.default_rng(S * 7 + G)
    votes = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32),
                            device=cuda)
    w = torch.as_tensor(r.integers(0, 4, (G, n)).astype(np.float32),
                        device=cuda)
    t = torch.as_tensor(r.integers(1, n + 2, (G,)).astype(np.float32),
                        device=cuda)
    assert torch.equal(kernel.masked_tally(votes, w, t, V),
                       ref.masked_tally(votes, w, t, V))


@pytest.mark.parametrize("case", MASKED_CASES,
                         ids=[c[0].replace(" ", "_") for c in MASKED_CASES])
def test_masked_tally_kernel_edges(cuda, case):
    """Unit and weighted rows, t <= 0 (lowest unvoted values), negative
    weights, K > n, n each side of a mask word, the device-memory tier and
    G past the old 65535 x 32 cap: equal to the plain version."""
    votes, w, t, K = masked_inputs(case, cuda)
    assert torch.equal(kernel.masked_tally(votes, w, t, K),
                       ref.masked_tally(votes, w, t, K))


@pytest.mark.parametrize("n,G,tier", [(12, 39, "one chunk"),
                                      (4, 65535 * 32 + 1, "chunks"),
                                      (4000, 300, "device memory")])
def test_masked_tally_kernel_plan_tiers(cuda, n, G, tier):
    """The shapes of MASKED_CASES reach the plan's tiers: all rows staged
    once, rows in chunks, and the block's working set in device memory."""
    rc, smem, _, region, _ = kernel.LIB.plan(
        "masked_tally", "qt_masked_plan", cuda, (n, G, 2))
    assert (region > 0) == (tier == "device memory")
    assert (smem > 0) == (tier != "device memory")
    assert (rc >= G) == (tier == "one chunk")


def test_masked_tally_kernel_unaligned_rows(cuda):
    """Votes and weights that do not start on 16 bytes."""
    r = np.random.default_rng(4)
    vb = torch.as_tensor(r.integers(-1, 3, (700 * 12 + 1,)).astype(np.int32),
                         device=cuda)
    wb = torch.as_tensor((r.integers(0, 9, (30 * 12 + 1,)) / 4.0).astype(
        np.float32), device=cuda)
    votes, w = vb[1:].view(700, 12), wb[1:].view(30, 12)
    t = torch.as_tensor((r.integers(-4, 20, (30,)) / 4.0).astype(np.float32),
                        device=cuda)
    assert torch.equal(kernel.masked_tally(votes, w, t, 3),
                       ref.masked_tally(votes, w, t, 3))


# (S, n, M, G, K, k_sat, stream_test_inputs options): the mixed n=12 shape,
# then the edges of the kernel's design -- more rows than a warp's 32, K = 8,
# n past the register-resident orders (16, 32) up to 128, more systems than
# a block's 16, quarter weights, k_sat below n, +inf lanes, padding rows.
STREAM_CASES = [
    (300, 11, 2, 3, 2, (4, 5, 6), {}),
    (1025, 9, 1, 6, 3, (9, 9, 9), {}),
    (513, 7, 3, 1, 2, (2, 3, 2), {}),
    (700, 11, 4, 2, 2, (11, 1, 7), {}),
    (8192, 12, 13, 12, 2, (12, 4, 8), {}),
    (1000, 12, 5, 39, 2, (12, 12, 12), dict(pad=True)),
    (600, 9, 3, 4, 8, (9, 9, 9), {}),
    (500, 17, 3, 5, 3, (17, 9, 12), {}),
    (400, 33, 2, 4, 2, (33, 20, 25), {}),
    (300, 128, 2, 3, 2, (128, 64, 100), {}),
    (200, 128, 1, 2, 8, (128, 128, 128), {}),
    (2000, 11, 300, 3, 2, (11, 6, 8), dict(pad=True)),
    (1500, 12, 13, 12, 2, (12, 12, 12), dict(quarters=True, pad=True)),
    (1025, 12, 4, 6, 2, (5, 3, 4), {}),
    (1000, 12, 4, 5, 2, (12, 12, 12), dict(inf=True, pad=True)),
    # any K and any n: more than 8 values, orders wider than a byte (n >
    # 256), and more quorum rows than a block's shared memory held at n =
    # 128, K = 8 (about 2360); from n = 257 on, and for the last two, the
    # tile and the lists are staged in device memory.
    (300, 11, 3, 4, 9, (11, 9, 10), {}),
    (300, 12, 2, 5, 12, (12, 12, 12), dict(pad=True)),
    (200, 11, 2, 3, 33, (11, 11, 11), {}),
    (300, 129, 2, 4, 2, (129, 70, 100), {}),
    (300, 130, 3, 3, 2, (130, 130, 130), dict(quarters=True)),
    (200, 257, 2, 3, 2, (257, 200, 257), {}),
    (150, 300, 2, 3, 3, (300, 300, 300), dict(pad=True)),
    (96, 128, 1, 900, 8, (128, 128, 128), {}),
    (40, 600, 1, 2, 70, (600, 300, 600), {}),
]


def _stream_case_id(i, case):
    S, n, M, G, K, _, opts = case
    return "-".join([str(S), str(n), str(M), str(G), str(K), f"k_sat{i}",
                     *sorted(opts)])


def assert_stream_equal(got, want):
    h_k, s_k = got
    h_r, s_r = want
    assert torch.equal(h_k, h_r)
    for f in ("n_fast", "n_recovery", "n_undecided", "max_ms"):
        assert torch.equal(s_k[f], s_r[f]), f
    torch.testing.assert_close(s_k["sum_ms"], s_r["sum_ms"], rtol=1e-5,
                               atol=0.0)


@pytest.mark.parametrize("S,n,M,G,K,k_sat,opts", STREAM_CASES,
                         ids=[_stream_case_id(i, c)
                              for i, c in enumerate(STREAM_CASES)])
def test_stream_kernel(cuda, S, n, M, G, K, k_sat, opts):
    args = stream_test_inputs(S * 13 + M, S, n, M, G, K, cuda, **opts)
    kw = dict(n_values=K, k_sat=k_sat, precision=0.01, bins=BINS,
              undecided_ms=5e8)
    assert_stream_equal(kernel.stream_tally_decide_hist(*args, **kw),
                        ref.stream_tally_decide_hist(*args, **kw))


def test_stream_kernel_all_invalid_block(cuda):
    args = stream_test_inputs(3, 128, 5, 1, 2, 2, cuda)
    args[-1] = torch.zeros(128, dtype=torch.bool, device=cuda)
    h, s = kernel.stream_tally_decide_hist(
        *args, n_values=2, k_sat=(3, 3, 3), precision=0.01, bins=BINS,
        undecided_ms=5e8)
    assert int(h.sum()) == 0 and int(s["n_fast"].sum()) == 0
    assert bool(torch.isneginf(s["max_ms"]).all())


@pytest.mark.parametrize("S,n,M,G,K", [(8192, 12, 13, 12, 2),
                                       (2000, 11, 300, 3, 2),
                                       (300, 128, 2, 3, 8)])
def test_stream_kernel_repeats_bit_for_bit(cuda, S, n, M, G, K):
    """Two calls on the same inputs give the same bits, sum_ms included:
    the per-block partials are reduced in block order."""
    args = stream_test_inputs(S + n, S, n, M, G, K, cuda, quarters=True)
    kw = dict(n_values=K, k_sat=(n, n, n), precision=0.01, bins=BINS,
              undecided_ms=5e8)
    h_a, s_a = kernel.stream_tally_decide_hist(*args, **kw)
    h_b, s_b = kernel.stream_tally_decide_hist(*args, **kw)
    assert torch.equal(h_a, h_b)
    for f in s_a:
        assert torch.equal(s_a[f].view(torch.int32),
                           s_b[f].view(torch.int32)), f


def test_stream_kernel_one_launch_per_call(cuda):
    args = stream_test_inputs(5, 8192, 12, 13, 12, 2, cuda)
    kw = dict(n_values=2, k_sat=(12, 4, 8), precision=0.01, bins=BINS,
              undecided_ms=5e8)
    kernel.stream_tally_decide_hist(*args, **kw)
    ops.reset_launches()
    ops.stream_tally_decide_hist(*args, **kw)
    assert ops.LAUNCHES == {"tally_votes": 0, "tally_decide": 0,
                            "masked_tally": 0, "stream_tally_decide_hist": 1,
                            "race_card_hist": 0, "masked_sat": 0,
                            "sorted_prefix": 0, "col_sketch": 0}


def test_ops_launch_on_cuda_and_count(cuda):
    ops.reset_launches()
    votes = torch.zeros((64, 5), dtype=torch.int32, device=cuda)
    ops.tally_decide(votes, 2, 3)
    ops.masked_tally(votes, torch.ones((2, 5), device=cuda),
                     torch.ones(2, device=cuda), 2)
    ops.quorum_reached(votes, 2, 3)
    assert ops.LAUNCHES == {"tally_votes": 1, "tally_decide": 1,
                            "masked_tally": 1, "stream_tally_decide_hist": 0,
                            "race_card_hist": 0, "masked_sat": 0,
                            "sorted_prefix": 0, "col_sketch": 0}


@pytest.mark.parametrize("S,n,M,G,K,tier", [
    (300, 12, 2, 5, 2, "resident"), (200, 128, 1, 2, 8, "lists"),
    (200, 300, 3, 3, 9, "staged"), (64, 12, 2, 3, 120, "staged")])
def test_stream_kernel_plan_tiers(cuda, S, n, M, G, K, tier):
    """Each tier of the launch plan, reached by a shape that needs it: the
    live rows resident in shared memory; lists of live rows in shared
    memory, the rows read from device memory; the tile and the lists
    staged in device memory, where they exceed a block's shared memory
    (orders two bytes a lane at n = 300, in registers at n = 12)."""
    args = stream_test_inputs(S + n + K, S, n, M, G, K, cuda, pad=True)
    kw = dict(n_values=K, k_sat=(n, n // 2 + 1, n), precision=0.01,
              bins=BINS, undecided_ms=5e8)
    plan = kernel.LIB.plan("stream_tally_decide_hist", "qt_stream_plan",
                           args[0].device, (n, K, M, G, G, G))
    res, big = plan[4], plan[5]
    assert {"resident": (1, False), "lists": (0, False),
            "staged": (0, True)}[tier] == (res, big > 0)
    assert_stream_equal(kernel.stream_tally_decide_hist(*args, **kw),
                        ref.stream_tally_decide_hist(*args, **kw))


def test_stream_kernel_refuses_what_the_reference_refuses(cuda):
    args = stream_test_inputs(4, 64, 5, 2, 3, 2, cuda)
    kw = dict(n_values=2, precision=0.01, bins=BINS, undecided_ms=5e8)
    for ks in ((6, 6, 6), (0, 0, 0)):
        with pytest.raises(ValueError, match="k_sat"):
            kernel.stream_tally_decide_hist(*args, k_sat=ks, **kw)


def assert_race_card_equal(got, want):
    """Integers and maxima equal, sums within 1e-5 relative of each cell."""
    for name, a, b in zip(("FH", "Fsum", "Fmax", "cnt", "RH", "Rsum",
                           "Rmax"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in ("Fsum", "Rsum"):
            assert bool(((a - b).abs() <= 1e-5 * b.abs()).all()), name
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("case", RACE_CARD_CASES,
                         ids=[c[0] for c in RACE_CARD_CASES])
def test_race_card_kernel(cuda, case):
    """The kernel against its plain version, and the same bits over two
    calls: the sums reduce per-block partials in a fixed order."""
    args, kw = race_card_inputs(case, cuda)
    got = kernel.race_card_hist(*args, **kw)
    assert_race_card_equal(got, ref.race_card_hist(*args, **kw))
    assert int(got[3].sum()) == case[-1]
    again = kernel.race_card_hist(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case,tier", [(RACE_CARD_CASES[0], "shared"),
                                       (RACE_CARD_CASES[4], "shared"),
                                       (RACE_CARD_CASES[5], "device"),
                                       (RACE_CARD_CASES[6], "device")],
                         ids=["sweep", "n=33", "K=9 n=130", "n=300"])
def test_race_card_kernel_plan_tiers(cuda, case, tier):
    """Each tier of the plan, reached by a shape that needs it: a block's
    tile, prefixes and cells in its shared memory (the sweep, rows ranked
    in registers; n = 33, ranked a lane a thread), or in a region of device
    memory where they do not fit there."""
    args, kw = race_card_inputs(case, cuda)
    plan = kernel.LIB.plan("race_card_hist", "qt_card_plan", cuda,
                           (args[0].shape[1], args[4].shape[0])
                           + tuple(kw["k_sat"]))
    assert (plan[5] > 0) == (tier == "device")
    assert (plan[3] > 0) == (tier == "shared")


def test_race_card_kernel_refuses_what_the_reference_refuses(cuda):
    args, kw = race_card_inputs(RACE_CARD_CASES[3], cuda)
    for ks in ((13, 7, 8), (0, 7, 8), (9, 7, 13)):
        with pytest.raises(ValueError, match="k_sat"):
            kernel.race_card_hist(*args, **dict(kw, k_sat=ks))
        with pytest.raises(ValueError, match="k_sat"):
            ref.race_card_hist(*args, **dict(kw, k_sat=ks))


def test_race_card_kernel_refuses_pairs_out_of_range(cuda):
    """As the reference does; a tensor changed in place is checked again."""
    args, kw = race_card_inputs(RACE_CARD_CASES[3], cuda)
    pairs = args[4].clone()
    kernel.race_card_hist(*args[:4], pairs, **kw)
    k1, k_rec = kw["k_sat"][:2]
    for pair in ((0, 1), (1, 0), (k1 + 1, 1), (1, k_rec + 1)):
        pairs[-1] = torch.tensor(pair, dtype=torch.int32, device=cuda)
        for fn in (kernel.race_card_hist, ref.race_card_hist):
            with pytest.raises(ValueError, match="recovery pairs"):
                fn(*args[:4], pairs, **kw)


def test_card_race_chunk_is_one_launch(cuda):
    """A streamed cardinality race launches race_card_hist once a chunk
    and no other quorum kernel, and no sort or scatter_reduce_."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.frontier import cardinality_family
    from repro_torch.montecarlo import engine, rng
    table = engine.build_mask_table([m.masks() for m in
                                     cardinality_family(11)], device=cuda)
    run = lambda: streaming.race_stream(rng.root(3), table, [0.0, 0.2],
                                        n=11, k_proposers=2, trials=40000,
                                        chunk=16384)
    run()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    assert ops.LAUNCHES == {"tally_votes": 0, "tally_decide": 0,
                            "masked_tally": 0, "stream_tally_decide_hist": 0,
                            "race_card_hist": 3, "masked_sat": 0,
                            "sorted_prefix": 0, "col_sketch": 0}
    names = [e.key.lower() for e in prof.key_averages()]
    assert not [k for k in names if "sort" in k or "scatter" in k
                or "tally_decide" in k], names


# ---------------------------------------------------------------------------
# masked_sat
# ---------------------------------------------------------------------------

SAT_BIG = 1e9


@pytest.mark.parametrize("case", MASKED_SAT_CASES, ids=lambda c: c[0])
def test_masked_sat_kernel(cuda, case):
    """The kernel against the plain version on the card, bit for bit (one
    f32 add a position where the weights are not exact in f32), and the
    same bits over two calls."""
    a = masked_sat_inputs(case, cuda)
    got = kernel.masked_sat(*a, big=SAT_BIG)
    want = (sequential_sat(*a, SAT_BIG) if case[6] == "normal"
            else ref.masked_sat(*a, big=SAT_BIG))
    assert got.shape == want.shape and got.dtype == torch.float32
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert bad == 0, f"{case[0]}: {bad} entries differ"
    assert torch.equal(got.view(torch.int32),
                       kernel.masked_sat(*a, big=SAT_BIG).view(torch.int32))


@pytest.mark.parametrize("name,res,reg,groups", [
    ("mixed_n12", 1, 1, 1), ("planner 404", 1, 1, 2),
    ("n=40 L=30", 1, 0, 1), ("n=300 L=200", 1, 0, 1),
    ("rows in device memory", 0, 1, 1)])
def test_masked_sat_kernel_plan_tiers(cuda, name, res, reg, groups):
    """Each instance is reached by a shape that needs it: rows resident in
    shared memory or read from device memory, orders in registers or read
    where the sort left them, more systems than one block holds."""
    case = next(c for c in MASKED_SAT_CASES if c[0] == name)
    _, S, n, L, M, G, _, _ = case
    plan = kernel.LIB.plan("masked_sat", "qt_sat_plan", cuda, (n, L, M, G))
    assert (plan[3], plan[4]) == (res, reg)
    assert -(-M // plan[0]) >= groups


def test_masked_sat_one_launch_per_call_and_no_fill(cuda):
    a = masked_sat_inputs(MASKED_SAT_CASES[0], cuda)
    kernel.masked_sat(*a, big=SAT_BIG)
    torch.cuda.synchronize()
    ops.reset_launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.masked_sat(*a, big=SAT_BIG)
        torch.cuda.synchronize()
    assert ops.LAUNCHES == {k: 3 if k == "masked_sat" else 0
                            for k in ops.LAUNCHES}
    names = [e.key for e in prof.key_averages()]
    assert [k for k in names if "masked_sat_kernel" in k], names
    assert not [k for k in names if "memset" in k.lower()
                or "scan" in k.lower()], names


def test_masked_sat_wrapper_refuses(cuda):
    x, p, w, t = masked_sat_inputs(("r", 64, 5, 5, 2, 3, "integral", False),
                                   cuda)
    with pytest.raises(ValueError, match="int64"):
        kernel.masked_sat(x, p.int(), w, t, big=SAT_BIG)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.masked_sat(x, p, w.transpose(1, 2).contiguous().transpose(
            1, 2), t, big=SAT_BIG)
    with pytest.raises(ValueError, match="last axis"):
        kernel.masked_sat(x.T.contiguous().T, p.T.contiguous().T, w, t,
                          big=SAT_BIG)
    with pytest.raises(ValueError, match="lies on"):
        kernel.masked_sat(x, p, w.cpu(), t, big=SAT_BIG)


@pytest.mark.parametrize("per", [False, True], ids=["shared", "per_system"])
def test_masked_sat_takes_the_mixed_table_through_the_engine(cuda, per):
    """``engine._sat_time`` on the card is one launch and the plain
    version's bits, on the mixed n=12 table's three phases."""
    from repro_torch.montecarlo import engine
    from chip_smoke import mixed_members
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (13, 4096, 12) if per else (4096, 12)
    x = torch.rand(shape, generator=g, device=cuda) * 4
    x = torch.where(x > 3.6, torch.full_like(x, 1e9), x)
    xs, ps = torch.sort(x, dim=-1, stable=True)
    for ph in ("p1", "p2c", "p2f"):
        ops.reset_launches()
        got = engine._sat_time(xs, ps, table[ph + "_w"], table[ph + "_t"])
        assert ops.LAUNCHES["masked_sat"] == 1
        want = ref.masked_sat(xs, ps, table[ph + "_w"], table[ph + "_t"],
                              big=float(engine.BIG))
        assert torch.equal(got, want), ph


def test_masked_fast_path_stream_one_launch_a_chunk(cuda):
    """The masked fast path's stream on the mixed n=12 table launches
    sorted_prefix and masked_sat once a chunk each and nothing else, no
    sort, and equals the stream on the plain versions: counts, histogram
    and max_ms equal, means to 1e-5."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import mixed_members, plain_quorum_kernels
    from repro_torch.montecarlo import engine, rng
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device=cuda)
    run = lambda: streaming.fast_path_stream(
        rng.root(9), table, n=12, trials=300_000, chunk=65_536, shard=False)
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    assert ops.LAUNCHES == {k: 5 if k in ("masked_sat", "sorted_prefix")
                            else 0 for k in ops.LAUNCHES}
    names = [e.key.lower() for e in prof.key_averages()]
    assert [k for k in names if "sorted_prefix_kernel" in k], names
    assert not [k for k in names if "sort" in k
                and "sorted_prefix_kernel" not in k], names
    with plain_quorum_kernels():
        want = run()
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.allclose(got.mean_ms, want.mean_ms, rtol=1e-5, atol=0.0)


def _card_cols_stream(cuda, path):
    """The card ``path`` stream on the cardinality n = 11 table: its
    launches, the profiler's kernel names, and the summaries with the
    kernels and with the plain versions."""
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import plain_quorum_kernels
    from repro_torch.frontier import cardinality_family
    from repro_torch.montecarlo import engine, rng
    table = engine.build_mask_table([m.masks() for m in
                                     cardinality_family(11)], device=cuda)
    entry = (streaming.fast_path_stream if path == "fast"
             else streaming.classic_path_stream)
    run = lambda: entry(rng.root(6), table, n=11, trials=300_000,
                        chunk=65_536, shard=False)
    run()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    names = [e.key.lower() for e in prof.key_averages()]
    with plain_quorum_kernels():
        want = run()
    return launches, names, got, want


def test_card_fast_path_stream_sorts_through_sorted_prefix(cuda):
    """The card fast path's stream on the cardinality n = 11 table
    launches sorted_prefix and col_sketch once a chunk, no other quorum
    kernel, no sort and no scatter, and equals the stream on the plain
    versions (torch.sort, the scatter-add sketch): integers and max_ms
    equal, means to 1e-5."""
    launches, names, got, want = _card_cols_stream(cuda, "fast")
    assert launches == {k: 5 if k in ("sorted_prefix", "col_sketch") else 0
                        for k in launches}
    assert [k for k in names if "sorted_prefix_kernel" in k], names
    assert [k for k in names if "col_sketch_kernel" in k], names
    assert not [k for k in names if "sort" in k
                and "sorted_prefix_kernel" not in k], names
    assert not [k for k in names if "scatter" in k], names
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.allclose(got.mean_ms, want.mean_ms, rtol=1e-5, atol=0.0)


def test_card_classic_path_stream_sketches_through_col_sketch(cuda):
    """The card classic path's stream (columns d0 + prefix) launches
    sorted_prefix and col_sketch once a chunk and no scatter, and equals
    the stream on the plain versions: integers and max_ms equal, means to
    1e-5."""
    launches, names, got, want = _card_cols_stream(cuda, "classic")
    assert launches == {k: 5 if k in ("sorted_prefix", "col_sketch") else 0
                        for k in launches}
    assert [k for k in names if "col_sketch_kernel" in k], names
    assert not [k for k in names if "scatter" in k], names
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not bool(got.n_fast.any()) and bool(got.n_recovery.all())
    assert torch.allclose(got.mean_ms, want.mean_ms, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("case", COL_SKETCH_CASES, ids=lambda c: c[0])
def test_col_sketch_kernel_equals_plain_version(cuda, case):
    """The column sketch at the fast path's 2,097,152 x 11 and 65,536 x 11
    columns, a ragged chunk, the classic path's, Kc = 1..32 and each tier
    of the launch plan: histograms, undecided and valid counts and maxima
    equal to the plain version's; sums the same bits on two calls and
    within 1e-6 relative; one launch a call."""
    (cols, valid), kw = col_sketch_inputs(case, cuda)
    Kc = cols.shape[1]
    cg, _, _, P, _, _, glob = kernel.LIB.plan(
        "col_sketch", "qt_col_plan", cuda, (Kc, kw["bins"]))
    tier = {"groups": -(-Kc // cg) > 1,
            "one column": cg == 1 and (kw["bins"] + 1) * 4 > 64 * 1024
            and not glob,
            "device memory": bool(glob), "unstaged": P == 0}
    if case[0] in tier:
        assert tier[case[0]], (case[0], (cg, P, glob))
    ops.reset_launches()
    got = ops.col_sketch(cols, valid, **kw)
    assert ops.LAUNCHES["col_sketch"] == 1
    again = kernel.col_sketch(cols, valid, **kw)
    LH, s, m, nv = ref.col_sketch(cols, valid, **kw)
    assert torch.equal(got[0], LH)
    assert torch.equal(got[2], m)
    assert int(got[3]) == int(nv) == case[3]
    assert torch.equal(got[1].view(torch.int32), again[1].view(torch.int32))
    assert bool(((got[1] - s).abs() <= 1e-6 * s.abs()).all()), (got[1], s)


def test_col_sketch_wrapper_refuses(cuda):
    x = torch.zeros((64, 11), device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    kw = dict(precision=0.01, bins=BINS, undecided_ms=5e8)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.col_sketch(torch.zeros((11, 64), device=cuda).T, valid, **kw)
    with pytest.raises(ValueError, match="dtype"):
        kernel.col_sketch(x.double(), valid, **kw)
    with pytest.raises(ValueError, match="shape"):
        kernel.col_sketch(x, valid[:63], **kw)
    with pytest.raises(ValueError, match="Kc"):
        kernel.col_sketch(torch.zeros((4, 0), device=cuda),
                          valid[:4], **kw)


@pytest.mark.parametrize("S,n,V", [(64, 5, 9), (64, 129, 2)])
def test_wrappers_take_what_the_reference_takes(cuda, S, n, V):
    """K = 9 values and n = 129 acceptors, which the kernels refused before
    they took any K and n, agree with the plain versions."""
    votes = torch.as_tensor(np.random.default_rng(S + n).integers(
        -1, V, (S, n)).astype(np.int32), device=cuda)
    for a, b in zip(kernel.tally_decide(votes, V, 3),
                    ref.tally_decide(votes, V, 3)):
        assert torch.equal(a, b)
    w, t = torch.ones((2, n), device=cuda), torch.tensor([3.0, 9.0],
                                                         device=cuda)
    assert torch.equal(kernel.masked_tally(votes, w, t, V),
                       ref.masked_tally(votes, w, t, V))


def test_wrappers_raise_on_bad_input(cuda):
    votes = torch.zeros((8, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        kernel.tally_decide(votes.long(), 2, 3)
    with pytest.raises(ValueError, match="1 <= K"):
        kernel.tally_decide(votes, 0, 3)
    with pytest.raises(ValueError, match="1 <= K"):
        kernel.tally_votes(votes, 0)
    with pytest.raises(ValueError, match="dtype"):
        kernel.tally_votes(votes.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.masked_tally(torch.zeros((5, 8), dtype=torch.int32,
                                        device=cuda).T, torch.ones(
            (1, 5), device=cuda), torch.ones(1, device=cuda), 2)


@pytest.mark.parametrize("S,n,V", [(100, 11, 2), (1024, 11, 3),
                                   (3000, 7, 2), (5000, 32, 5),
                                   (16384, 11, 2), (700, 200, 12),
                                   (1000, 5, 17)])
def test_tally_votes_kernel(cuda, S, n, V):
    r = np.random.default_rng(S + n)
    votes = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32),
                            device=cuda)
    assert torch.equal(kernel.tally_votes(votes, V),
                       ref.tally_votes(votes, V))
    q = n // 2 + 1
    assert torch.equal(ops.quorum_reached(votes, V, q),
                       ref.quorum_reached(votes, V, q))


@pytest.mark.parametrize("S,n,V", TALLY_VOTES_CASES)
def test_tally_votes_kernel_each_k(cuda, S, n, V):
    """Every K-specialised instance (K <= 8) and the passes past it."""
    r = np.random.default_rng(S * 3 + n + V)
    votes = torch.as_tensor(r.integers(-1, V, (S, n)).astype(np.int32),
                            device=cuda)
    assert torch.equal(kernel.tally_votes(votes, V),
                       ref.tally_votes(votes, V))


# ---------------------------------------------------------------------------
# SSD scan: the kernel against the plain chunked version and the recurrence,
# with TF32 off so the plain version's products are f32.  Tolerances are the
# JAX kernel tests': 1e-3 in f32 (summation order), 3e-2 with bf16 xw (the
# output is rounded to bf16).
# ---------------------------------------------------------------------------

SSD_CASES = [
    (2, 128, 4, 16, 32, 32, torch.float32, torch.float32),
    (1, 256, 8, 64, 128, 64, torch.float32, torch.float32),
    (2, 64, 24, 64, 128, 64, torch.float32, torch.float32),
    (1, 128, 4, 32, 64, 32, torch.bfloat16, torch.float32),
    (2, 13, 4, 16, 32, 13, torch.float32, torch.float32),
    (2, 13, 4, 16, 32, 13, torch.bfloat16, torch.bfloat16),
    (1, 200, 3, 128, 128, 100, torch.float32, torch.bfloat16),
    (2, 1024, 24, 64, 128, 256, torch.float32, torch.float32),
]


@pytest.fixture
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,x_dtype,bc_dtype", SSD_CASES)
def test_ssd_kernel(cuda, no_tf32, B, S, nh, hd, ds, chunk, x_dtype,
                    bc_dtype):
    xw, da, Bm, Cm, s0 = ssd_test_inputs(S + nh, B, S, nh, hd, ds,
                                         x_dtype, bc_dtype, cuda)
    y, f = ssd_kernel.ssd(xw, da, Bm, Cm, chunk, s0)
    torch.cuda.synchronize()
    assert y.dtype == x_dtype and f.dtype == torch.float32
    tol = 1e-3 if x_dtype == torch.float32 else 3e-2
    y_c, f_c = ssd_chunked(xw, da, Bm, Cm, chunk, s0)
    y_r, f_r = ssd_ref.ssd(xw.float(), da, Bm, Cm, s0)
    for yy, ff in ((y_c, f_c), (y_r, f_r)):
        assert (y.float() - yy.float()).abs().max() < tol
        assert (f - ff).abs().max() < tol


def test_ssd_kernel_strided_b_c_and_zero_init(cuda, no_tf32):
    xw, da, Bm, Cm, _ = ssd_test_inputs(3, 2, 128, 4, 16, 32,
                                        torch.bfloat16, torch.bfloat16, cuda)
    u = torch.cat([xw.reshape(2, 128, 64), Bm, Cm], dim=-1)
    y1, f1 = ssd_kernel.ssd(xw, da, u[..., 64:96], u[..., 96:], 64)
    y2, f2 = ssd_kernel.ssd(xw, da, Bm.contiguous(), Cm.contiguous(), 64,
                            torch.zeros(2, 4, 16, 32, device=cuda))
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


# The tensor-core instance (bf16 xw, B and C): (B, S, nh, hd, ds, chunk,
# B and C strided, nonzero initial state).  Both serving shapes, a single
# ragged 13-token chunk, chunks of 64 and 256, chunk 100 (ragged 64-row
# tiles), hd = ds = 128, and hd 20 / ds 12 (rows not 16-byte aligned: the
# element-by-element copies).
SSD_TC_CASES = [
    (4, 1024, 80, 64, 64, 256, True, True),
    (4, 1024, 24, 64, 128, 256, True, True),
    (2, 13, 4, 16, 32, 13, False, True),
    (2, 13, 4, 16, 32, 13, True, False),
    (2, 256, 4, 32, 64, 64, True, True),
    (1, 512, 3, 128, 128, 256, False, True),
    (2, 200, 3, 40, 24, 100, True, True),
    (1, 96, 2, 20, 12, 32, True, True),
]


def ssd_close(got, want, tol, rel: bool) -> bool:
    """|got - want| <= tol * max(|want|, min(1, max|want|)) entrywise
    (``rel``), else <= tol * min(1, max|want|)."""
    g, w = got.float(), want.float()
    scale = min(1.0, float(w.abs().max()))
    bound = tol * (torch.clamp(w.abs(), min=scale) if rel else scale)
    return bool(((g - w).abs() <= bound).all())


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,strided,init", SSD_TC_CASES)
def test_ssd_tensor_core_kernel(cuda, no_tf32, B, S, nh, hd, ds, chunk,
                                strided, init):
    bf = torch.bfloat16
    xw, da, Bm, Cm, s0 = ssd_test_inputs(S + ds, B, S, nh, hd, ds, bf, bf,
                                         cuda)
    if strided:              # column slices of one tensor, as the model's
        u = torch.cat([xw.reshape(B, S, nh * hd), Bm, Cm], dim=-1)
        Bm, Cm = u[..., nh * hd:nh * hd + ds], u[..., nh * hd + ds:]
    s0 = s0 if init else None
    ssd_ops.reset_launches()
    y, f = ssd_kernel.ssd(xw, da, Bm, Cm, chunk, s0)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == {"ssd": 1, "ssd_tc": 1}
    assert y.dtype == bf and f.dtype == torch.float32
    for yp, fp in (ssd_chunked(xw, da, Bm, Cm, chunk, s0),
                   ssd_ref.ssd_decomposed(xw, da, Bm, Cm, chunk, s0,
                                          split=True)):
        assert ssd_close(y, yp, 3e-2, rel=True)
        assert ssd_close(f, fp, 1e-3, rel=False)


def test_ssd_ops_launch_on_cuda_and_count(cuda):
    xw, da, Bm, Cm, _ = ssd_test_inputs(4, 1, 96, 2, 16, 16, torch.float32,
                                        torch.float32, cuda)
    ssd_ops.reset_launches()
    ssd_ops.ssd(xw, da, Bm, Cm, chunk=256)          # one chunk of 96
    ssd_ops.ssd(xw, da, Bm, Cm, chunk=32)
    assert ssd_ops.LAUNCHES == {"ssd": 2, "ssd_tc": 0}
    ssd_ops.ssd(xw.bfloat16(), da, Bm.bfloat16(), Cm.bfloat16(), chunk=32)
    assert ssd_ops.LAUNCHES == {"ssd": 3, "ssd_tc": 1}
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_ops.ssd(xw, da, Bm, Cm, chunk=64)


def test_ssd_wrapper_raises_on_bad_input(cuda):
    xw, da, Bm, Cm, _ = ssd_test_inputs(5, 1, 64, 2, 16, 16, torch.float32,
                                        torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        ssd_kernel.ssd(xw, da.double(), Bm, Cm, 32)
    with pytest.raises(ValueError, match="dtype"):
        ssd_kernel.ssd(xw, da, Bm, Cm.bfloat16(), 32)
    with pytest.raises(ValueError, match="last axis"):
        ssd_kernel.ssd(xw, da, Bm.transpose(1, 2).contiguous()
                       .transpose(1, 2), Cm, 32)
    with pytest.raises(ValueError, match="dividing"):
        ssd_kernel.ssd(xw, da, Bm, Cm, 48)
    big = torch.zeros(1, 64, 1, 256, device=cuda)
    with pytest.raises(ValueError, match="hd <= 128"):
        ssd_kernel.ssd(big, da[..., :1], Bm, Cm, 32)


@pytest.mark.parametrize("prompt_len", [13, 45, 64])
def test_model_prefill_runs_the_kernel_at_any_prompt_length(
        cuda, no_tf32, monkeypatch, prompt_len):
    """A prompt longer than a chunk (32 here) and not a multiple of it is
    padded to whole chunks; on the card every layer launches the kernel and
    agrees with the CPU's plain path in f32 (same seed, same weights)."""
    monkeypatch.setattr(model_mod, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced_config(get_config("mamba2_130m"))
    toks = torch.as_tensor(np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (2, prompt_len)))
    got = {}
    for dev in (torch.device("cpu"), cuda):
        m = model_mod.DecoderLM(cfg, device=dev, seed=0)
        ssd_ops.reset_launches()
        with torch.no_grad():
            c, lg = m.prefill({"tokens": toks.to(dev)},
                              m.init_cache(2, prompt_len))
        torch.cuda.synchronize()
        assert ssd_ops.LAUNCHES["ssd"] == (cfg.n_layers if dev.type == "cuda"
                                           else 0)
        got[dev.type] = [lg.float().cpu()] + [
            sb["mamba_0"]["state"].cpu() for sb in c["layers"]]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert (a - b).abs().max() < 1e-3 * max(1.0, float(b.abs().max()))


# ---------------------------------------------------------------------------
# Flash attention and RMSNorm: the kernels against their plain versions.
# ---------------------------------------------------------------------------

# (B, H, KV, S, T, hd, causal, window, dtype): JAX's ATTN_CASES
# (tests/test_kernels.py), then ragged S and T, hd 80 (zamba2's) and 48,
# a window without causality, and the zamba2 serving shape.
FA_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, torch.float32),
    (1, 8, 8, 128, 128, 128, True, None, torch.float32),
    (1, 4, 1, 128, 128, 64, True, 64, torch.float32),
    (2, 2, 2, 64, 512, 32, True, None, torch.float32),
    (1, 4, 2, 256, 256, 64, False, None, torch.float32),
    (2, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
    (1, 2, 2, 128, 128, 256, True, 32, torch.bfloat16),
    (2, 4, 4, 100, 100, 80, True, None, torch.float32),
    (1, 4, 2, 37, 200, 48, True, 50, torch.bfloat16),
    (1, 2, 1, 130, 130, 80, False, 17, torch.float32),
    (4, 32, 32, 1024, 1024, 80, True, None, torch.bfloat16),
    # the tensor-core instance: hd 32, 64, 80, 128, 256; GQA; a window;
    # non-causal; ragged S and T; hd 20 (rows not 16-byte aligned)
    (2, 4, 4, 128, 128, 32, True, None, torch.bfloat16),
    (1, 8, 2, 256, 256, 64, True, None, torch.bfloat16),
    (2, 4, 1, 192, 192, 80, True, 50, torch.bfloat16),
    (1, 4, 4, 200, 200, 128, False, None, torch.bfloat16),
    (1, 2, 2, 100, 130, 256, True, None, torch.bfloat16),
    (1, 4, 2, 45, 1000, 80, True, None, torch.bfloat16),
    (1, 2, 1, 130, 130, 80, False, 17, torch.bfloat16),
    (1, 2, 2, 33, 77, 20, True, None, torch.bfloat16),
]


def fa_inputs(seed, B, H, KV, S, T, hd, dtype, dev):
    r = np.random.default_rng(seed)
    t = lambda shape: torch.as_tensor(r.standard_normal(shape).astype(
        np.float32)).to(dev).to(dtype)
    return t((B, H, S, hd)), t((B, KV, T, hd)), t((B, KV, T, hd))


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window,dtype", FA_CASES)
def test_flash_attention_kernel(cuda, no_tf32, B, H, KV, S, T, hd, causal,
                                window, dtype):
    q, k, v = fa_inputs(S + hd, B, H, KV, S, T, hd, dtype, cuda)
    fa_ops.reset_launches()
    o = fa_kernel.attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    tc = dtype == torch.bfloat16
    assert fa_ops.LAUNCHES == {"flash_attention": 1,
                               "flash_attention_tc": int(tc)}
    assert o.dtype == dtype and o.shape == q.shape
    want = [fa_ref.attention(q.float(), k.float(), v.float(), causal,
                             window)]
    if tc:
        want.append(fa_ref.attention_tc(q, k, v, causal, window))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for w in want:
        assert (o.float() - w.float()).abs().max() < tol * max(
            1.0, float(w.abs().max()))


def test_flash_attention_reads_the_model_layout(cuda):
    """(B,S,H,hd) tensors viewed as (B,H,S,hd): the kernel reads them
    through their strides and writes its output in the same layout."""
    q, k, v = fa_inputs(1, 2, 4, 2, 96, 96, 80, torch.bfloat16, cuda)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    o = fa_kernel.attention(qs.transpose(1, 2), ks.transpose(1, 2),
                            vs.transpose(1, 2), True, None)
    assert o.transpose(1, 2).is_contiguous()
    assert torch.equal(o, fa_kernel.attention(q, k, v, True, None))


def test_flash_attention_unaligned_rows(cuda):
    """Rows that do not start on 16 bytes (an odd row stride) take the
    element-by-element copies and give the same result as aligned rows."""
    q, k, v = fa_inputs(4, 1, 4, 2, 96, 96, 64, torch.bfloat16, cuda)
    odd = [torch.zeros(x.shape[:-1] + (65,), dtype=x.dtype, device=cuda)
           for x in (q, k, v)]
    for o_, x in zip(odd, (q, k, v)):
        o_[..., 1:] = x
    got = fa_kernel.attention(*(o_[..., 1:] for o_ in odd), True, None)
    assert torch.equal(got, fa_kernel.attention(q, k, v, True, None))


def test_flash_ops_launch_on_cuda_and_count(cuda):
    q, k, v = fa_inputs(2, 1, 2, 1, 64, 64, 32, torch.float32, cuda)
    fa_ops.reset_launches()
    fa_ops.attention(q, k, v)
    fa_ops.attention(q, k, v, causal=False, window=8)
    assert fa_ops.LAUNCHES == {"flash_attention": 2, "flash_attention_tc": 0}
    fa_ops.attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert fa_ops.LAUNCHES == {"flash_attention": 3, "flash_attention_tc": 1}


def test_flash_wrapper_raises_on_bad_input(cuda):
    q, k, v = fa_inputs(3, 1, 4, 2, 64, 64, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        fa_kernel.attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="multiple of KV"):
        fa_kernel.attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="S <= T"):
        fa_kernel.attention(q, k[:, :, :32], v[:, :, :32])
    with pytest.raises(ValueError, match="last axis"):
        fa_kernel.attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    with pytest.raises(ValueError, match="hd <= 256"):
        big = torch.zeros(1, 1, 8, 264, device=cuda)
        fa_kernel.attention(big, big, big)


RN_CASES = [((4, 64, 256), torch.float32), ((2, 100, 384), torch.bfloat16),
            ((8, 300), torch.float32), ((1, 7, 130), torch.bfloat16),
            ((4096, 2560), torch.bfloat16), ((4096, 5120), torch.bfloat16),
            ((3, 5, 2560), torch.float32),
            # each instance's edges: a block a row (few rows), groups of
            # rows (many), rows longer than a block holds in registers (two
            # passes), unaligned rows (one value a slot)
            ((129, 2560), torch.bfloat16), ((300, 5120), torch.float32),
            ((200, 1100), torch.bfloat16), ((3, 70000), torch.bfloat16),
            ((300, 40000), torch.float32), ((3, 9001), torch.float32),
            ((500, 1030), torch.bfloat16)]


def rn_inputs(seed, shape, dtype, dev):
    r = np.random.default_rng(seed)
    x = torch.as_tensor(r.standard_normal(shape).astype(np.float32))
    s = torch.as_tensor(r.standard_normal(shape[-1]).astype(np.float32))
    return x.to(dev).to(dtype), s.to(dev)


@pytest.mark.parametrize("shape,dtype", RN_CASES)
def test_rmsnorm_kernel(cuda, shape, dtype):
    x, s = rn_inputs(shape[-1], shape, dtype, cuda)
    y = rn_kernel.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    want = rn_ref.rmsnorm(x, s).float()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    assert (y.float() - want).abs().max() < tol * max(
        1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2560, 5120])
@pytest.mark.parametrize("R", [1, 2, 4, 5])
def test_rmsnorm_kernel_decode_rows(cuda, R, d, dtype):
    """Decode's few rows, strided as decode hands them (the last position of
    each of R sequences of 3), against the plain version; and the same
    bits as the rows made contiguous."""
    x, s = rn_inputs(R * d, (R, 3, d), dtype, cuda)
    rows = x[:, -1]
    y = rn_kernel.rmsnorm(rows, s)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == (R, d) and y.is_contiguous()
    want = rn_ref.rmsnorm(rows, s).float()
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    assert (y.float() - want).abs().max() < tol * max(
        1.0, float(want.abs().max()))
    assert torch.equal(y, rn_kernel.rmsnorm(rows.contiguous(), s))


def test_rmsnorm_kernel_strided_rows(cuda):
    """The last position of each sequence: rows with a stride of S*D."""
    x, s = rn_inputs(7, (4, 9, 2560), torch.bfloat16, cuda)
    y = rn_kernel.rmsnorm(x[:, -1:], s)
    assert y.is_contiguous()
    assert torch.equal(y, rn_kernel.rmsnorm(x[:, -1:].contiguous(), s))


def test_rmsnorm_ops_launch_on_cuda_and_count(cuda):
    x, s = rn_inputs(8, (4, 64), torch.float32, cuda)
    rn_ops.reset_launches()
    rn_ops.rmsnorm(x, s)
    rn_ops.rmsnorm(x.bfloat16(), s)
    assert rn_ops.LAUNCHES == {"rmsnorm": 2}


def test_rmsnorm_wrapper_raises_on_bad_input(cuda):
    x, s = rn_inputs(9, (4, 64), torch.float32, cuda)
    with pytest.raises(ValueError, match="dtype"):
        rn_kernel.rmsnorm(x.double(), s)
    with pytest.raises(ValueError, match="scale"):
        rn_kernel.rmsnorm(x, s.bfloat16())
    with pytest.raises(ValueError, match="scale"):
        rn_kernel.rmsnorm(x, s[:32])
    with pytest.raises(ValueError, match="last axis"):
        rn_kernel.rmsnorm(x.T.contiguous().T, s)


@pytest.mark.parametrize("prompt_len", [45, 64])
def test_zamba2_prefill_runs_the_three_kernels(cuda, no_tf32, monkeypatch,
                                               prompt_len):
    """Reduced zamba2 on the card: every prefill launches the SSD kernel in
    each Mamba2 layer, flash attention at each of the shared block's places
    and RMSNorm at every norm; with f32 compute it agrees with the CPU's
    plain path (same seed, same weights) to 1e-3 of the largest value."""
    monkeypatch.setattr(model_mod, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced_config(get_config("zamba2_2_7b"))
    toks = torch.as_tensor(np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, (2, prompt_len)))
    n_attn = cfg.n_superblocks
    got = {}
    for dev in (torch.device("cpu"), cuda):
        m = model_mod.DecoderLM(cfg, device=dev, seed=0)
        for ops_ in (ssd_ops, fa_ops, rn_ops):
            ops_.reset_launches()
        with torch.no_grad():
            c, lg = m.prefill({"tokens": toks.to(dev)},
                              m.init_cache(2, prompt_len + 1))
        torch.cuda.synchronize()
        on = dev.type == "cuda"
        assert ssd_ops.LAUNCHES["ssd"] == cfg.n_layers * on
        assert fa_ops.LAUNCHES["flash_attention"] == n_attn * on
        assert rn_ops.LAUNCHES["rmsnorm"] == (
            2 * (cfg.n_layers + n_attn) + 1) * on
        got[dev.type] = [lg.float().cpu()] + [
            sb[key][name].float().cpu() for sb in c["layers"]
            for key, name in (("mamba_0", "state"), ("shared_attn_6", "k"),
                              ("shared_attn_6", "v"))]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert (a - b).abs().max() < 1e-3 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "musicgen_medium",
                                  "internvl2_26b"])
def test_moe_mla_and_stub_frontends_run_their_kernels(cuda, no_tf32,
                                                      monkeypatch, arch):
    """Reduced deepseek (MLA + MoE: no flash, MLA is plain products),
    musicgen (audio frames, decode through head.T) and internvl2 (patches
    then tokens) on the card: a prefill launches flash at each GQA block
    and RMSNorm at every norm, each of 3 decode steps RMSNorm at every
    norm; with f32 compute the logits agree with the CPU's plain path
    (same seed, same weights, the same tokens fed) to 1e-3 of the largest
    value."""
    from repro_torch.launch import serve
    monkeypatch.setattr(model_mod, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced_config(get_config(arch))
    batch = serve.prompt_batch(cfg, 2, 45, "cpu", seed=3)
    fed = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 3)))
    n_flash = 0 if cfg.mla is not None else cfg.n_layers
    per_pass = 2 * cfg.n_layers + 1
    got = {}
    for dev in (torch.device("cpu"), cuda):
        m = model_mod.DecoderLM(cfg, device=dev, seed=0)
        fa_ops.reset_launches()
        rn_ops.reset_launches()
        with torch.no_grad():
            c = m.init_cache(2, serve.prefill_len(batch) + 3)
            c, lg = m.prefill({k: v.to(dev) for k, v in batch.items()}, c)
            out = [lg]
            for i in range(3):
                lg, c = m.decode_step(c, fed[:, i:i + 1].to(dev))
                out.append(lg)
        torch.cuda.synchronize()
        on = dev.type == "cuda"
        assert fa_ops.LAUNCHES["flash_attention"] == n_flash * on
        assert rn_ops.LAUNCHES["rmsnorm"] == 4 * per_pass * on
        got[dev.type] = [x.float().cpu() for x in out]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert (a - b).abs().max() < 1e-3 * max(1.0, float(b.abs().max()))


def test_moe_combine_on_the_card_is_the_expert_order_index_add(cuda):
    """bf16 on the card: the MoE combine gives the bits of one index_add_
    an expert in ascending expert order, and the same bits twice."""
    from repro_torch.models import moe
    g = torch.Generator(device=cuda).manual_seed(5)
    T, E, k, D = 4096, 64, 6, 256
    gates = torch.softmax(torch.randn(T, E, generator=g, device=cuda), -1)
    topv, topi = moe.top_k(gates, k)
    sel = torch.zeros_like(gates).scatter(1, topi, topv / topv.sum(
        -1, keepdim=True))
    wv, idx = moe.top_k(sel.T, 480)
    valid = wv > 0
    yg = torch.randn(E, 480, D, generator=g, device=cuda).bfloat16() \
        * (wv * valid)[..., None].bfloat16()
    want = torch.zeros(T, D, dtype=torch.bfloat16, device=cuda)
    for e in range(E):
        want.index_add_(0, idx[e], yg[e])
    got = moe.combine(yg, idx, valid, T, k)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(moe.combine(yg, idx, valid, T, k).view(torch.int16),
                       got.view(torch.int16))


def test_bf16_prefill_runs_the_tensor_core_instances(cuda):
    """Served in bf16, every Mamba2 layer's SSD call and every flash call of
    a reduced zamba2 prefill is the tensor-core instance's."""
    cfg = reduced_config(get_config("zamba2_2_7b"))
    m = model_mod.DecoderLM(cfg, device=cuda, seed=0)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 70))).to(cuda)
    ssd_ops.reset_launches()
    fa_ops.reset_launches()
    with torch.no_grad():
        _, lg = m.prefill({"tokens": toks}, m.init_cache(2, 71))
    torch.cuda.synchronize()
    assert lg.dtype == torch.bfloat16 and bool(torch.isfinite(
        lg.float()).all())
    assert ssd_ops.LAUNCHES == {"ssd": cfg.n_layers, "ssd_tc": cfg.n_layers}
    assert fa_ops.LAUNCHES == {"flash_attention": cfg.n_superblocks,
                               "flash_attention_tc": cfg.n_superblocks}


def test_forward_under_autograd_raises_on_the_card(cuda):
    """The card's kernels have no backward: a forward pass that autograd
    would record raises instead of returning logits cut off from the
    weights; under no_grad the same call runs."""
    cfg = reduced_config(get_config("zamba2_2_7b"))
    m = model_mod.DecoderLM(cfg, device=cuda, seed=0)
    toks = torch.zeros((1, 16), dtype=torch.long, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        m({"tokens": toks})
    with torch.no_grad():
        assert m({"tokens": toks}).shape == (1, 16, cfg.vocab)


# ---------------------------------------------------------------------------
# Training on the card: the plain code under autograd, no kernel.
# ---------------------------------------------------------------------------

def _all_launches():
    return {k: v for c in (ops.LAUNCHES, ssd_ops.LAUNCHES, fa_ops.LAUNCHES,
                           rn_ops.LAUNCHES) for k, v in c.items() if v}


def _reset_all_launches():
    for m in (kernel, ssd_ops, fa_ops, rn_ops):
        m.reset_launches()


def test_full_width_mamba2_train_step_launches_no_kernel(cuda):
    """One AdamW step of full-width mamba2_130m (batch 2 x seq 512) on the
    card: a finite loss and norms, the parameters moved, and no kernel of
    the four libraries launched."""
    from repro_torch.training.data import DataConfig, SyntheticPipeline
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.trainer import Trainer, TrainerConfig
    cfg = get_config("mamba2_130m")
    m = model_mod.DecoderLM(cfg, device=cuda, seed=0, use_kernels=False)
    before = m.head.detach().clone()
    tr = Trainer(m, adamw(lr=1e-3), SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=512, global_batch=2)),
        TrainerConfig(ckpt_dir="unused", ckpt_every=0))
    tr.init()
    _reset_all_launches()
    out = tr.run(1)
    assert _all_launches() == {}
    assert all(np.isfinite(out[k]) for k in ("loss", "grad_norm",
                                              "update_norm"))
    assert 10.0 < out["loss"] < 12.5       # about ln(50280) at random init
    assert not torch.equal(m.head.detach(), before)


def test_use_kernels_model_raises_under_grad_and_plain_does_not(cuda):
    """DecoderLM(use_kernels=True) under grad raises refuse_grad's error
    at its first kernel; the same weights with use_kernels=False
    differentiate and launch nothing."""
    cfg = reduced_config(get_config("zamba2_2_7b"))
    toks = torch.zeros((2, 40), dtype=torch.long, device=cuda)
    batch = {"tokens": toks, "labels": toks}
    m = model_mod.DecoderLM(cfg, device=cuda, seed=0, use_kernels=True)
    with pytest.raises(RuntimeError, match="no backward"):
        m.loss(batch)
    m.use_kernels = False
    _reset_all_launches()
    loss = m.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    assert _all_launches() == {}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in m.parameters())


def test_restored_checkpoint_prefills_through_the_kernels(cuda, tmp_path):
    """Reduced zamba2 trained two steps on the card and checkpointed
    through the control plane; a fresh model with kernels restored from it
    prefills through SSD, flash and RMSNorm, with the trained model's
    logits bit for bit."""
    from repro_torch.cluster.coordinator import ControlPlane
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.training.data import DataConfig, SyntheticPipeline
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                              make_prefill)
    cfg = reduced_config(get_config("zamba2_2_7b"))
    plane = ControlPlane(QuorumSpec.paper_headline(11))
    pipe = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=2))

    def trainer(model):
        tr = Trainer(model, adamw(lr=1e-3), pipe,
                     TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=2),
                     plane=plane)
        tr.init()
        return tr

    trained = trainer(model_mod.DecoderLM(cfg, device=cuda, seed=0,
                                          use_kernels=False))
    trained.run(2)
    fresh = trainer(model_mod.DecoderLM(cfg, device=cuda, seed=1))
    assert fresh.try_restore() and fresh.step == 2
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 70))).to(cuda)
    trained.model.use_kernels = True
    _, want = make_prefill(trained.model)(trained.model.init_cache(2, 70),
                                          {"tokens": toks})
    for m in (ssd_ops, fa_ops, rn_ops):
        m.reset_launches()
    _, got = make_prefill(fresh.model)(fresh.model.init_cache(2, 70),
                                       {"tokens": toks})
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES["ssd"] == cfg.n_layers
    assert fa_ops.LAUNCHES["flash_attention"] == cfg.n_superblocks
    assert rn_ops.LAUNCHES["rmsnorm"] == 2 * (cfg.n_layers
                                              + cfg.n_superblocks) + 1
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The Experiment API on the card.
# ---------------------------------------------------------------------------

def _experiment(case, dev):
    """(Experiment, the one kernel its Monte-Carlo run launches, launches)
    at a small size: the quickstart's mixed batch and a cardinality batch,
    materialized and streamed, and both committed scenario configs."""
    import dataclasses
    import os
    from repro_torch.api import Experiment, Workload
    from repro_torch.api.__main__ import quickstart
    from repro_torch.core.quorum import QuorumSpec
    from chip_smoke import ROOT, SCENARIOS
    card = Experiment(systems=[QuorumSpec.paper_headline(11),
                               QuorumSpec.fast_paxos(11)],
                      workload=Workload.race(k=2, delta_ms=0.2),
                      samples=4000, device=dev)
    quick = quickstart(samples=4000, device=dev)
    if case == "quickstart":
        return quick, "masked_tally", 1
    if case == "cardinality":
        return card, "tally_decide", 1
    if case == "cardinality_stream":
        return (dataclasses.replace(card, trials=100_000, chunk=32_768),
                "race_card_hist", 4)
    if case == "quickstart_stream":
        return (dataclasses.replace(quick, trials=100_000, chunk=32_768),
                "stream_tally_decide_hist", 4)
    path = SCENARIOS[0 if case == "diurnal_wan" else 1]
    exp = Experiment.from_config(os.path.join(ROOT, path), device=dev)
    kern = "masked_tally" if case == "diurnal_wan" else "tally_decide"
    return dataclasses.replace(exp, trials=100_000), kern, 7


@pytest.mark.parametrize("case", ["quickstart", "cardinality",
                                  "cardinality_stream", "quickstart_stream",
                                  "diurnal_wan", "trace_replay"])
def test_experiment_kernels_equal_plain_versions(cuda, case):
    """An Experiment's Monte-Carlo run on the card launches its path's
    kernel and no other (a masked_tally call with the three masked_sat of
    the race's saturations; the materialized and regime races' three
    sorted_prefix a call), and equals the same run with the quorum
    kernels swapped for their plain versions: decide bits and latencies,
    or counts, histograms, maxima and occupancy, equal; means to 1e-5."""
    from chip_smoke import plain_quorum_kernels, same_stream
    exp, kern, n = _experiment(case, cuda)
    ops.reset_launches()
    got = exp.run("montecarlo")
    torch.cuda.synchronize()
    want = {k: n if k == kern else 0 for k in ops.LAUNCHES}
    if kern == "masked_tally":
        want["masked_sat"] = 3 * n
    if kern in ("masked_tally", "tally_decide"):
        want["sorted_prefix"] = 3 * n
    assert ops.LAUNCHES == want
    with plain_quorum_kernels():
        want = exp.run("montecarlo")
    if got.raw is not None:
        for f in got.raw:
            assert torch.equal(got.raw[f], want.raw[f]), f
    else:
        same_stream(got.stream, want.stream, case)
    for v in got.summary.values():
        assert v.device.type == "cuda"


@pytest.mark.parametrize("path", ["race", "fast_path"])
@pytest.mark.parametrize("masked", [False, True], ids=["card", "masked"])
def test_single_regime_stream_equals_iid_on_card(cuda, path, masked):
    """A single-regime stream (generic outcomes: tally_decide or
    masked_tally) equals the i.i.d. stream (race_card_hist or the fused
    stream kernel on the race; the shared-column or masked fast path) on
    counts, histograms and maxima."""
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.montecarlo import engine, regimes, rng
    specs = [QuorumSpec.paper_headline(11), QuorumSpec.fast_paxos(11)]
    table = engine.build_mask_table(specs, device=cuda,
                                    specialize=not masked)
    only = regimes.MarkovRegimes(names=("only",), delays=(None,),
                                 transition=torch.ones((1, 1)))
    kw = dict(n=11, trials=50_000, chunk=16_384)
    if path == "race":
        run = lambda **r: streaming.race_stream(
            rng.root(2), table, [0.0, 0.2], k_proposers=2, **kw, **r)
    else:
        run = lambda **r: streaming.fast_path_stream(rng.root(2), table,
                                                     **kw, **r)
    plain, mod = run(), run(regimes=only)
    assert mod.occupancy.tolist() == [50_000]
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        assert torch.equal(getattr(plain, f), getattr(mod, f)), f
    assert torch.allclose(plain.mean_ms, mod.mean_ms, rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# The planner on the card.
# ---------------------------------------------------------------------------

def test_planner_warm_repeat_builds_no_plan_and_launches_nothing(cuda):
    """A cold search builds the launch plans its survivor batches need
    (``engine_compiles`` counts them); a repeat of the same geometry under
    another fault budget and objective is answered from the cached search:
    no plan built, no quorum kernel launched."""
    from repro_torch.planner import Planner
    planner = Planner(device=cuda)
    q = dict(n=11, family="cardinality", trials=60_000,
             schedule=((6_000, 1.0), (60_000, 1.0)), chunk=16_384, seed=3)
    plans0 = ops.launch_plans()
    ops.reset_launches()
    r1 = planner.plan(dict(q, faults={"classic": 1}))
    assert r1.ok and r1.cold
    assert r1.engine_compiles == ops.launch_plans() - plans0 >= 0
    # rung 0 materializes (tally_decide), rung 1 streams (race_card_hist)
    assert ops.LAUNCHES["tally_decide"] == 1
    assert ops.LAUNCHES["race_card_hist"] == 4
    plans1 = ops.launch_plans()
    assert plans1 >= 1                     # the library, at least
    ops.reset_launches()
    r2 = planner.plan(dict(q, faults={"fast": 1, "phase1": 1},
                           objective="fast_p50_ms"))
    torch.cuda.synchronize()
    assert r2.ok and not r2.cold and r2.engine_compiles == 0
    assert ops.launch_plans() == plans1
    assert not any(ops.LAUNCHES.values())
    assert planner.stats()["trace_counts"] == {"launch_plans": plans1}


@pytest.mark.parametrize("family,kernel_name", [
    ("cardinality", "race_card_hist"), ("all", "stream_tally_decide_hist")])
def test_survivor_subset_scores_equal_the_full_batch(cuda, family,
                                                     kernel_name):
    """A system's integer-derived axes (and its race stream's counts,
    histogram and maximum) do not depend on which systems share its batch,
    though the kernel's launch plan does (systems or pairs a block)."""
    from repro_torch.frontier import families, score_systems
    members = (families.cardinality_family(11) if family == "cardinality"
               else families.all_families(9))
    # every third member, and every grid / weighted one, so that the
    # subset's table stays masked where the full one is
    sub = [m for i, m in enumerate(members)
           if i % 3 == 0 or m.masks().cardinality_q() is None]
    kw = dict(trials=40_000, chunk=16_384, seed=5, device=cuda)
    ops.reset_launches()
    full = score_systems(members, **kw)
    assert ops.LAUNCHES[kernel_name] == 3
    part = score_systems(sub, **kw)
    idx = [full.labels.index(m.label) for m in sub]
    np.testing.assert_array_equal(part.values, full.values[idx])
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        a = getattr(part.streams["race"], f)
        b = getattr(full.streams["race"], f)[idx]
        assert torch.equal(a, b), f


def test_delay_token_equal_on_cpu_and_card(cuda):
    from repro_torch.montecarlo import latency, regimes
    from repro_torch.planner.cache import _delay_token
    for d in (latency.WanDelay.symmetric(30.0, 11, 2, 3),
              latency.CrashedDelay(latency.ShiftedLognormalDelay(),
                                   latency.crash_mask(11, [0, 4])),
              regimes.gray_failure(11)):
        assert _delay_token(latency.to_device(d, cuda)) == _delay_token(d)


# ---------------------------------------------------------------------------
# The trial mesh on the card.
# ---------------------------------------------------------------------------

MESH_TRIALS, MESH_CHUNK = 200_003, 16_384


@pytest.mark.parametrize("kind", ["race", "regimes"])
def test_sharded_stream_equals_plain_versions_on_card(cuda, kind):
    """A 1 x 4 sharded stream on the card (race_card_hist a domain chunk on
    the race; tally_decide and three sorted_prefix on the regime stream)
    launches its kernel 4 x ceil(T / 4 / chunk) times and no other, and
    equals the same mesh on the plain versions: integers and maxima equal,
    means to 1e-5."""
    from chip_smoke import plain_quorum_kernels, same_stream
    from repro_torch.frontier import cardinality_family
    from repro_torch.montecarlo import engine, regimes, rng
    from repro_torch.parallel.sharding import trial_mesh
    table = engine.build_mask_table(
        [m.masks() for m in cardinality_family(11)], device=cuda)
    reg = (regimes.gray_failure(11, epoch_trials=4_096, p_fail=0.1,
                                p_recover=0.3) if kind == "regimes" else None)
    run = lambda: streaming.race_stream(
        rng.root(8), table, [0.0, 0.2], n=11, k_proposers=2,
        trials=MESH_TRIALS, chunk=MESH_CHUNK, shard=trial_mesh(cuda, 4),
        regimes=reg)
    ops.reset_launches()
    got = run()
    torch.cuda.synchronize()
    kern = "tally_decide" if reg is not None else "race_card_hist"
    per = -(-(-(-MESH_TRIALS // 4)) // MESH_CHUNK)
    want = {k: 4 * per if k == kern else 0 for k in ops.LAUNCHES}
    if reg is not None:
        want["sorted_prefix"] = 3 * 4 * per
    assert ops.LAUNCHES == want
    assert got.n_trials.tolist() == [MESH_TRIALS] * 271
    with plain_quorum_kernels():
        want = run()
    same_stream(got, want, f"sharded {kind}")


@pytest.mark.skipif(os.environ.get("REPRO_GIGATRIAL") != "1",
                    reason="10^9 trials take minutes; set REPRO_GIGATRIAL=1")
def test_gigatrial_race_stream_fixed_memory_p9999(cuda):
    """The twin of tests/test_multihost.py:85: a 10^9-trial race_stream
    completes in fixed memory with the p99.99 tail populated, on whatever
    domains are visible (shard=True; one card warns and streams
    unsharded)."""
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.montecarlo import engine, rng
    table = engine.build_mask_table([QuorumSpec.paper_headline(11)],
                                    device=cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    state = streaming.race_stream(rng.root(0), table, [0.0, 0.2], n=11,
                                  k_proposers=2, trials=1_000_000_000,
                                  chunk=262_144)
    assert int(state.n_trials[0]) == 1_000_000_000
    s = state.summary()
    assert np.isfinite(float(s["p9999_ms"][0]))
    assert float(s["p9999_ms"][0]) >= float(s["p999_ms"][0]) > 0
    assert torch.cuda.max_memory_allocated(cuda) < 2 * 2 ** 30
