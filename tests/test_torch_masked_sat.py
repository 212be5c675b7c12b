"""The masked saturation (``ops.masked_sat``, the body of the engine's
``_sat_time``) on the CPU: against the JAX package's ``engine._sat_time``
on numpy-made inputs, against the port's former ``_sat_time`` body, and its
refusals.  The CUDA kernel is held to the plain version on the card
(``tests/test_torch_cuda.py -k masked_sat``).

Where the weights are integral (or quarters: every partial sum exact in
f32) the answer is compared with JAX's bit for bit.  PyTorch's CPU
``cumsum`` accumulates f32 in double, so other weights are held only to the
port's own former body, exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.montecarlo import engine as jax_engine
from repro_torch.kernels.quorum_tally import kernel, ops
from repro_torch.montecarlo import engine, streaming

from chip_smoke import (MASKED_SAT_CASES, masked_sat_inputs, mixed_members,
                        sequential_sat)

BIG = float(engine.BIG)
EXACT_ROWS = ("mixed_n12", "integral", "unit", "quarters", "negative",
              "nonpositive")


def small(case):
    """A MASKED_SAT_CASES entry cut to what a CPU test holds: at most 512
    trials, 24 systems and 64 rows."""
    name, S, n, L, M, G, rows, per = case
    return (name, min(S, 512), n, L, min(M, 24), min(G, 64), rows, per)


def parent_sat_time(sorted_x, perm, w, t):
    """The port's ``engine._sat_time`` before it called ``ops.masked_sat``,
    as it was."""
    M, G, n = w.shape
    if sorted_x.dim() == 2:
        sorted_x = sorted_x.expand(M, -1, -1)
        perm = perm.expand(M, -1, -1)
    S, L = sorted_x.shape[1:]
    w_perm = torch.gather(w[:, :, None, :].expand(M, G, S, n), 3,
                          perm[:, None].expand(M, G, S, L))
    csum = torch.cumsum(w_perm, dim=-1)
    ok = csum >= t[:, :, None, None]
    idx = torch.argmax(ok.to(torch.int32), dim=-1, keepdim=True)
    reached = ok[..., -1]
    tt = torch.gather(sorted_x[:, None].expand(M, G, S, L), 3, idx)[..., 0]
    return torch.where(reached, tt, torch.full_like(tt, BIG)).amin(dim=1)


def jax_sat(sorted_x, perm, w, t) -> np.ndarray:
    """JAX's ``_sat_time`` a system at a time, (M, S)."""
    M = w.shape[0]
    out = []
    for m in range(M):
        x = sorted_x[m] if sorted_x.dim() == 3 else sorted_x
        p = perm[m] if perm.dim() == 3 else perm
        out.append(np.asarray(jax_engine._sat_time(
            jnp.asarray(x.numpy()), jnp.asarray(p.numpy().astype(np.int32)),
            jnp.asarray(w[m].numpy()), jnp.asarray(t[m].numpy()))))
    return np.stack(out)


def assert_same_bits(got, want, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), f"{what}: {int(bad.sum())} entries differ"


@pytest.mark.parametrize("case", [c for c in MASKED_SAT_CASES
                                  if c[6] in EXACT_ROWS],
                         ids=lambda c: c[0])
def test_masked_sat_matches_jax_bit_for_bit(case):
    x, p, w, t = masked_sat_inputs(small(case), "cpu")
    got = ops.masked_sat(x, p, w, t, big=BIG)
    assert_same_bits(got, jax_sat(x, p, w, t), case[0])


@pytest.mark.parametrize("case", MASKED_SAT_CASES, ids=lambda c: c[0])
def test_masked_sat_is_the_former_sat_time(case):
    """Any weights: the plain version is the former body, bit for bit, and
    the engine's ``_sat_time`` goes through it without a launch."""
    x, p, w, t = masked_sat_inputs(small(case), "cpu")
    ops.reset_launches()
    got = engine._sat_time(x, p, w, t)
    assert_same_bits(got, parent_sat_time(x, p, w, t), case[0])
    assert got.dtype == torch.float32 and tuple(got.shape) == (
        w.shape[0], x.shape[-2])
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("case", [c for c in MASKED_SAT_CASES
                                  if c[6] in EXACT_ROWS],
                         ids=lambda c: c[0])
def test_sequential_sum_is_the_plain_version_on_exact_weights(case):
    """The card tests' yardstick for inexact weights (one f32 add a
    position) agrees with the plain version wherever sums are exact."""
    x, p, w, t = masked_sat_inputs(small(case), "cpu")
    assert_same_bits(sequential_sat(x, p, w, t, BIG),
                     ops.masked_sat(x, p, w, t, big=BIG), case[0])


@pytest.mark.parametrize("per", [False, True], ids=["shared", "per_system"])
def test_prefix_at_saturation_depths_equals_the_full_sort(per):
    """Cut at the table's saturation depth, the prefix gives the full
    sort's answer (and JAX's) bit for bit."""
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device="cpu")
    k2f = engine.saturation_depths(table)[2]
    w, t = table["p2f_w"], table["p2f_t"]
    r = np.random.default_rng(7)
    shape = (w.shape[0], 700, 12) if per else (700, 12)
    x = np.floor(np.exp(r.standard_normal(shape)) * 8.0) / 4.0
    x[r.random(shape) < 0.15] = 1e9
    xs, ps = torch.sort(torch.as_tensor(x.astype(np.float32)), dim=-1,
                        stable=True)
    full = ops.masked_sat(xs, ps, w, t, big=BIG)
    cut = ops.masked_sat(xs[..., :k2f], ps[..., :k2f], w, t, big=BIG)
    assert_same_bits(cut, full, f"prefix {k2f}")
    assert_same_bits(cut, jax_sat(xs[..., :k2f], ps[..., :k2f], w, t),
                     "prefix vs JAX")


def test_edges_by_hand():
    """One trial, arrivals 1, 2, 2 (tied), LOST: unit row t=2 -> 2; a row
    it cannot fill -> BIG; t <= 0 -> the first arrival; a padding row
    alone -> BIG; a row that needs the LOST acceptor -> its LOST time."""
    x = torch.tensor([[1.0, 2.0, 2.0, 1e9]])
    p = torch.tensor([[3, 0, 2, 1]])
    rows = {
        "unit t=2": ([1, 1, 1, 1], 2.0, 2.0),
        "cannot fill": ([1, 0, 0, 1], 3.0, BIG),
        "t <= 0": ([0, 0, 0, 0], -0.0, 1.0),
        "padding": ([0, 0, 0, 0], 2.0 ** 30, BIG),
        "needs the lost one": ([0, 5, 0, 0], 5.0, 1e9),
        "tie": ([0, 0, 1, 0], 1.0, 2.0),
    }
    for name, (wr, tr, want) in rows.items():
        w = torch.tensor([[wr]], dtype=torch.float32)
        t = torch.tensor([[tr]], dtype=torch.float32)
        got = float(ops.masked_sat(x, p, w, t, big=BIG)[0, 0])
        assert got == want, (name, got, want)
    # the minimum over a system's rows, padding among them
    w = torch.tensor([[[0, 0, 0, 0], [1, 1, 1, 1], [0, 5, 0, 0]]],
                     dtype=torch.float32)
    t = torch.tensor([[2.0 ** 30, 3.0, 5.0]])
    assert float(ops.masked_sat(x, p, w, t, big=BIG)[0, 0]) == 2.0


BAD = {
    "weights not 3-d": lambda x, p, w, t: (x, p, w[0], t),
    "thresholds not (M, G)": lambda x, p, w, t: (x, p, w, t[:, :1]),
    "no rows": lambda x, p, w, t: (x, p, w[:, :0], t[:, :0]),
    "L = 0": lambda x, p, w, t: (x[:, :0], p[:, :0], w, t),
    "L > n": lambda x, p, w, t: (torch.cat([x, x], 1), torch.cat([p, p], 1),
                                 w, t),
    "ids of another shape": lambda x, p, w, t: (x, p[:, :2], w, t),
    "orders of other systems": lambda x, p, w, t: (x.expand(3, -1, -1),
                                                   p.expand(3, -1, -1), w, t),
    "f64 arrivals": lambda x, p, w, t: (x.double(), p, w, t),
    "int32 ids": lambda x, p, w, t: (x, p.int(), w, t),
    "f64 weights": lambda x, p, w, t: (x, p, w.double(), t),
    "int thresholds": lambda x, p, w, t: (x, p, w, t.int()),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_refuses_bad_shapes_and_types(bad):
    x, p, w, t = masked_sat_inputs(("r", 16, 5, 5, 2, 3, "integral", False),
                                   "cpu")
    with pytest.raises(ValueError, match="masked_sat"):
        ops.masked_sat(*BAD[bad](x, p, w, t), big=BIG)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, p, w, t = masked_sat_inputs(("r", 16, 5, 5, 2, 3, "integral", False),
                                   "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.masked_sat(x, p, w, t, big=BIG)


def test_masked_fast_path_stream_unchanged_on_cpu(monkeypatch):
    """The masked fast path's stream on the CPU launches nothing and gives
    the former ``_sat_time``'s summary exactly."""
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device="cpu")
    kw = dict(n=12, trials=5000, chunk=2048, shard=False)
    ops.reset_launches()
    got = streaming.fast_path_stream(11, table, **kw)
    assert not any(ops.LAUNCHES.values())
    monkeypatch.setattr(engine, "_sat_time", parent_sat_time)
    want = streaming.fast_path_stream(11, table, **kw)
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms", "mean_ms"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
