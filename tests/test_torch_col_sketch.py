"""``col_sketch``: the sketch update of the cardinality fast and classic
streams, each shared latency column's histogram, undecided count, sum and
max over a chunk's valid trials.

The plain version (``ref.col_sketch``) is held to a numpy reckoning of the
same sketch, and ``streaming._cols_card_update`` on the CPU to the torch
code it ran before the kernel (copied below), bit for bit.  Buckets come
from ``log``; numpy's and torch's f32 ``log`` may differ in the last ulp,
so a latency within 4 ulp of a bucket edge may sit one bucket over
(``assert_hist_match``).  The kernel against the plain version on the card
is in ``tests/test_torch_cuda.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.montecarlo import streaming
from repro_torch.montecarlo.engine import UNDECIDED_MS

from test_torch_quorum_tally import assert_hist_match

PREC = 0.01
BINS = streaming.sketch_bins(PREC)
UND = float(UNDECIDED_MS)


def columns(seed: int, S: int, Kc: int) -> np.ndarray:
    """(S, Kc) f32 latencies: lognormal order statistics around a
    millisecond, with values below the 1e-2 ms floor (0, negatives), above
    the 1e7 ms clamp, at and above the undecided mark, and on bucket edges
    and one ulp either side."""
    r = np.random.default_rng(seed)
    x = np.sort(0.5 + np.exp(r.normal(-1.2, 0.55, (S, Kc))), axis=1)
    g = streaming.sketch_gamma(PREC)
    edges = np.float32(streaming.SKETCH_MIN_MS) * np.float32(g) ** np.arange(
        1, BINS, 97, dtype=np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(0)),
                            np.nextafter(edges, np.float32(np.inf))])
    special = np.concatenate([
        [0.0, -1.0, 1e-4, 9.999e-3, 1e-2, 1.0000001e-2, 1e7, 3e7, 9e7,
         UND, np.nextafter(np.float32(UND), np.float32(0)), 2 * UND],
        edges]).astype(np.float32)
    pick = r.random((S, Kc)) < 0.15
    x = np.where(pick, special[r.integers(0, special.size, (S, Kc))], x)
    return x.astype(np.float32)


def numpy_sketch(x: np.ndarray, valid: np.ndarray):
    """The sketch reckoned in numpy: the f32 bucket expression, bincounts a
    column, f64 sums."""
    f = np.float32
    b = np.ceil(np.log(np.maximum(x, f(streaming.SKETCH_MIN_MS))
                       / f(streaming.SKETCH_MIN_MS))
                / f(math.log(streaming.sketch_gamma(PREC))))
    b = np.clip(b, 0, BINS - 1).astype(np.int64)
    und = x >= f(UND)
    S, Kc = x.shape
    LH = np.zeros((Kc, BINS + 1), np.int64)
    s = np.zeros(Kc)
    m = np.full(Kc, -np.inf, np.float32)
    for c in range(Kc):
        ok = valid & ~und[:, c]
        LH[c, :BINS] = np.bincount(b[ok, c], minlength=BINS)
        LH[c, BINS] = (valid & und[:, c]).sum()
        s[c] = x[ok, c].astype(np.float64).sum()
        if ok.any():
            m[c] = x[ok, c].max()
    return LH, s, m, int(valid.sum())


CASES = ["ragged", "all_invalid", "undecided_column", "full"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("Kc", [1, 5, 11, 32])
def test_ref_col_sketch_matches_numpy(Kc, case):
    """Histograms, undecided counts, maxima and the valid count as numpy
    reckons them; sums to 1e-6 relative (f32 against f64)."""
    S = 1537
    x = columns(Kc * 7 + len(case), S, Kc)
    valid = np.arange(S) < S - S // 7
    if case == "all_invalid":
        valid[:] = False
    elif case == "undecided_column":
        x[:, Kc // 2] = np.float32(2 * UND)
    elif case == "full":
        valid[:] = True
    LH, s, m, nv = ref.col_sketch(torch.as_tensor(x), torch.as_tensor(valid),
                                  precision=PREC, bins=BINS, undecided_ms=UND)
    LH_n, s_n, m_n, nv_n = numpy_sketch(x, valid)
    assert LH.dtype == torch.int32 and tuple(LH.shape) == (Kc, BINS + 1)
    assert s.dtype == m.dtype == torch.float32 and nv.dtype == torch.int32
    np.testing.assert_array_equal(LH[:, BINS].numpy(), LH_n[:, BINS])

    def lat_of(c):
        return x[valid & (x[:, c] < np.float32(UND)), c]

    assert_hist_match(LH[:, :BINS].numpy(), LH_n[:, :BINS], lat_of,
                      what=f"col_sketch Kc={Kc} {case}")
    np.testing.assert_array_equal(m.numpy(), m_n)
    np.testing.assert_allclose(s.numpy(), s_n, rtol=1e-6, atol=0.0)
    assert int(nv) == nv_n
    if case == "all_invalid":
        assert not LH.any() and not s.any() and bool(torch.isneginf(m).all())
    if case == "undecided_column":
        assert int(LH[Kc // 2, BINS]) == int(valid.sum())
        assert not LH[Kc // 2, :BINS].any()
        assert float(m[Kc // 2]) == -math.inf


def test_ops_col_sketch_runs_the_plain_version_on_cpu():
    x = torch.as_tensor(columns(3, 300, 11))
    valid = torch.arange(300) < 250
    ops.reset_launches()
    got = ops.col_sketch(x, valid, precision=PREC, bins=BINS,
                         undecided_ms=UND)
    want = ref.col_sketch(x, valid, precision=PREC, bins=BINS,
                          undecided_ms=UND)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not any(ops.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.col_sketch(x, valid, precision=PREC, bins=BINS,
                          undecided_ms=UND)


def previous_cols_card_update(state, cols, col_of_m, valid, *, fast):
    """``streaming._cols_card_update`` as it was before ``col_sketch``."""
    B = state.bins
    Kc = cols.shape[1]
    und = cols >= UNDECIDED_MS
    bkey = torch.where(und, B,
                       streaming.bucket_index(cols, state.precision).long())
    bkey = torch.where(valid[:, None], bkey, B + 1)
    flat = torch.arange(Kc, device=cols.device)[None, :] * (B + 2) + bkey
    LH = streaming.occurrences(flat, Kc * (B + 2)).reshape(Kc, B + 2)
    col_of_m = col_of_m.long()
    rows = LH[col_of_m]
    hist = rows[:, :B]
    n_und = rows[:, B]
    n_dec = hist.sum(dim=-1, dtype=torch.int32)
    ok = valid[:, None] & ~und
    col_sum = torch.where(ok, cols, 0.0).sum(dim=0)
    col_max = torch.where(ok, cols, -math.inf).amax(dim=0)
    zero = torch.zeros_like(n_dec)
    n_valid = valid.sum().to(torch.int32).expand(col_of_m.shape)
    return state._absorb(
        n_trials=n_valid, n_fast=n_dec if fast else zero,
        n_recovery=zero if fast else n_dec, n_undecided=n_und,
        cnt=n_dec.to(torch.float32), lat_sum=col_sum[col_of_m],
        lat_max=col_max[col_of_m], hist=hist)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "classic"])
@pytest.mark.parametrize("Kc,M", [(11, 271), (5, 7), (1, 3)])
def test_cols_card_update_is_the_previous_code_bit_for_bit(Kc, M, fast):
    """Two chunks absorbed into a summary, the second ragged: every field
    the previous code's, f32 fields bit for bit."""
    r = np.random.default_rng(Kc * 100 + M + fast)
    col_of_m = torch.as_tensor(r.integers(0, Kc, M), dtype=torch.int32)
    a = b = streaming.StreamSummary.zeros(M, PREC)
    for i, S in enumerate((4096, 3001)):
        x = torch.as_tensor(columns(i + 10 * Kc, S, Kc))
        valid = torch.arange(S) < S - 97 * i
        a = streaming._cols_card_update(a, x, col_of_m, valid, fast=fast)
        b = previous_cols_card_update(b, x, col_of_m, valid, fast=fast)
    for f in streaming._FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f
    assert int(a.n_trials[0]) == 4096 + 3001 - 97
