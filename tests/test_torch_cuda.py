"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one; they import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Integer outputs must be equal; the fused kernel's f32 latency sum reduces
per-block partials, so it is compared to 1e-5 relative; maxima are exact.
"""
import numpy as np
import pytest
import torch

from chip_smoke import stream_test_inputs as _inputs
from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.montecarlo import streaming

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


@pytest.mark.parametrize("S,n,M,G,K,k_sat", [
    (300, 11, 2, 3, 2, (4, 5, 6)),
    (1025, 9, 1, 6, 3, (9, 9, 9)),
    (513, 7, 3, 1, 2, (2, 3, 2)),
    (700, 11, 4, 2, 2, (11, 1, 7)),
    (8192, 12, 13, 12, 2, (12, 4, 8)),
])
def test_stream_kernel(cuda, S, n, M, G, K, k_sat):
    args = _inputs(S * 13 + M, S, n, M, G, K, cuda)
    kw = dict(n_values=K, k_sat=k_sat, precision=0.01, bins=BINS,
              undecided_ms=5e8)
    h_k, s_k = kernel.stream_tally_decide_hist(*args, **kw)
    h_r, s_r = ref.stream_tally_decide_hist(*args, **kw)
    assert torch.equal(h_k, h_r)
    for f in ("n_fast", "n_recovery", "n_undecided", "max_ms"):
        assert torch.equal(s_k[f], s_r[f]), f
    torch.testing.assert_close(s_k["sum_ms"], s_r["sum_ms"], rtol=1e-5,
                               atol=0.0)


def test_stream_kernel_all_invalid_block(cuda):
    args = _inputs(3, 128, 5, 1, 2, 2, cuda)
    args[-1] = torch.zeros(128, dtype=torch.bool, device=cuda)
    h, s = kernel.stream_tally_decide_hist(
        *args, n_values=2, k_sat=(3, 3, 3), precision=0.01, bins=BINS,
        undecided_ms=5e8)
    assert int(h.sum()) == 0 and int(s["n_fast"].sum()) == 0
    assert bool(torch.isneginf(s["max_ms"]).all())


def test_ops_launch_on_cuda_and_count(cuda):
    ops.reset_launches()
    votes = torch.zeros((64, 5), dtype=torch.int32, device=cuda)
    ops.tally_decide(votes, 2, 3)
    ops.masked_tally(votes, torch.ones((2, 5), device=cuda),
                     torch.ones(2, device=cuda), 2)
    assert ops.LAUNCHES == {"tally_decide": 1, "masked_tally": 1,
                            "stream_tally_decide_hist": 0}


def test_wrappers_raise_on_bad_input(cuda):
    votes = torch.zeros((8, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        kernel.tally_decide(votes.long(), 2, 3)
    with pytest.raises(ValueError, match="K <= 8"):
        kernel.tally_decide(votes, 9, 3)
    with pytest.raises(ValueError, match="n <= 128"):
        kernel.tally_decide(torch.zeros((8, 129), dtype=torch.int32,
                                        device=cuda), 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.masked_tally(torch.zeros((5, 8), dtype=torch.int32,
                                        device=cuda).T, torch.ones(
            (1, 5), device=cuda), torch.ones(1, device=cuda), 2)
