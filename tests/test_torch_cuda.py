"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one; they import neither JAX
nor the JAX package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Integer outputs must be equal; the fused kernel's f32 latency sum reduces
per-block partials, so it is compared to 1e-5 relative; maxima are exact.
The SSD kernel is held to its plain chunked version and to the recurrence
at the JAX kernel tests' tolerances (1e-3 f32, 3e-2 with bf16 xw).
"""
import numpy as np
import pytest
import torch

from chip_smoke import stream_test_inputs as _inputs
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import model as model_mod
from repro_torch.models.ssm import ssd_chunked
from repro_torch.montecarlo import streaming

BINS = streaming.sketch_bins(0.01)


def ssd_test_inputs(seed, B, S, nh, hd, ds, x_dtype, bc_dtype, dev):
    """The JAX kernel tests' SSD inputs, drawn with numpy: xw and B, C
    ~ 0.5 N(0,1), da = -0.3 |N(0,1)|, a nonzero initial state 0.1 N(0,1)."""
    r = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        a.astype(np.float32)).to(dev).to(dt)
    return (t(r.standard_normal((B, S, nh, hd)) * 0.5, x_dtype),
            t(-np.abs(r.standard_normal((B, S, nh))) * 0.3),
            t(r.standard_normal((B, S, ds)) * 0.5, bc_dtype),
            t(r.standard_normal((B, S, ds)) * 0.5, bc_dtype),
            t(r.standard_normal((B, nh, hd, ds)) * 0.1))


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


def test_ssd_ops_launch_on_cuda_and_count(cuda):
    xw, da, Bm, Cm, _ = ssd_test_inputs(4, 1, 96, 2, 16, 16, torch.float32,
                                        torch.float32, cuda)
    ssd_ops.reset_launches()
    ssd_ops.ssd(xw, da, Bm, Cm, chunk=256)          # one chunk of 96
    ssd_ops.ssd(xw, da, Bm, Cm, chunk=32)
    assert ssd_ops.LAUNCHES == {"ssd": 2}
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
