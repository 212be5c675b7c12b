"""The plain versions of the flash-attention, RMSNorm and tally_votes
kernels (repro_torch) against the JAX package's Pallas kernels in interpret
mode and its oracles, and the port's RoPE, attention, K/V projection, MLPs
and KV ring buffer against ``repro.models``, on the CPU.  Inputs are made
with numpy from a seed.

Tolerances: flash attention 2e-5 (f32) and 2e-2 (bf16: the output is
rounded to bf16, and the port's plain version casts its softmax weights to
bf16 where the TPU kernel keeps them in f32), the JAX kernel tests' own;
RMSNorm 1e-5 (f32) and 5e-2 (bf16) times max(1, |value|) per entry (one
bf16 ulp is 0.0625 at 8); vote counts and the ring buffer exactly; the
model layers 1e-5 in f32 (the same arithmetic in another order).  The
emulation of the flash kernel's bf16 tensor-core instance
(``ref.attention_tc``: bf16 q, k, v, f32 scores, each key tile's softmax
weights rounded to bf16) is held to the JAX kernel and oracle at JAX's bf16
2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention import ref as jfa_ref
from repro.kernels.quorum_tally import ops as jqt_ops
from repro.kernels.rmsnorm import ops as jrn_ops
from repro.kernels.rmsnorm import ref as jrn_ref
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.quorum_tally import ops as qt_ops
from repro_torch.kernels.quorum_tally import ref as qt_ref
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm import ref as rn_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.models import layers, model as tmodel

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(JDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention: JAX's ATTN_CASES (tests/test_kernels.py)
# ---------------------------------------------------------------------------

ATTN_CASES = [
    (2, 4, 2, 256, 256, 64, True, None, torch.float32),
    (1, 8, 8, 128, 128, 128, True, None, torch.float32),
    (1, 4, 1, 128, 128, 64, True, 64, torch.float32),
    (2, 2, 2, 64, 512, 32, True, None, torch.float32),
    (1, 4, 2, 256, 256, 64, False, None, torch.float32),
    (2, 4, 2, 256, 256, 64, True, None, torch.bfloat16),
    (1, 2, 2, 128, 128, 256, True, 32, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window,dtype", ATTN_CASES)
def test_flash_ref_matches_jax(B, H, KV, S, T, hd, causal, window, dtype):
    r = np.random.default_rng(S * 3 + hd)
    (q, jq), (k, jk), (v, jv) = (
        _pair(r.standard_normal(s), dtype)
        for s in ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd)))
    got = fa_ref.attention(q, k, v, causal, window)
    assert got.dtype == dtype and tuple(got.shape) == (B, H, S, hd)
    assert torch.equal(fa_ops.attention(q, k, v, causal, window), got)
    kern = jfa_ops.attention(jq, jk, jv, causal=causal, window=window,
                             block_q=64, block_k=64)
    f32 = lambda x: x.astype(jnp.float32)
    oracle = jfa_ref.attention(f32(jq), f32(jk), f32(jv), causal=causal,
                               window=window)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for want in (kern, oracle):
        assert np.abs(_np(got) - _np(want)).max() < tol


# JAX's ATTN_CASES in bf16, then hd 80 (zamba2's) with ragged S and T,
# hd 32 non-causal with a window, and hd 48 (zero-padded to 64 on the card)
TC_CASES = [c[:-1] + (torch.bfloat16,) for c in ATTN_CASES] + [
    (1, 4, 2, 45, 1000, 80, True, None, torch.bfloat16),
    (2, 2, 1, 100, 100, 32, False, 17, torch.bfloat16),
    (1, 4, 4, 128, 192, 48, True, 70, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window,dtype", TC_CASES)
def test_flash_tensor_core_emulation_matches_jax(B, H, KV, S, T, hd, causal,
                                                 window, dtype):
    r = np.random.default_rng(S * 5 + hd)
    (q, jq), (k, jk), (v, jv) = (
        _pair(r.standard_normal(s), dtype)
        for s in ((B, H, S, hd), (B, KV, T, hd), (B, KV, T, hd)))
    got = fa_ref.attention_tc(q, k, v, causal, window)
    assert got.dtype == dtype and tuple(got.shape) == (B, H, S, hd)
    f32 = lambda x: x.astype(jnp.float32)
    want = [jfa_ref.attention(f32(jq), f32(jk), f32(jv), causal=causal,
                              window=window)]
    if S % 64 == 0 and T % 64 == 0:
        want.append(jfa_ops.attention(jq, jk, jv, causal=causal,
                                      window=window, block_q=64,
                                      block_k=64))
    for w in want:
        assert np.abs(_np(got) - _np(w)).max() < 2e-2


def test_flash_ref_layout_of_the_model():
    """The model hands (B,S,H,hd) tensors transposed to (B,H,S,hd)."""
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 48, h, 16)).astype(
        np.float32)) for h in (4, 2, 2))
    got = fa_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), window=9)
    want = fa_ref.attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), window=9)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# RMSNorm: the shapes of tests/test_kernels.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((4, 64, 256), torch.float32), ((2, 100, 384), torch.bfloat16),
    ((8, 300), torch.float32), ((1, 7, 130), torch.bfloat16)])
def test_rmsnorm_ref_matches_jax(shape, dtype):
    r = np.random.default_rng(shape[-1])
    x, jx = _pair(r.standard_normal(shape), dtype)
    s, js = _pair(r.standard_normal(shape[-1]), torch.float32)
    got = rn_ref.rmsnorm(x, s)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(rn_ops.rmsnorm(x, s), got)
    tol = 1e-5 if dtype == torch.float32 else 5e-2
    for want in (jrn_ops.rmsnorm(jx, js), jrn_ref.rmsnorm(jx, js)):
        w = _np(want)
        assert (np.abs(_np(got) - w) <= tol * np.maximum(1.0, np.abs(w))
                ).all()


# ---------------------------------------------------------------------------
# tally_votes / quorum_reached: the shapes of tests/test_kernels.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,n,V", [(100, 11, 2), (1024, 11, 3), (3000, 7, 2),
                                   (5000, 32, 5), (700, 200, 12)])
def test_tally_votes_matches_jax(S, n, V):
    votes = np.random.default_rng(S + n).integers(-1, V, (S, n)).astype(
        np.int32)
    tv = torch.from_numpy(votes)
    want = np.asarray(jqt_ops.tally_votes(jnp.asarray(votes), V))
    assert np.array_equal(qt_ref.tally_votes(tv, V).numpy(), want)
    assert np.array_equal(qt_ops.tally_votes(tv, V).numpy(), want)
    for q in (1, n // 2 + 1, n):
        want_q = np.asarray(jqt_ops.quorum_reached(jnp.asarray(votes), V, q))
        assert np.array_equal(qt_ops.quorum_reached(tv, V, q).numpy(),
                              want_q)
        assert np.array_equal(qt_ref.quorum_reached(tv, V, q).numpy(),
                              want_q)


def test_cpu_dispatch_launches_no_kernel():
    fa_ops.reset_launches()
    rn_ops.reset_launches()
    qt_ops.reset_launches()
    x = torch.ones(1, 2, 8, 16)
    fa_ops.attention(x, x, x)
    rn_ops.rmsnorm(x, torch.ones(16))
    qt_ops.quorum_reached(torch.zeros((4, 3), dtype=torch.int32), 2, 2)
    assert fa_ops.LAUNCHES == {"flash_attention": 0, "flash_attention_tc": 0}
    assert rn_ops.LAUNCHES == {"rmsnorm": 0}
    assert qt_ops.LAUNCHES["tally_votes"] == 0


@pytest.mark.parametrize("call", ["flash", "rmsnorm"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers never run a CPU tensor, and raise before building."""
    x = torch.ones(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "flash":
            fa_kernel.attention(x, x, x)
        else:
            rn_kernel.rmsnorm(x, torch.ones(16))


@pytest.mark.parametrize("call", ["flash", "rmsnorm", "ssd"])
def test_kernel_wrappers_refuse_autograd(call):
    """The CUDA kernels have no backward, so a wrapper raises when autograd
    would record through it (a graph cut without a word otherwise), and only
    then: under no_grad the same call meets the device check."""
    x = torch.ones(1, 2, 8, 16, requires_grad=True)

    def run():
        if call == "flash":
            fa_kernel.attention(x, x, x)
        elif call == "rmsnorm":
            rn_kernel.rmsnorm(x, torch.ones(16))
        else:
            ssd_kernel.ssd(x, torch.zeros(1, 2, 8), torch.ones(1, 2, 4),
                           torch.ones(1, 2, 4), 2)
    with pytest.raises(RuntimeError, match="no backward"):
        run()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        run()


def test_ops_reject_other_devices():
    m = torch.zeros((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or"):
        fa_ops.attention(m, m, m)
    with pytest.raises(ValueError, match="CUDA or"):
        rn_ops.rmsnorm(m, torch.ones(16, device="meta"))


# ---------------------------------------------------------------------------
# Model layers against repro.models.layers, in f32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_pair():
    """Reduced zamba2 (H 4, KV 2, hd 16): JAX's init_attention params, and
    the port's Attention module holding the same values."""
    cfg_j = jax_reduced_config(jax_get_config("zamba2_2_7b"))
    cfg_t = reduced_config(get_config("zamba2_2_7b"))
    pj, _ = jlayers.init_attention(cfg_j, jax.random.PRNGKey(3))
    pt = layers.Attention(cfg_t, None, "cpu")
    pt.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in pj.items()}, strict=True)
    return cfg_j, cfg_t, pj, pt


def test_rope_matches_jax():
    pos = np.arange(3, 40, dtype=np.int32)
    sj, cj = jlayers.rope_tables(jnp.asarray(pos), 16, 10000.0)
    st, ct = layers.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    assert np.abs(st.numpy() - np.asarray(sj)).max() < 1e-5
    assert np.abs(ct.numpy() - np.asarray(cj)).max() < 1e-5
    x = np.random.default_rng(0).standard_normal((2, 37, 4, 16))
    got = layers.apply_rope(torch.from_numpy(x.astype(np.float32)), st, ct)
    want = jlayers.apply_rope(jnp.asarray(x, jnp.float32), sj, cj)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("window", [None, 8])
def test_attention_and_project_kv_match_jax(attn_pair, window):
    cfg_j, cfg_t, pj, pt = attn_pair
    S = 40
    x = np.random.default_rng(1).standard_normal((2, S, cfg_t.d_model))
    xt, xj = torch.from_numpy(x.astype(np.float32)), jnp.asarray(
        x, jnp.float32)
    pos = np.arange(S, dtype=np.int32)
    kj, vj = jlayers.project_kv(cfg_j, pj, xj, jnp.asarray(pos))
    with torch.no_grad():
        kt, vt = layers.project_kv(cfg_t, pt, xt, torch.from_numpy(pos))
        yt = layers.attention(cfg_t, pt, xt, kt, vt, torch.from_numpy(pos),
                              torch.from_numpy(pos), window=window)
    for a, b in ((kt, kj), (vt, vj)):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-5
    yj = jlayers.attention(cfg_j, pj, xj, kj, vj, jnp.asarray(pos),
                           jnp.asarray(pos), window=window)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-5


def test_attention_over_a_cache_matches_jax(attn_pair):
    """Decode-style: one query against a ring buffer with empty slots
    (k_valid) and a window."""
    cfg_j, cfg_t, pj, pt = attn_pair
    r = np.random.default_rng(2)
    T, hd = 24, cfg_t.hd
    x = r.standard_normal((2, 1, cfg_t.d_model))
    k = r.standard_normal((2, T, cfg_t.n_kv_heads, hd))
    v = r.standard_normal((2, T, cfg_t.n_kv_heads, hd))
    k_pos = np.where(np.arange(T) < 19, np.arange(T) + 5, -1).astype(np.int32)
    q_pos = np.array([23], np.int32)
    valid = k_pos >= 0
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    with torch.no_grad():
        yt = layers.attention(cfg_t, pt, f(x), f(k), f(v),
                              torch.from_numpy(q_pos),
                              torch.from_numpy(np.maximum(k_pos, 0)),
                              window=10, k_valid=torch.from_numpy(valid))
    yj = jlayers.attention(cfg_j, pj, jnp.asarray(x, jnp.float32),
                           jnp.asarray(k, jnp.float32),
                           jnp.asarray(v, jnp.float32), jnp.asarray(q_pos),
                           jnp.asarray(np.maximum(k_pos, 0)), window=10,
                           k_valid=jnp.asarray(valid))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-5


@pytest.mark.parametrize("mlp", ["swiglu", "relu2", "gelu"])
def test_apply_mlp_matches_jax(mlp):
    cfg_j = dataclasses.replace(
        jax_reduced_config(jax_get_config("zamba2_2_7b")), mlp=mlp)
    cfg_t = dataclasses.replace(
        reduced_config(get_config("zamba2_2_7b")), mlp=mlp)
    pj, _ = jlayers.init_mlp(cfg_j, jax.random.PRNGKey(4))
    pt = layers.MLP(cfg_t, None, "cpu")
    pt.load_state_dict({k: torch.from_numpy(np.array(v))
                        for k, v in pj.items()}, strict=True)
    x = np.random.default_rng(3).standard_normal((2, 9, cfg_t.d_model))
    with torch.no_grad():
        yt = layers.apply_mlp(cfg_t, pt, torch.from_numpy(
            x.astype(np.float32)))
    yj = jlayers.apply_mlp(cfg_j, pj, jnp.asarray(x, jnp.float32))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-5


@pytest.mark.parametrize("T,S,start", [(16, 5, 0), (16, 5, 13), (16, 16, 3),
                                       (16, 40, 0), (16, 23, 9)])
def test_ring_write_matches_jax(T, S, start):
    """Into an empty or wrapping ring buffer, and the S >= T roll."""
    r = np.random.default_rng(T * S + start)
    buf = r.standard_normal((2, T, 3, 4)).astype(np.float32)
    new = r.standard_normal((2, S, 3, 4)).astype(np.float32)
    pos_buf = np.where(r.random(T) < 0.5, -1, r.integers(0, 99, T)).astype(
        np.int32)
    q_pos = (start + np.arange(S)).astype(np.int32)
    jb, jp = jmodel._ring_write(jnp.asarray(buf), jnp.asarray(new),
                                jnp.asarray(pos_buf), jnp.asarray(q_pos))
    tb, tp = tmodel._ring_write(torch.from_numpy(buf), torch.from_numpy(new),
                                torch.from_numpy(pos_buf),
                                torch.from_numpy(q_pos))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert tp.dtype == torch.int32
