"""The port's MoE and MLA against the JAX package's, on the CPU:
``deepseek_v2_lite_16b`` (MLA + MoE with shared experts) and
``arctic_480b`` (GQA + MoE with a dense residual MLP), reduced.

Each reduced configuration is built by JAX's ``DecoderLM.init`` (jitted);
``params_from_jax`` carries its params into the port, and the same token
ids, drawn with numpy from a seed, go through both models.

* f32 (both packages' ``COMPUTE_DTYPE`` patched to f32): ``forward``,
  ``prefill`` and 4 ``decode_step``s agree to 1e-4, the MLA caches and KV
  caches to 1e-4 of their largest entry, positions exactly; so does
  ``absorbed_decode``.  MLA without MoE decodes what the forward computes
  (JAX's ``test_mla_decode_exact_without_moe``).
* bf16 (as served): within twice what JAX's own bf16 run differs from its
  f32 run (bf16 rounds at other places in the two frameworks, and a
  rounding flip can move a token to another expert in either).
* The router's tie order: ``moe.top_k`` gives ``lax.top_k``'s indices on
  arrays with planted ties, and a batch of repeated tokens (equal gates,
  capacity dropping among equals) routes as JAX does.
* The combine: the same bits in bf16 as one ``index_add_`` an expert in
  ascending expert order (JAX's expert-major scatter-add).
* Training: loss and gradients against ``jax.value_and_grad(loss)`` in
  f32, and ``launch.train --smoke --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.models import model as torch_model
from repro_torch.models import moe as torch_moe
from repro_torch.models.convert import params_from_jax, params_to_jax

from _torch_model_parity import (BF16, F32, assert_caches_close,
                                 assert_grads_close, build_pair, forward_jax,
                                 forward_port, loss_and_grads, serve_jax,
                                 serve_port)

ARCHS = ["deepseek_v2_lite_16b", "arctic_480b"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny models, several test workers: one intra-op thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, arch):
    if arch not in pairs:
        pairs[arch] = build_pair(arch)
    return pairs[arch]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_in_f32(pairs, arch):
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = {"tokens": _tokens(0, (2, 64), cfg.vocab)}
    lj = forward_jax(mj, params, batch, F32[0])
    lt = forward_port(mt, batch, F32[1])
    assert lt.shape == lj.shape
    assert np.abs(lt - lj).max() < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_in_f32(pairs, arch):
    """A 45-token prompt, then 4 steps: logits and every cache buffer
    (MLA's ckv and krope, GQA's k and v) to 1e-4."""
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = {"tokens": _tokens(1, (2, 45), cfg.vocab)}
    fed = list(_tokens(2, (4, 2, 1), cfg.vocab))
    lj, cj = serve_jax(mj, params, batch, fed, F32[0])
    lt, ct = serve_port(mt, batch, fed, F32[1])
    for a, b in zip(lt, lj):
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-4
    names = set(ct["layers"][0]["global_0"])
    assert names == ({"ckv", "krope", "k_pos"} if cfg.mla
                     else {"k", "v", "k_pos"})
    assert_caches_close(ct, cj, 1e-4)


def test_absorbed_decode_matches_jax_and_the_decompressing_branch():
    """``absorbed_decode`` (attention in the rank-r latent space) against
    JAX's same branch, and against the port's decompressing branch: f32
    to 1e-4."""
    cfg, mj, params, mt = build_pair(
        "deepseek_v2_lite_16b", mla=dataclasses.replace(
            reduced_config(get_config("deepseek_v2_lite_16b")).mla,
            absorbed_decode=True))
    assert cfg.mla.absorbed_decode
    batch = {"tokens": _tokens(3, (2, 33), cfg.vocab)}
    fed = list(_tokens(4, (4, 2, 1), cfg.vocab))
    lj, _ = serve_jax(mj, params, batch, fed, F32[0])
    lt, _ = serve_port(mt, batch, fed, F32[1])
    mt.cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, absorbed_decode=False))
    ld, _ = serve_port(mt, batch, fed, F32[1])
    for a, b, c in zip(lt, lj, ld):
        assert np.abs(a - b).max() < 1e-4
        assert np.abs(a - c).max() < 1e-4


def test_mla_decode_equals_forward_without_moe():
    """MLA with a dense MLP (``moe=None``): prefill of 40 tokens and 8
    decode steps give the forward's logits at each position, f32 to
    1e-4 (JAX's ``test_mla_decode_exact_without_moe``)."""
    cfg = dataclasses.replace(reduced_config(get_config(
        "deepseek_v2_lite_16b")), moe=None, d_ff=128, family="dense")
    mt = torch_model.DecoderLM(cfg, device="cpu", seed=3)
    toks = _tokens(5, (2, 48), cfg.vocab)
    full = forward_port(mt, {"tokens": toks}, torch.float32)
    lt, _ = serve_port(mt, {"tokens": toks[:, :40]},
                       [toks[:, t:t + 1] for t in range(40, 47)],
                       torch.float32)
    got = np.concatenate(lt, axis=1)
    assert np.abs(got - full[:, 39:47]).max() < 1e-4


def _planted_ties(seed, shape, levels):
    """Values drawn from a few levels, so most rows hold equal entries."""
    r = np.random.default_rng(seed)
    return r.choice(np.linspace(0.0, 1.0, levels), size=shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,k,levels", [
    ((64, 8), 2, 3), ((37, 64), 6, 4), ((4, 512), 57, 2), ((16, 128), 128, 5),
    ((8, 16), 3, 1)])
def test_top_k_takes_lax_top_k_tie_order(shape, k, levels):
    x = _planted_ties(sum(shape) + k, shape, levels)
    vj, ij = jax.lax.top_k(jnp.asarray(x), k)
    vt, it = torch_moe.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 24), (1, 3)])
def test_routing_of_repeated_tokens_matches_jax(pairs, arch, B, S):
    """Rows repeated many times give equal gates, so the top-C of each
    expert chooses among equal weights (and among the weight-0 fill):
    the port's MoE block output, in f32, equals JAX's to 1e-5 -- the same
    tokens routed and dropped."""
    cfg, mj, params, mt = _pair(pairs, arch)
    r = np.random.default_rng(B * S)
    rows = r.standard_normal((3, cfg.d_model)).astype(np.float32)
    x = rows[r.integers(0, 3, B * S)].reshape(B, S, cfg.d_model)
    p0 = jax.tree.map(lambda l: l[0], params["blocks"]["global_0"]["ffn"])
    yj = np.asarray(jax.jit(lambda p, x: jax_moe.moe_block(
        mj.cfg, p, x))(p0, jnp.asarray(x)))
    with torch.no_grad():
        yt = torch_moe.moe_block(cfg, mt.blocks[0]["global_0"].ffn,
                                 torch.from_numpy(x)).numpy()
    assert np.abs(yt - yj).max() < 1e-5


@pytest.mark.parametrize("T,E,k,cap_factor", [(96, 4, 2, 1.25),
                                              (4, 64, 6, 1.25),
                                              (300, 16, 3, 0.5),
                                              (64, 8, 2, 4.0)])
def test_combine_is_the_expert_order_scatter_add_bit_for_bit(T, E, k,
                                                             cap_factor):
    """bf16: ``combine`` gives the bits of one ``index_add_`` an expert in
    ascending expert order over all (E, C) entries, weight-0 fill
    included; with capacity dropping (factor 0.5), the decode step's
    C = 1, and C past the routed tokens (factor 4).  Calling it twice
    gives the same bits."""
    D = 40
    cfg = dataclasses.replace(
        reduced_config(get_config("deepseek_v2_lite_16b")),
        moe=dataclasses.replace(reduced_config(get_config(
            "deepseek_v2_lite_16b")).moe, n_experts=E, top_k=k,
            capacity_factor=cap_factor))
    g = torch.Generator().manual_seed(T + E)
    gates = torch.softmax(torch.randn(T, E, generator=g), -1)
    topv, topi = torch_moe.top_k(gates, k)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    sel = torch.zeros_like(gates).scatter(1, topi, topv)
    C = torch_moe.capacity(cfg, T)
    wv, idx = torch_moe.top_k(sel.T, C)
    valid = wv > 0
    yg = torch.randn(E, C, D, generator=g).bfloat16()
    yg = yg * (wv * valid)[..., None].bfloat16()
    want = torch.zeros(T, D, dtype=torch.bfloat16)
    for e in range(E):
        want.index_add_(0, idx[e], yg[e])
    got = torch_moe.combine(yg, idx, valid, T, k)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(torch_moe.combine(yg, idx, valid, T, k).view(
        torch.int16), got.view(torch.int16))


@pytest.mark.parametrize("arch,B,S,want", [
    ("deepseek_v2_lite_16b", 4, 1024, 480), ("deepseek_v2_lite_16b", 4, 1, 1),
    ("arctic_480b", 4, 1024, 80), ("arctic_480b", 2, 45, 2)])
def test_capacity_is_jax_expression(arch, B, S, want):
    cfg = get_config(arch)
    m = cfg.moe
    assert torch_moe.capacity(cfg, B * S) == want == max(1, int(np.ceil(
        B * S * m.top_k / m.n_experts * m.capacity_factor)))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_within_twice_jax_spread(pairs, arch):
    """bf16 prefill + 4 steps: the port's logits differ from JAX's bf16
    logits by at most twice what JAX's bf16 logits differ from its f32
    logits."""
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = {"tokens": _tokens(6, (2, 40), cfg.vocab)}
    fed = list(_tokens(7, (4, 2, 1), cfg.vocab))
    lj, _ = serve_jax(mj, params, batch, fed, BF16[0])
    lj32, _ = serve_jax(mj, params, batch, fed, F32[0])
    lt, _ = serve_port(mt, batch, fed, BF16[1])
    spread = max(np.abs(a - b).max() for a, b in zip(lj, lj32))
    assert spread > 0
    assert max(np.abs(a - b).max() for a, b in zip(lt, lj)) <= 2 * spread


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_f32(pairs, arch):
    cfg, mj, params, mt = _pair(pairs, arch)
    r = np.random.default_rng(8)
    batch = {"tokens": r.integers(0, cfg.vocab, (2, 48)),
             "labels": r.integers(0, cfg.vocab, (2, 48))}
    assert_grads_close(*loss_and_grads(cfg, mj, params, mt, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_and_grads_round_trip_through_jax_layout(pairs, arch):
    """``params_to_jax`` inverts ``params_from_jax`` on the MoE and MLA
    trees (router, experts, shared and dense MLPs, the MLA projections),
    params and an AdamW-shaped tree alike."""
    cfg, _, params, mt = _pair(pairs, arch)
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(cfg, params_from_jax(cfg, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    sd = {k: torch.full_like(v, 0.5) for k, v in mt.state_dict().items()}
    again = params_from_jax(cfg, params_to_jax(cfg, sd))
    assert again.keys() == sd.keys()
    ffn = mt.blocks[0]["global_0"].ffn
    assert {"router", "wi", "wo", "wg"} <= {n for n, _ in
                                           ffn.named_parameters()}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_smoke_on_cpu(arch, tmp_path, capsys):
    tr = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "3", "--seq", "32", "--batch", "2",
                            "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[done]" in out and tr.step == 3
    assert all(np.isfinite(h["loss"]) for h in tr.history)
