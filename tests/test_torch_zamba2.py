"""The port's attention serving path against the JAX package's, on the CPU:
zamba2 (Mamba2 + one weight-shared attention block), and the dense
"global" (deepseek_7b, GQA) and "local" (gemma3_12b, window 32) kinds;
the f32 forward also for olmo_1b (non-parametric LayerNorm) and
nemotron_4_15b (squared-ReLU MLP).

Each reduced configuration is built by JAX's ``DecoderLM.init``;
``params_from_jax`` carries its params (zamba2's unstacked ``shared.*``
among them) into the port, and the same token ids, drawn with numpy from a
seed, go through both models.

* ``forward`` in f32 (both packages' ``COMPUTE_DTYPE`` patched to f32 for
  the test): the same arithmetic, so the logits agree to 1e-4, for JAX's
  ``use_ssd_kernel`` False and True.  The port's attention follows the TPU
  flash kernel (scale after the f32 product), JAX's model its jnp path
  (scale folded into q): equal in f32 to rounding.
* zamba2 ``prefill`` + 4 ``decode_step``s in the default bf16: logits
  within twice what JAX's own bf16 run differs from its f32 run (bf16
  rounds at other places in the two frameworks, and the spread grows with
  depth: 0.18 for JAX alone here, where two Mamba2 layers gave 0.06); the
  same for SSM states, conv tails and KV caches; positions exactly.
* decode against the port's own forward in f32, the port's copy of
  ``tests/test_decode.py``: 1e-4, including gemma3's ring buffer written
  past its window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model as torch_model
from repro_torch.models.convert import params_from_jax

ARCHS = ["zamba2_2_7b", "deepseek_7b", "gemma3_12b"]


def _build(arch):
    cfg_j = jax_reduced_config(jax_get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    mj = jax_model.DecoderLM(cfg_j, remat=False)
    params, _ = mj.init(jax.random.PRNGKey(0))
    mt = torch_model.DecoderLM(cfg_t, device="cpu")
    mt.load_state_dict(params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params)), strict=True)
    return cfg_t, mj, params, mt


@pytest.fixture(scope="module")
def pairs():
    return {}


def _pair(pairs, arch):
    if arch not in pairs:
        pairs[arch] = _build(arch)
    return pairs[arch]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(jax_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("arch,use_ssd_kernel", [
    ("zamba2_2_7b", False), ("zamba2_2_7b", True), ("deepseek_7b", False),
    ("gemma3_12b", False), ("olmo_1b", False), ("nemotron_4_15b", False)])
def test_forward_matches_jax_in_f32(pairs, f32, monkeypatch, arch,
                                    use_ssd_kernel):
    cfg, mj, params, mt = _pair(pairs, arch)
    monkeypatch.setattr(mj, "use_ssd_kernel", use_ssd_kernel)
    toks = _tokens(0, (2, 64), cfg.vocab)
    lj = np.asarray(mj.forward(params, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        lt = mt.forward({"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    assert np.abs(lt.numpy() - lj).max() < 1e-4


def test_shared_block_is_one_module_applied_per_superblock(pairs):
    cfg, _, params, mt = _pair(pairs, "zamba2_2_7b")
    assert cfg.pattern == ("mamba",) * 6 + ("shared_attn",)
    assert all("shared_attn_6" not in sb for sb in mt.blocks)
    assert torch.equal(mt.shared.attn.wq, torch.from_numpy(
        np.array(params["shared"]["attn"]["wq"])))
    cache = mt.init_cache(2, 20)
    assert all(set(sb) == {f"mamba_{j}" for j in range(6)} | {
        "shared_attn_6"} for sb in cache["layers"])
    kv = cache["layers"][1]["shared_attn_6"]
    assert tuple(kv["k"].shape) == (2, 20, cfg.n_kv_heads, cfg.hd)
    assert kv["k"].dtype == torch.bfloat16
    assert kv["k_pos"].dtype == torch.int32 and bool((kv["k_pos"] == -1)
                                                     .all())


def _serve(model, prompt, fed):
    """Prefill + one decode step per row of ``fed``: (logits, cache)."""
    with torch.no_grad():
        c = model.init_cache(prompt.shape[0], prompt.shape[1] + len(fed))
        c, lg = model.prefill({"tokens": torch.from_numpy(prompt)}, c)
        out = [lg]
        for tok in fed:
            lg, c = model.decode_step(c, torch.from_numpy(tok))
            out.append(lg)
    return out, c


def _serve_jax(mj, params, prompt, fed):
    c, _ = mj.init_cache(prompt.shape[0], prompt.shape[1] + len(fed))
    c, lg = mj.prefill(params, {"tokens": jnp.asarray(prompt)}, c)
    out = [lg]
    decode = jax.jit(mj.decode_step)
    for tok in fed:
        lg, c = decode(params, c, jnp.asarray(tok))
        out.append(lg)
    return [np.asarray(o.astype(jnp.float32)) for o in out], c


@pytest.mark.parametrize("use_ssd_kernel,prompt_len", [(False, 45),
                                                       (True, 64)])
def test_zamba2_prefill_and_decode_match_jax_in_bf16(pairs, monkeypatch,
                                                     use_ssd_kernel,
                                                     prompt_len):
    """In bf16 the port may differ from JAX by at most twice what JAX's own
    bf16 run differs from its f32 run (0.1-0.2 on logits of scale 3 here:
    14 blocks of bf16 residual stream), over the prefill and every step.
    So are the SSM states, the conv tails and the KV caches; the caches'
    positions must be equal."""
    cfg, mj, params, mt = _pair(pairs, "zamba2_2_7b")
    monkeypatch.setattr(mj, "use_ssd_kernel", use_ssd_kernel)
    B, steps = 2, 4
    prompt = _tokens(1, (B, prompt_len), cfg.vocab)
    fed = list(_tokens(2, (steps, B, 1), cfg.vocab))

    logits_j, cj = _serve_jax(mj, params, prompt, fed)
    logits_t, ct = _serve(mt, prompt, fed)
    monkeypatch.setattr(jax_model, "COMPUTE_DTYPE", jnp.float32)
    logits_j32, cj32 = _serve_jax(mj, params, prompt, fed)

    assert ct["pos"] == int(cj["pos"]) == prompt_len + steps
    floor = max(np.abs(a - b).max() for a, b in zip(logits_j, logits_j32))
    err = 0.0
    for a, b in zip(logits_t, logits_j):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        err = max(err, np.abs(a.float().numpy() - b).max())
    assert err <= 2.0 * floor, (err, floor)
    for key, name in (("mamba_0", "state"), ("mamba_0", "conv"),
                      ("mamba_5", "state"), ("mamba_5", "conv"),
                      ("shared_attn_6", "k"), ("shared_attn_6", "v"),
                      ("shared_attn_6", "k_pos")):
        want, want32 = (np.asarray(c["layers"][key][name].astype(
            jnp.float32)) for c in (cj, cj32))
        got = np.stack([c[key][name].float().numpy()
                        for c in ct["layers"]])
        assert got.shape == want.shape
        err, floor = np.abs(got - want).max(), np.abs(want32 - want).max()
        assert err <= 2.0 * floor, (key, name, err, floor)


def _decode_vs_forward(mt, cfg, S=16, extra=4, T=32):
    """tests/test_decode.py:run_consistency on the port."""
    toks = torch.from_numpy(_tokens(2, (2, S + extra), cfg.vocab))
    with torch.no_grad():
        full = mt.forward({"tokens": toks}).float()
        cache = mt.init_cache(2, T)
        cache, lg = mt.prefill({"tokens": toks[:, :S]}, cache)
        errs = [float((lg[:, 0].float() - full[:, S - 1]).abs().max())]
        for t in range(S, S + extra):
            lg, cache = mt.decode_step(cache, toks[:, t:t + 1])
            errs.append(float((lg[:, 0].float() - full[:, t]).abs().max()))
    return max(errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_in_f32(pairs, f32, arch):
    cfg, _, _, mt = _pair(pairs, arch)
    assert _decode_vs_forward(mt, cfg) < 1e-4


def test_sliding_window_ring_buffer(pairs, f32):
    """tests/test_decode.py:test_sliding_window_ring_buffer on the port: a
    40-token prefill into gemma3's 32-slot local caches (the roll), then
    decode past the window; every step against the full forward."""
    cfg, _, _, mt = _pair(pairs, "gemma3_12b")
    total = 48
    toks = torch.from_numpy(_tokens(3, (1, total), cfg.vocab))
    with torch.no_grad():
        full = mt.forward({"tokens": toks}).float()
        cache = mt.init_cache(1, 64)
        cache, lg = mt.prefill({"tokens": toks[:, :40]}, cache)
        assert tuple(cache["layers"][0]["local_0"]["k"].shape)[1] == 32
        errs = [float((lg[:, 0].float() - full[:, 39]).abs().max())]
        for t in range(40, total):
            lg, cache = mt.decode_step(cache, toks[:, t:t + 1])
            errs.append(float((lg[:, 0].float() - full[:, t]).abs().max()))
    assert max(errs) < 1e-4, errs


def test_param_count_at_full_width_on_meta():
    cfg = get_config("zamba2_2_7b")
    m = torch_model.DecoderLM(cfg, device="meta")
    n = sum(p.numel() for p in m.parameters())
    jcfg = jax_get_config("zamba2_2_7b")
    shapes = jax.eval_shape(
        lambda k: jax_model.DecoderLM(jcfg).init(k)[0],
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # cfg.param_count() leaves out dt_bias and the RMSNorm scales: nh +
    # d_model a Mamba2 layer, two d_model for the shared block, one for the
    # final norm.
    nh = cfg.ssm.n_heads(cfg.d_model)
    assert cfg.param_count() == 2_422_236_608
    assert n == cfg.param_count() + cfg.n_layers * (nh + cfg.d_model) \
        + 3 * cfg.d_model


def test_serve_zamba2_smoke_on_cpu(capsys):
    out = serve.main(["--arch", "zamba2_2_7b", "--smoke", "--device", "cpu",
                      "--prompt-len", "40", "--tokens", "3"])
    cfg = reduced_config(get_config("zamba2_2_7b"))
    toks = out["tokens"]
    assert tuple(toks.shape) == (4, 4)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert all(torch.isfinite(l.float()).all() for l in out["step_logits"])
    kv = out["cache"]["layers"][0]["shared_attn_6"]
    assert sorted(kv["k_pos"].tolist()) == [-1] * (43 - 43) + list(range(43))
    assert "[prefill] 4x40" in capsys.readouterr().out
