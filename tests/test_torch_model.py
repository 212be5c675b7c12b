"""The port's mamba2_130m serving path against the JAX package's, on the CPU.

The reduced configuration (2 layers, d_model 64, chunk 32) is built by JAX's
``DecoderLM.init``; ``params_from_jax`` carries its params into the port, and
the same token ids, drawn with numpy from a seed, go through both models.

* ``forward`` in f32 (both packages' ``COMPUTE_DTYPE`` patched to f32 for the
  test; nothing in the JAX package changes): the same arithmetic, so the
  logits agree to 1e-4, for JAX's ``use_ssd_kernel`` False and True (JAX
  runs its jnp chunked path or its Pallas kernel in interpret mode).  The
  port has no such switch: on the CPU it runs its plain chunked version.
* ``prefill`` + 4 ``decode_step``s in the default bf16: bf16 rounds at other
  places in the two frameworks (XLA's CPU backend may keep f32 between fused
  elementwise ops), so logits agree to 0.1 -- the bound JAX's own
  ``test_ssd_kernel_inside_mamba_block`` sets between its two lowerings --
  the f32 SSM states to 0.05 and the bf16 conv tails to 0.05 (a few bf16
  ulps of values below 4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import model as jax_model
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model as torch_model
from repro_torch.models.convert import params_from_jax


@pytest.fixture(scope="module")
def pair():
    cfg_j = jax_reduced_config(jax_get_config("mamba2_130m"))
    cfg_t = reduced_config(get_config("mamba2_130m"))
    mj = jax_model.DecoderLM(cfg_j, remat=False)
    params, _ = mj.init(jax.random.PRNGKey(0))
    mt = torch_model.DecoderLM(cfg_t, device="cpu")
    mt.load_state_dict(params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params)), strict=True)
    return cfg_t, mj, params, mt


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("use_ssd_kernel", [False, True])
def test_forward_matches_jax_in_f32(pair, monkeypatch, use_ssd_kernel):
    cfg, mj, params, mt = pair
    monkeypatch.setattr(jax_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(mj, "use_ssd_kernel", use_ssd_kernel)
    toks = _tokens(0, (2, 64), cfg.vocab)
    lj = np.asarray(mj.forward(params, {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        lt = mt.forward({"tokens": torch.from_numpy(toks)})
    assert lt.dtype == torch.float32 and tuple(lt.shape) == lj.shape
    assert np.abs(lt.numpy() - lj).max() < 1e-4


# JAX's kernel path takes whole chunks only; its plain path pads, as the
# port does for a prompt longer than a chunk (45 = 32 + 13).
@pytest.mark.parametrize("use_ssd_kernel,prompt_len", [(False, 13),
                                                       (True, 13),
                                                       (True, 64),
                                                       (False, 45)])
def test_prefill_and_decode_match_jax_in_bf16(pair, monkeypatch,
                                              use_ssd_kernel, prompt_len):
    cfg, mj, params, mt = pair
    monkeypatch.setattr(mj, "use_ssd_kernel", use_ssd_kernel)
    B, steps = 2, 4
    prompt = _tokens(1, (B, prompt_len), cfg.vocab)
    fed = _tokens(2, (steps, B, 1), cfg.vocab)

    cj, _ = mj.init_cache(B, prompt_len + steps)
    cj, lj = mj.prefill(params, {"tokens": jnp.asarray(prompt)}, cj)
    logits_j = [lj]
    decode = jax.jit(mj.decode_step)
    for k in range(steps):
        lj, cj = decode(params, cj, jnp.asarray(fed[k]))
        logits_j.append(lj)

    with torch.no_grad():
        ct = mt.init_cache(B, prompt_len + steps)
        ct, lt = mt.prefill({"tokens": torch.from_numpy(prompt)}, ct)
        logits_t = [lt]
        for k in range(steps):
            lt, ct = mt.decode_step(ct, torch.from_numpy(fed[k]))
            logits_t.append(lt)

    assert ct["pos"] == int(cj["pos"]) == prompt_len + steps
    for a, b in zip(logits_t, logits_j):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape
        assert np.abs(a.float().numpy()
                      - np.asarray(b.astype(jnp.float32))).max() < 0.1
    for name, tol in (("state", 0.05), ("conv", 0.05)):
        want = np.asarray(cj["layers"]["mamba_0"][name].astype(jnp.float32))
        got = np.stack([c["mamba_0"][name].float().numpy()
                        for c in ct["layers"]])
        assert got.shape == want.shape
        assert np.abs(got - want).max() < tol, name


def test_param_count_at_full_width_on_meta():
    cfg = get_config("mamba2_130m")
    m = torch_model.DecoderLM(cfg, device="meta")
    n = sum(p.numel() for p in m.parameters())
    assert all(p.is_meta for p in m.parameters())
    # JAX's own init at the full config, shapes only (nothing allocated).
    jcfg = jax_get_config("mamba2_130m")
    shapes = jax.eval_shape(
        lambda k: jax_model.DecoderLM(jcfg).init(k)[0],
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # cfg.param_count() (about 167.5 M) leaves out dt_bias and the RMSNorm
    # scales: nh + d_model a layer, and the final norm's d_model.
    nh = cfg.ssm.n_heads(cfg.d_model)
    assert n == cfg.param_count() + cfg.n_layers * (nh + cfg.d_model) \
        + cfg.d_model
    assert cfg.param_count() == 167_535_744


def test_weights_follow_the_seed():
    cfg = reduced_config(get_config("mamba2_130m"))
    a, b, c = (torch_model.DecoderLM(cfg, device="cpu", seed=s).state_dict()
               for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_builds_on_meta_with_jax_param_shapes(arch):
    """Every architecture builds at full width on the meta device (no
    weights drawn), with exactly the parameters of JAX's ``DecoderLM.init``
    (abstract, by ``jax.eval_shape``): the same names, a superblock's
    leaf ``blocks.<i>.<name>`` for each stacked ``blocks/<name>``, and
    shapes.  Its count is ``cfg.param_count()`` plus the norms' scales
    (and the Mamba2 terms and the vision stub's embed table, which that
    count leaves out)."""
    cfg = get_config(arch)
    mt = torch_model.DecoderLM(cfg, device="meta")
    mj = jax_model.DecoderLM(jax_get_config(arch), remat=False)
    shapes = jax.eval_shape(lambda k: mj.init(k)[0], jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("blocks."):
            assert leaf.shape[0] == cfg.n_superblocks
            for i in range(cfg.n_superblocks):
                want[name.replace("blocks.", f"blocks.{i}.", 1)] = \
                    tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    got = {k: tuple(v.shape) for k, v in mt.named_parameters()}
    assert got == want
    n = sum(p.numel() for p in mt.parameters())
    n_norms = (2 * cfg.n_layers + 1) * cfg.d_model
    if cfg.mla is not None or cfg.moe is not None or cfg.frontend \
            == "audio_frames":
        assert n == cfg.param_count() + n_norms
    if arch == "arctic_480b":
        assert 476.8e9 < n < 476.9e9


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_jax(arch):
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(reduced_config(cfg)) == dataclasses.asdict(
        jax_reduced_config(jcfg))


def test_serve_smoke_on_cpu(capsys):
    out = serve.main(["--arch", "mamba2_130m", "--smoke", "--device", "cpu",
                      "--prompt-len", "64", "--tokens", "3"])
    cfg = reduced_config(get_config("mamba2_130m"))
    toks = out["tokens"]
    assert tuple(toks.shape) == (4, 4)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert len(out["step_logits"]) == 3
    assert all(torch.isfinite(l.float()).all() for l in out["step_logits"])
    text = capsys.readouterr().out
    assert "[prefill] 4x64" in text and "tok/s" in text
