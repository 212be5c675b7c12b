"""The port's stub frontends against the JAX package's, on the CPU:
``musicgen_medium`` (``audio_frames``: precomputed frame embeddings, no
embed table, decode through ``head.T``) and ``internvl2_26b``
(``vision_patches``: patch embeddings before the tokens, the loss over the
text span), reduced; and the serving launcher for the three new
architectures.

Each reduced configuration is built by JAX's ``DecoderLM.init`` (jitted)
and carried into the port by ``params_from_jax``; frame and patch
embeddings and token ids are drawn with numpy from a seed.

* f32: ``forward``, ``prefill`` and 4 ``decode_step``s agree with JAX to
  1e-4, caches to 1e-4 of their largest entry; loss and gradients to
  1e-5 / 1e-4 (internvl2's loss drops its 8 patch positions).
* bf16: within twice what JAX's own bf16 run differs from its f32 run.
* The audio rule: decode consumed ``frame_emb`` then ``head.T`` of each
  emitted token, so a forward over ``frame_emb ++ head.T[generated]``
  gives decode's logits (f32, 1e-4).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models import model as torch_model
from repro_torch.models.convert import params_from_jax, params_to_jax

from _torch_model_parity import (BF16, F32, assert_caches_close,
                                 assert_grads_close, build_pair, forward_jax,
                                 forward_port, loss_and_grads, serve_jax,
                                 serve_port)

ARCHS = ["musicgen_medium", "internvl2_26b"]


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


def request(cfg, seed, B, S, labels=False):
    """A batch of JAX's ``input_specs`` keys for a prompt of S positions
    (vision: V patches then S - V tokens), drawn with numpy."""
    r = np.random.default_rng(seed)
    emb = lambda rows: r.standard_normal((B, rows, cfg.d_model)).astype(
        np.float32)
    if cfg.frontend == "audio_frames":
        out = {"frame_emb": emb(S)}
        n_text = S
    else:
        V = cfg.vision_tokens
        out = {"patch_emb": emb(V),
               "tokens": r.integers(0, cfg.vocab, (B, S - V))}
        n_text = S - V
    if labels:
        out["labels"] = r.integers(0, cfg.vocab, (B, n_text))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax_in_f32(pairs, arch):
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = request(cfg, 0, 2, 64)
    lj = forward_jax(mj, params, batch, F32[0])
    lt = forward_port(mt, batch, F32[1])
    assert lt.shape == lj.shape == (2, 64, cfg.vocab)
    assert np.abs(lt - lj).max() < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_in_f32(pairs, arch):
    """Prefill 45 positions (internvl2: 8 patches + 37 tokens), then 4
    steps; musicgen's steps embed each token through ``head.T``."""
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = request(cfg, 1, 2, 45)
    fed = list(np.random.default_rng(2).integers(0, cfg.vocab, (4, 2, 1)))
    lj, cj = serve_jax(mj, params, batch, fed, F32[0])
    lt, ct = serve_port(mt, batch, fed, F32[1])
    assert ct["pos"] == 49
    for a, b in zip(lt, lj):
        assert a.shape == b.shape and np.abs(a - b).max() < 1e-4
    assert_caches_close(ct, cj, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_within_twice_jax_spread(pairs, arch):
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = request(cfg, 3, 2, 40)
    fed = list(np.random.default_rng(4).integers(0, cfg.vocab, (4, 2, 1)))
    lj, _ = serve_jax(mj, params, batch, fed, BF16[0])
    lj32, _ = serve_jax(mj, params, batch, fed, F32[0])
    lt, _ = serve_port(mt, batch, fed, BF16[1])
    spread = max(np.abs(a - b).max() for a, b in zip(lj, lj32))
    assert spread > 0
    assert max(np.abs(a - b).max() for a, b in zip(lt, lj)) <= 2 * spread


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax_in_f32(pairs, arch):
    cfg, mj, params, mt = _pair(pairs, arch)
    batch = request(cfg, 5, 2, 56, labels=True)
    assert_grads_close(*loss_and_grads(cfg, mj, params, mt, batch))


def test_audio_decode_equals_forward_over_frames_and_head_rows():
    """The audio stub's decode consumed ``frame_emb`` and then ``head.T``
    of each emitted token: a forward over both gives its logits."""
    cfg = reduced_config(get_config("musicgen_medium"))
    mt = torch_model.DecoderLM(cfg, device="cpu", seed=2)
    frames = request(cfg, 6, 2, 30)["frame_emb"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)
        run = serve.generate(mt, {"frame_emb": torch.from_numpy(frames)}, 6)
        gen = run["tokens"][:, :6]
        seq = torch.cat([torch.from_numpy(frames),
                         mt.head.detach().T[gen]], dim=1)
        with torch.no_grad():
            fwd = mt.forward({"frame_emb": seq})[:, 29:]
    got = torch.stack([run["prefill_logits"]] + run["step_logits"], dim=1)
    assert (got - fwd).abs().max() < 1e-4


def test_audio_params_have_no_embed_and_round_trip(pairs):
    cfg, _, params, mt = _pair(pairs, "musicgen_medium")
    assert "embed" not in params and not hasattr(mt, "embed")
    tree = jax.tree.map(np.asarray, params)
    back = params_to_jax(cfg, params_from_jax(cfg, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch,keys", [
    ("deepseek_v2_lite_16b", {"tokens"}), ("musicgen_medium", {"frame_emb"}),
    ("internvl2_26b", {"patch_emb", "tokens"})])
def test_prompt_batch_has_the_input_spec_keys(arch, keys):
    cfg = get_config(arch)
    b = serve.prompt_batch(cfg, 2, 5, "cpu")
    assert set(b) == keys
    for k, v in b.items():
        rows = cfg.vision_tokens if k == "patch_emb" else 5
        if k == "tokens":
            assert v.dtype == torch.int64 and tuple(v.shape) == (2, 5)
            assert int(v.min()) >= 1 and int(v.max()) < cfg.vocab
        else:
            assert v.dtype == torch.bfloat16
            assert tuple(v.shape) == (2, rows, cfg.d_model)
    assert serve.prefill_len(b) == 5 + (cfg.vision_tokens
                                        if "patch_emb" in b else 0)


@pytest.mark.parametrize("arch,layers", [("deepseek_v2_lite_16b", None),
                                         ("musicgen_medium", None),
                                         ("internvl2_26b", 1)])
def test_serve_smoke_on_cpu(arch, layers, capsys):
    """``--smoke`` on the CPU; ``--layers`` cuts the depth."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--prompt-len", "40", "--tokens", "3"]
                     + (["--layers", str(layers)] if layers else []))
    cfg = reduced_config(get_config(arch))
    toks = out["tokens"]
    assert tuple(toks.shape) == (4, 4)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab
    assert out["cache"]["pos"] == 40 + 3 + cfg.vision_tokens
    assert len(out["cache"]["layers"]) == (layers or cfg.n_superblocks)
    printed = capsys.readouterr().out
    assert "[prefill]" in printed and ("[depth]" in printed) == bool(layers)
