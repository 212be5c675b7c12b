"""The port's training substrate against the JAX package's, on the CPU:
optimizers, gradient compression, the data pipeline, checkpoints through
the control plane, carrying state across layouts, the trainer end to end
and the launcher.

* AdamW and Adafactor: one and three updates on equal params, grads and
  state, to 1e-6 relative (AdamW with clipping, JAX's launcher schedule
  and weight decay; Adafactor factored and not, with decay).
* ``topk_compress`` exactly (it compares values, so the tie order of the
  two top-k functions does not matter); ``int8_compress`` exactly with
  JAX's noise injected, and by distribution with the port's own draws.
* The data pipeline draws Philox, not threefry: the port's own
  properties (determinism by (seed, cursor), host slices, the periodic
  share within 3 sigma, labels the tokens shifted, frontend shapes).
* Checkpoints: JAX's three tests on the port's ``ControlPlane``.
* The trainer: JAX's four end-to-end tests on the port, at their sizes and
  margins.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import model as jax_model
from repro.training import compress as jax_compress
from repro.training import optimizer as jax_opt
from repro_torch.cluster.coordinator import ControlPlane
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quorum import QuorumSpec
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.models.model import DecoderLM, cross_entropy
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compress
from repro_torch.training.data import DataConfig, SyntheticPipeline
from repro_torch.training.optimizer import (adafactor, adamw, apply_updates,
                                            clip_by_global_norm,
                                            cosine_schedule, global_norm)
from repro_torch.training.trainer import (Trainer, TrainerConfig,
                                          make_prefill, make_serve_step,
                                          make_train_step)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny, and the suite runs several workers on the
    host's cores: one intra-op thread a worker keeps torch's thread pool
    from spinning against the other workers (many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, shapes, scale=1.0):
    r = np.random.default_rng(seed)
    return {k: (r.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=rtol * float(
                                       np.abs(np.asarray(want[k])).max()),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Optimizers.
# ---------------------------------------------------------------------------

SHAPES = {"w": (8, 16), "b": (5,), "t": (3, 4, 6), "s": (1,)}
OPTIMIZERS = {
    "adamw": (lambda: jax_opt.adamw(
        lr=1e-2, weight_decay=0.1, max_grad_norm=1.0,
        schedule=jax_opt.cosine_schedule(warmup=2, total=10)),
        lambda: adamw(lr=1e-2, weight_decay=0.1, max_grad_norm=1.0,
                      schedule=cosine_schedule(warmup=2, total=10))),
    "adamw_unclipped": (lambda: jax_opt.adamw(lr=3e-3, max_grad_norm=None),
                        lambda: adamw(lr=3e-3, max_grad_norm=None)),
    "adafactor": (lambda: jax_opt.adafactor(lr=1e-2, weight_decay=0.05),
                  lambda: adafactor(lr=1e-2, weight_decay=0.05)),
}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_jax(name, steps):
    """Equal params, grads and state: the port's in-place update equals
    JAX's ``update`` + ``apply_updates`` to 1e-6, params, state and the
    updates' norm, step after step (the grads of a step scaled to cross
    the clipping threshold both ways)."""
    make_j, make_t = OPTIMIZERS[name]
    oj, ot = make_j(), make_t()
    pj = {k: jnp.asarray(v) for k, v in _tree(0, SHAPES).items()}
    pt = _torch(_tree(0, SHAPES))
    sj, st = oj.init(pj), ot.init(pt)
    for i in range(steps):
        g = _tree(10 + i, SHAPES, scale=0.3 if i % 2 else 0.02)
        uj, sj = oj.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = jax_opt.apply_updates(pj, uj)
        norm = ot.update(_torch(g), st, pt)
        assert float(norm) == pytest.approx(float(jax_opt.global_norm(uj)),
                                            rel=1e-6)
        _close(pt, pj, 1e-6)
        assert int(st["step"]) == int(sj.step) == i + 1
        moments = ("mu", "nu") if "adamw" in name else ("vr", "vc")
        for m in moments:
            _close(st[m], getattr(sj, m), 1e-6)


def test_adafactor_factored_state_shapes():
    params = {"m": torch.zeros(8, 16), "v": torch.zeros(5)}
    opt = adafactor()
    state = opt.init(params)
    assert state["vr"]["m"].shape == (8,) and state["vc"]["m"].shape == (16,)
    assert state["vr"]["v"].shape == (5,) and state["vc"]["v"].shape == (1,)
    opt.update({k: torch.ones_like(p) for k, p in params.items()}, state,
               params)
    assert all(bool(torch.isfinite(p).all()) for p in params.values())


def test_norms_clip_schedule_and_apply_match_jax():
    g = _tree(3, SHAPES)
    gj = {k: jnp.asarray(v) for k, v in g.items()}
    assert float(global_norm(_torch(g))) == pytest.approx(
        float(jax_opt.global_norm(gj)), rel=1e-6)
    for max_norm in (0.5, 100.0):
        ct, nt = clip_by_global_norm(_torch(g), max_norm)
        cj, nj = jax_opt.clip_by_global_norm(gj, max_norm)
        assert float(nt) == pytest.approx(float(nj), rel=1e-6)
        _close(ct, cj, 1e-6)
    fn_t = cosine_schedule(warmup=10, total=100)
    fn_j = jax_opt.cosine_schedule(warmup=10, total=100)
    for s in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        assert float(fn_t(torch.tensor(s, dtype=torch.int32))) == \
            pytest.approx(float(fn_j(jnp.int32(s))), rel=1e-6, abs=1e-7)
    p, u = _tree(4, SHAPES), _tree(5, SHAPES)
    pt = _torch(p)
    apply_updates(pt, _torch(u))
    _close(pt, jax_opt.apply_updates(p, u), 1e-7)


def test_adamw_matches_reference_math():
    """JAX's own reference tests of the optimizers, on the port."""
    params = {"w": torch.tensor([1.0, -2.0])}
    opt = adamw(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                max_grad_norm=None)
    opt.update({"w": torch.tensor([0.1, 0.2])}, opt.init(params), params)
    np.testing.assert_allclose(params["w"].numpy(), [0.9, -2.1], rtol=1e-4)
    params = {"w": torch.tensor([1.0])}
    opt = adamw(lr=0.1, weight_decay=0.5, max_grad_norm=None)
    opt.update({"w": torch.tensor([0.0])}, opt.init(params), params)
    np.testing.assert_allclose(params["w"].numpy(), [0.95], rtol=1e-5)


# ---------------------------------------------------------------------------
# Gradient compression.
# ---------------------------------------------------------------------------

def test_topk_compress_matches_jax_exactly():
    g = _tree(6, SHAPES)
    r = _tree(7, SHAPES, scale=0.1)
    for frac in (0.05, 0.3):
        cj, rj = jax_compress.topk_compress(g, r, frac=frac)
        ct, rt = compress.topk_compress(_torch(g), _torch(r), frac=frac)
        for k in g:
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
            np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]))


def test_topk_keeps_largest():
    g = {"w": torch.arange(100.0)}
    out, res = compress.topk_compress(g, compress.init_residual(g), frac=0.1)
    kept = out["w"].numpy()
    assert (kept[-10:] > 0).all() and (kept[:-10] == 0).all()
    np.testing.assert_allclose(res["w"].numpy()[:-10], np.arange(90.0))


def test_int8_compress_matches_jax_with_its_noise():
    """JAX's per-leaf keys and uniform draws, injected: the roundtrip and
    the residual are then the same arithmetic, exactly."""
    g = _tree(8, SHAPES)
    r = _tree(9, SHAPES, scale=0.05)
    key = jax.random.PRNGKey(3)
    cj, rj = jax_compress.int8_compress(g, r, key)
    names = sorted(g)                  # JAX's leaf order, a key a leaf
    keys = dict(zip(names, jax.random.split(key, len(names))))
    noise = {k: torch.from_numpy(np.array(jax.random.uniform(
        keys[k], g[k].shape, jnp.float32, -0.5, 0.5))) for k in g}
    ct, rt = compress.int8_compress(_torch(g), _torch(r), noise=noise)
    for k in g:
        np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]))


def test_int8_compress_with_its_own_draws_is_unbiased_and_bounded():
    """The port's Philox/MT draws: every entry within one quantisation step
    (scale) of its input, the residual exactly what was lost, and the mean
    roundtrip unbiased within 3 sigma over 200 draws."""
    g = {"w": torch.from_numpy(_tree(10, {"w": (64, 64)})["w"])}
    scale = float(g["w"].abs().max()) / 127.0
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(64, 64, dtype=torch.float64)
    n = 200
    for _ in range(n):
        out, res = compress.int8_compress(g, compress.init_residual(g), gen)
        assert float((out["w"] - g["w"]).abs().max()) <= scale * 1.0001
        assert torch.equal(res["w"], g["w"] - out["w"])
        acc += out["w"].double()
    bias = (acc / n - g["w"].double()).mean()
    sigma = 0.5 * scale / np.sqrt(n * g["w"].numel())   # rounding sd <= s/2
    assert abs(float(bias)) < 3 * sigma


def test_error_feedback_recovers_signal():
    """A tiny constant gradient below one quantisation step passes through
    on average, thanks to error feedback (JAX's test, on the port)."""
    grads = {"w": torch.full((64,), 1e-3)}
    grads["w"][0] = 1.0 + 1e-3
    r = compress.init_residual(grads)
    gen = torch.Generator().manual_seed(0)
    total = torch.zeros(64)
    for _ in range(50):
        out, r = compress.int8_compress(grads, r, gen)
        total += out["w"]
    assert float(total[1:].mean()) / 50 == pytest.approx(1e-3, rel=0.2)


def test_compressed_bytes_matches_jax():
    g = {"w": np.zeros(1000, np.float32), "b": np.zeros(24, np.float32)}
    for scheme in (None, "int8", "topk"):
        assert compress.compressed_bytes(_torch(g), scheme) == \
            jax_compress.compressed_bytes(g, scheme)
    with pytest.raises(ValueError):
        compress.compressed_bytes(_torch(g), "fp8")


# ---------------------------------------------------------------------------
# Data pipeline.
# ---------------------------------------------------------------------------

def test_data_deterministic_and_distinct():
    pipe = SyntheticPipeline(DataConfig(vocab=128, seq_len=32,
                                        global_batch=8))
    b1, b2, b3 = pipe.batch_at(5), pipe.batch_at(5), pipe.batch_at(6)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].shape == b1["labels"].shape == (8, 32)
    assert b1["tokens"].dtype == torch.int64
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    other = SyntheticPipeline(DataConfig(vocab=128, seq_len=32,
                                         global_batch=8, seed=1))
    assert not torch.equal(other.batch_at(5)["tokens"], b1["tokens"])


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_data_host_slices_partition_the_global_batch(n_hosts):
    pipe = SyntheticPipeline(DataConfig(vocab=128, seq_len=16,
                                        global_batch=9))
    full = pipe.batch_at(3)["tokens"]
    for h in range(n_hosts):
        assert torch.equal(pipe.batch_at(3, host=h, n_hosts=n_hosts)
                           ["tokens"], full[h::n_hosts])


def test_data_periodic_share_and_range():
    """70% of positions carry the periodic token (position + phase) mod 97
    (the rest are uniform, which hit it with probability 1/vocab): the
    share of positions equal to the periodic token, given each row's phase,
    within 3 sigma binomial of 0.7 + 0.3 / vocab."""
    c = DataConfig(vocab=512, seq_len=255, global_batch=16, seed=5)
    pipe = SyntheticPipeline(c)
    hits = total = 0
    for cursor in range(4):
        b = pipe.batch_at(cursor)
        toks = torch.cat([b["tokens"], b["labels"][:, -1:]], dim=1).numpy()
        assert toks.min() >= 0 and toks.max() < c.vocab
        pos = np.arange(c.seq_len + 1)
        for row in toks:
            best = max(((pos + ph) % c.structure % c.vocab == row).sum()
                       for ph in range(c.structure))
            hits += best
            total += row.size
    p = 0.7 + 0.3 / c.vocab
    sigma = np.sqrt(p * (1 - p) / total)
    assert abs(hits / total - p) < 3 * sigma


def test_frontend_batches():
    pipe = SyntheticPipeline(DataConfig(vocab=128, seq_len=32,
                                        global_batch=4))
    a = pipe.frontend_batch_at(0, d_model=64, frontend="audio_frames")
    assert a["frame_emb"].shape == (4, 32, 64)
    assert a["frame_emb"].dtype == torch.bfloat16
    assert a["labels"].shape == (4, 32)
    v = pipe.frontend_batch_at(0, d_model=64, frontend="vision_patches",
                               vision_tokens=8)
    assert v["patch_emb"].shape == (4, 8, 64)
    assert v["tokens"].shape == v["labels"].shape == (4, 24)
    with pytest.raises(ValueError):
        pipe.frontend_batch_at(0, d_model=64, frontend="video")


# ---------------------------------------------------------------------------
# Checkpoints through the port's control plane.
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_with_consensus_manifest(tmp_path):
    plane = ControlPlane(QuorumSpec.paper_headline(11))
    state = {"params": {"w": torch.arange(8.0), "b": torch.randn(3, 5)},
             "opt": {"step": torch.tensor(7, dtype=torch.int32),
                     "mu": {"w": torch.randn(8)}}}
    d = ckpt.save(str(tmp_path), 7, state, data_cursor=42, plane=plane)
    assert os.path.exists(os.path.join(d, "params.b.npy"))
    assert not os.path.exists(os.path.join(d, "MANIFEST"))
    manifest = ckpt.latest_manifest(str(tmp_path), plane)
    assert manifest["step"] == 7 and manifest["shards"]["n_shards"] == 4
    template = {"params": {"w": torch.zeros(8), "b": torch.zeros(3, 5)},
                "opt": {"step": torch.tensor(0, dtype=torch.int32),
                        "mu": {"w": torch.zeros(8)}}}
    restored, step, cursor = ckpt.restore(template, manifest)
    assert restored is template and step == 7 and cursor == 42
    for (a, b) in ((template["params"]["w"], state["params"]["w"]),
                   (template["params"]["b"], state["params"]["b"]),
                   (template["opt"]["mu"]["w"], state["opt"]["mu"]["w"]),
                   (template["opt"]["step"], state["opt"]["step"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_meta_leaves_are_checked_not_loaded(tmp_path):
    """A serving model restores its params past an optimizer template on
    the meta device: those shards count in the digest and the shapes, and
    nothing of them is loaded; a corrupt one still raises."""
    params = {"w": torch.randn(6, 4)}
    opt = adamw()
    state = {"params": params, "opt": opt.init(params)}
    opt.update({"w": torch.randn(6, 4)}, state["opt"], params)
    d = ckpt.save(str(tmp_path), 1, state, data_cursor=1)
    fresh = {"w": torch.zeros(6, 4)}
    meta_opt = opt.init({"w": torch.empty(6, 4, device="meta")})
    ckpt.restore({"params": fresh, "opt": meta_opt},
                 ckpt.latest_manifest(str(tmp_path)))
    assert torch.equal(fresh["w"], params["w"])
    assert meta_opt["mu"]["w"].device.type == "meta"
    np.save(os.path.join(d, "opt.nu.w.npy"), np.ones((6, 4), np.float32))
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore({"params": {"w": torch.zeros(6, 4)}, "opt": meta_opt},
                     ckpt.latest_manifest(str(tmp_path)))


def test_checkpoint_detects_corruption_before_loading(tmp_path):
    state = {"w": torch.arange(16.0), "v": torch.ones(4)}
    d = ckpt.save(str(tmp_path), 1, state, data_cursor=0)
    np.save(os.path.join(d, "w.npy"), np.zeros(16, np.float32))
    manifest = ckpt.latest_manifest(str(tmp_path))
    template = {"w": torch.full((16,), 5.0), "v": torch.zeros(4)}
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore(template, manifest)
    assert bool((template["w"] == 5.0).all()) and \
        bool((template["v"] == 0).all())
    with pytest.raises(ValueError, match="shards"):
        ckpt.restore({"w": torch.zeros(16)}, manifest)


def test_torn_checkpoint_invisible_without_manifest(tmp_path):
    os.makedirs(tmp_path / "step-00000009")
    np.save(tmp_path / "step-00000009" / "w.npy", np.zeros(4))
    assert ckpt.latest_manifest(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 3, {"w": torch.ones(4)}, data_cursor=3)
    assert ckpt.latest_manifest(str(tmp_path))["step"] == 3


def test_checkpoint_digest_is_jax_format(tmp_path):
    """The same leaves saved by both packages under the same names give the
    same stand-alone MANIFEST line."""
    from repro.training import checkpoint as jax_ckpt
    tree = {"params": {"w": np.arange(2000, dtype=np.float32)},
            "opt": {"mu": np.ones(3, np.float32)}}
    dj = jax_ckpt.save(str(tmp_path / "j"), 4, tree, data_cursor=9)
    dt = ckpt.save(str(tmp_path / "t"), 4, {
        "params": _torch(tree["params"]), "opt": _torch(tree["opt"])},
        data_cursor=9)
    with open(os.path.join(dj, "MANIFEST")) as f, \
            open(os.path.join(dt, "MANIFEST")) as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------------------
# Carrying trees across layouts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2_2_7b", "gemma3_12b"])
def test_param_shaped_trees_cross_both_ways(arch):
    """JAX's params cross to the port's names and shapes and back, exactly;
    so do JAX's AdamW moments (param-shaped), and the Adafactor factors of
    every leaf but the stacked ones of one axis a superblock (see
    ``convert``): each lands on the port's Adafactor state's shape."""
    cfg_j = jax_reduced_config(jax_get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    params, _ = jax_model.DecoderLM(cfg_j).init(jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    sd = params_from_jax(cfg_t, params)
    model = DecoderLM(cfg_t, device="cpu")
    named = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(p.shape) for k, p in named.items()}
    flat = _flat(params)
    flat_back = _flat(params_to_jax(cfg_t, sd))
    assert flat.keys() == flat_back.keys()
    assert all(np.array_equal(flat[k], flat_back[k]) for k in flat)

    jparams = jax.tree.map(jnp.asarray, params)
    mu = params_from_jax(cfg_t, jax.tree.map(
        np.asarray, jax_opt.adamw().init(jparams).mu))
    assert {k: v.shape for k, v in mu.items()} == {
        k: v.shape for k, v in sd.items()}
    state = jax_opt.adafactor().init(jparams)
    port = adafactor().init(named)
    crossing = {k for k, a in flat.items()
                if not k.startswith("blocks.") or a.ndim >= 3}
    for name in ("vr", "vc"):
        leaves = _flat(jax.tree.map(np.asarray, getattr(state, name)))
        got = params_from_jax(cfg_t, _nest(
            {k: v for k, v in leaves.items() if k in crossing}))
        assert {k for k in got if k.startswith("blocks.")} == {
            k for k, p in named.items()
            if k.startswith("blocks.") and p.ndim >= 2}
        for k, v in got.items():
            assert tuple(v.shape) == tuple(port[name][k].shape), (name, k)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# End to end (JAX's tests/test_training.py, on the port).
# ---------------------------------------------------------------------------

def _mk_trainer(tmp, plane=None, opt=None, **kw):
    cfg = reduced_config(get_config("olmo_1b"))
    model = DecoderLM(cfg, device="cpu", seed=0, use_kernels=False)
    pipe = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=8))
    t = Trainer(model, opt or adamw(lr=3e-3), pipe,
                TrainerConfig(ckpt_dir=str(tmp), **kw), plane=plane)
    t.init()
    return t


def test_loss_decreases(tmp_path):
    t = _mk_trainer(tmp_path, ckpt_every=0)
    first = t.run(1)["loss"]
    last = t.run(25)["loss"]
    assert last < first - 0.5
    assert all(m["step_s"] > 0 for m in t.history)


def test_preemption_resume_bit_exact(tmp_path):
    plane = ControlPlane(QuorumSpec.paper_headline(11))
    t1 = _mk_trainer(tmp_path, plane=plane, ckpt_every=5)
    t1.run(10)
    at10 = {k: v.detach().clone() for k, v in t1.params.items()}
    mu10 = {k: v.clone() for k, v in t1.opt_state["mu"].items()}
    t1.run(3)      # lost to preemption
    after = {k: v.detach().clone() for k, v in t1.params.items()}
    t2 = _mk_trainer(tmp_path, plane=plane, ckpt_every=5)
    assert t2.try_restore()
    assert t2.step == 10 and t2.cursor == 10
    assert int(t2.opt_state["step"]) == 10
    assert all(torch.equal(t2.params[k], at10[k]) for k in at10)
    assert all(torch.equal(t2.opt_state["mu"][k], mu10[k]) for k in mu10)
    t2.run(3)      # the same three steps again, the same bits
    assert all(torch.equal(t2.params[k], after[k]) for k in after)


def test_microbatched_step_matches_full_batch():
    cfg = reduced_config(get_config("olmo_1b"))
    pipe = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=8))
    batch = pipe.batch_at(0)
    out = {}
    for nm in (1, 2):
        model = DecoderLM(cfg, device="cpu", seed=0, use_kernels=False)
        opt = adamw(lr=1e-3)
        params = dict(model.named_parameters())
        b = batch if nm == 1 else {
            k: v.reshape((2, 4) + v.shape[1:]) for k, v in batch.items()}
        _, m = make_train_step(model, opt, n_microbatches=nm)(
            opt.init(params), None, b)
        out[nm] = (float(m["loss"]), params)
    assert out[1][0] == pytest.approx(out[2][0], rel=1e-2)
    d = max(float((out[1][1][k] - out[2][1][k]).abs().max())
            for k in out[1][1])
    assert d < 2e-2


@pytest.mark.parametrize("compression,margin",
                         [("int8", 0.4), ("topk", 0.4)])
def test_compressed_training_still_converges(tmp_path, compression, margin):
    t = _mk_trainer(tmp_path, ckpt_every=0, compression=compression)
    first = t.run(1)["loss"]
    last = t.run(25)["loss"]
    assert last < first - margin


def test_adafactor_training_converges(tmp_path):
    t = _mk_trainer(tmp_path, ckpt_every=0, opt=adafactor())
    first = t.run(1)["loss"]
    assert t.run(25)["loss"] < first - 0.5


def test_int8_training_is_deterministic(tmp_path):
    """A step's rounding noise is keyed by (seed, step): two runs with int8
    compression give the same bits, another seed other bits."""
    runs = []
    for seed in (0, 0, 1):
        t = _mk_trainer(tmp_path, ckpt_every=0, compression="int8")
        t.seed = seed
        t.run(3)
        runs.append(t.params)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert not all(torch.equal(runs[0][k], runs[2][k]) for k in runs[0])


def test_cross_entropy_and_serve_steps():
    """``cross_entropy`` is the mean (or masked mean) NLL; the trainer's
    serve and prefill steps run under inference mode and agree with the
    model's forward."""
    logits = torch.randn(2, 5, 11)
    labels = torch.randint(0, 11, (2, 5))
    want = torch.nn.functional.cross_entropy(logits.reshape(-1, 11),
                                             labels.reshape(-1))
    assert float(cross_entropy(logits, labels)) == pytest.approx(
        float(want), rel=1e-6)
    mask = torch.tensor([[1, 1, 0, 0, 0], [1, 0, 0, 0, 0]],
                        dtype=torch.float32)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, 11), labels.reshape(-1), reduction="none")
    assert float(cross_entropy(logits, labels, mask)) == pytest.approx(
        float((nll * mask.reshape(-1)).sum() / 3), rel=1e-6)
    cfg = reduced_config(get_config("zamba2_2_7b"))
    model = DecoderLM(cfg, device="cpu", seed=2)
    toks = torch.randint(0, cfg.vocab, (2, 12))
    cache, lg = make_prefill(model)(model.init_cache(2, 14),
                                    {"tokens": toks})
    assert lg.is_inference()
    nxt = lg[:, -1].argmax(-1)[:, None]
    lg2, cache = make_serve_step(model)(cache, nxt)
    assert cache["pos"] == 13 and lg2.shape == (2, 1, cfg.vocab)
    with torch.no_grad():
        full = model({"tokens": torch.cat([toks, nxt], dim=1)})
    assert float((lg2[:, 0].float() - full[:, -1].float()).abs().max()) \
        < 0.1


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

def test_launcher_smoke_trains_and_commits(tmp_path, capsys):
    tr = launch_train.main(["--arch", "olmo_1b", "--smoke", "--device",
                            "cpu", "--steps", "10", "--seq", "32",
                            "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[smoke] olmo_1b reduced" in out and "[done]" in out
    assert tr.step == 10 and tr.plane.latest_checkpoint()["step"] == 10
    assert not tr.model.use_kernels and tr.model.remat
    assert tr.history[-1]["loss"] < tr.history[0]["loss"]


def test_launcher_dry_run_is_not_ported():
    """(The name predates the port of the dry-run.)  ``--dry-run`` no
    longer raises: it returns and prints the full configuration's dry-run
    record of train_4k on the 16 x 16 mesh."""
    rec = launch_train.main(["--arch", "olmo_1b", "--dry-run"])
    assert rec["status"] == "ok" and rec["shape"] == "train_4k"
    assert rec["mesh"] == "16x16" and rec["n_microbatches"] == 4
    assert rec["cost"]["model_flops"] > 0
