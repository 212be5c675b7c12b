"""The port's training path against the JAX package's, on the CPU: the
loss and its gradients, and three steps of a whole ``Trainer``.

Each reduced configuration is built by JAX's ``DecoderLM.init``;
``params_from_jax`` carries its params into the port's ``DecoderLM(
use_kernels=False)`` (the plain code that training differentiates), and
the same token ids and labels, drawn with numpy from a seed, go through
both.  Both packages' ``Q_CHUNK`` and the loss's ``chunk_tokens`` are
patched small, the same in both, so that at seq 64-72 the attention runs
several q-chunks (olmo_1b: 4 chunks, each its static causal slice;
zamba2_2_7b: 9 uniform chunks; gemma3_12b: 9 chunks, its local layers the
banded branch with reduced gemma3's window of 32), the SSD scan pads the
sequence to whole chunks of 32, and the loss sums several chunks.  JAX
runs without remat (the same values; it compiles faster).

* f32 (both ``COMPUTE_DTYPE`` patched to f32): the loss to 1e-5 relative,
  every gradient to 1e-4 of its leaf's largest magnitude.
* bf16 (as trained): bf16 rounds at other places in the two frameworks,
  so the port is held to twice what JAX's own bf16 run differs from its
  f32 run (ROADMAP.md queue 3 item 2): the losses of 8 batches, each the
  largest difference, and the gradients of the first, the largest
  difference relative to its leaf's largest magnitude.
* ``Trainer``: three AdamW steps of reduced olmo_1b on JAX's three batches
  (JAX's ``_mk_trainer``: seq 32, batch 8, lr 3e-3) in f32: each step's
  loss and norms to 1e-5, the moments to 1e-4 of each leaf's largest, the
  parameters to 1e-6 but for the few entries whose gradient is within
  rounding of 0 (AdamW's step there is ill-conditioned: under 0.1 lr).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.training import trainer as jax_trainer
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticPipeline as JaxPipeline
from repro.training.optimizer import adamw as jax_adamw
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import layers as torch_layers
from repro_torch.models import model as torch_model
from repro_torch.models import ssm as torch_ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.training.data import DataConfig, SyntheticPipeline
from repro_torch.training.optimizer import adamw
from repro_torch.training.trainer import Trainer, TrainerConfig

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny, and the suite runs several workers on the
    host's cores: one intra-op thread a worker keeps torch's thread pool
    from spinning against the other workers (many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# arch -> (Q_CHUNK, seq): see the module docstring
SETTINGS = {"olmo_1b": (16, 64), "mamba2_130m": (8, 72),
            "zamba2_2_7b": (8, 72), "gemma3_12b": (8, 72)}
CHUNK_TOKENS = 48
N_BATCHES = 8
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """(arch, dtype) -> JAX's and the port's losses of N_BATCHES batches
    and gradients of the first, by the port's parameter names."""
    return {}


def _run(runs, arch, dtype):
    if (arch, dtype) in runs:
        return runs[arch, dtype]
    q_chunk, seq = SETTINGS[arch]
    dj, dt = DTYPES[dtype]
    cfg_j = jax_reduced_config(jax_get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    mj = jax_model.DecoderLM(cfg_j, remat=False)
    params, _ = mj.init(jax.random.PRNGKey(0))
    mt = torch_model.DecoderLM(cfg_t, device="cpu", use_kernels=False)
    mt.load_state_dict(params_from_jax(cfg_t, _to_np(params)), strict=True)
    r = np.random.default_rng(7)
    batches = [{"tokens": r.integers(0, cfg_t.vocab, (2, seq)),
                "labels": r.integers(0, cfg_t.vocab, (2, seq))}
               for _ in range(N_BATCHES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "COMPUTE_DTYPE", dj)
        mp.setattr(torch_model, "COMPUTE_DTYPE", dt)
        mp.setattr(jax_layers, "Q_CHUNK", q_chunk)
        mp.setattr(torch_layers, "Q_CHUNK", q_chunk)
        step = jax.jit(jax.value_and_grad(
            lambda p, b: mj.loss(p, b, chunk_tokens=CHUNK_TOKENS)))
        lj, gj = [], None
        for i, b in enumerate(batches):
            l, g = step(params, jax.tree.map(jnp.asarray, b))
            lj.append(float(l))
            gj = gj or params_from_jax(cfg_t, _to_np(g))
        lt, gt = [], None
        for i, b in enumerate(batches):
            bt = {k: torch.from_numpy(v) for k, v in b.items()}
            if i == 0:
                loss = mt.loss(bt, chunk_tokens=CHUNK_TOKENS)
                gt = dict(zip(
                    [k for k, _ in mt.named_parameters()],
                    torch.autograd.grad(loss, list(mt.parameters()))))
            else:
                with torch.no_grad():
                    loss = mt.loss(bt, chunk_tokens=CHUNK_TOKENS)
            assert loss.dtype == torch.float32 and loss.ndim == 0
            lt.append(float(loss.detach()))
    runs[arch, dtype] = (np.array(lj), gj, np.array(lt), gt)
    return runs[arch, dtype]


def _grad_err(got, want):
    """The largest gradient difference relative to its leaf's largest
    magnitude, over all leaves."""
    assert got.keys() == want.keys()
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


@pytest.mark.parametrize("arch", list(SETTINGS))
def test_loss_and_grads_match_jax_in_f32(runs, arch):
    lj, gj, lt, gt = _run(runs, arch, "f32")
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    for k in gj:
        scale = max(float(gj[k].abs().max()), 1e-30)
        assert float((gt[k] - gj[k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("arch", list(SETTINGS))
def test_loss_and_grads_match_jax_in_bf16_within_twice_its_own_spread(
        runs, arch):
    lj32, gj32, _, _ = _run(runs, arch, "f32")
    lj, gj, lt, gt = _run(runs, arch, "bf16")
    loss_spread = float(np.abs(lj - lj32).max())
    assert 0 < loss_spread < 0.05
    assert float(np.abs(lt - lj).max()) <= 2 * loss_spread
    grad_spread = _grad_err(gj, gj32)
    assert grad_spread > 0
    assert _grad_err(gt, gj) <= 2 * grad_spread


@pytest.mark.parametrize("arch", list(SETTINGS))
def test_loss_runs_the_chunked_paths(arch, monkeypatch):
    """At these settings the port's loss runs what the docstring says:
    each attention block's q-chunks with their key slices (olmo: the
    causal prefixes; zamba2 and gemma3's global blocks: all keys; gemma3's
    local blocks: bands of Q_CHUNK + window keys), every Mamba2 layer's
    scan on the sequence padded to whole chunks, and several CE chunks."""
    q_chunk, seq = SETTINGS[arch]
    cfg = reduced_config(get_config(arch))
    monkeypatch.setattr(torch_layers, "Q_CHUNK", q_chunk)
    calls = []
    real = torch_layers.remat

    def spy(fn, *args):
        calls.append((fn.__name__, tuple(args[2].shape[:2])
                      if fn.__name__ == "chunk_attn" else None))
        return real(fn, *args)

    monkeypatch.setattr(torch_layers, "remat", spy)
    scans = []
    real_scan = torch_ssm.ssd_chunked

    def scan_spy(xw, *args):
        scans.append(xw.shape[1])
        return real_scan(xw, *args)

    monkeypatch.setattr(torch_ssm, "ssd_chunked", scan_spy)
    m = torch_model.DecoderLM(cfg, device="cpu", use_kernels=False,
                              remat=False)
    r = np.random.default_rng(0)
    with torch.no_grad():
        m.loss({k: torch.from_numpy(r.integers(0, cfg.vocab, (2, seq)))
                for k in ("tokens", "labels")}, chunk_tokens=CHUNK_TOKENS)
    assert calls.count(("chunk_nll", None)) == 2 * seq // CHUNK_TOKENS
    n_mamba = cfg.pattern.count("mamba") * cfg.n_superblocks
    assert scans == [-(-seq // cfg.ssm.chunk) * cfg.ssm.chunk] * n_mamba \
        if n_mamba else scans == []
    widths = [w for name, (_, w) in
              ((n, k) for n, k in calls if n == "chunk_attn")]
    nc = seq // q_chunk
    n_attn = (len(cfg.pattern) - cfg.pattern.count("mamba")) \
        * cfg.n_superblocks
    if arch == "olmo_1b":
        assert widths == [(i + 1) * q_chunk for i in range(nc)] * n_attn
    elif arch == "mamba2_130m":
        assert widths == []
    elif arch == "zamba2_2_7b":
        assert widths == [seq] * nc * n_attn
    else:
        band = q_chunk + cfg.window
        assert sorted(set(widths)) == [band, seq]
        assert widths.count(band) == nc * cfg.pattern.count("local") \
            * cfg.n_superblocks


# ---------------------------------------------------------------------------
# A whole Trainer: three steps on JAX's batches.
# ---------------------------------------------------------------------------

def test_trainer_three_steps_match_jax_in_f32(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)
    cfg_j = jax_reduced_config(jax_get_config("olmo_1b"))
    cfg_t = reduced_config(get_config("olmo_1b"))
    pipe_j = JaxPipeline(JaxDataConfig(vocab=cfg_j.vocab, seq_len=32,
                                       global_batch=8))
    tj = jax_trainer.Trainer(
        jax_model.DecoderLM(cfg_j, remat=True), jax_adamw(lr=3e-3), pipe_j,
        jax_trainer.TrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                  ckpt_every=0))
    tj.init(jax.random.PRNGKey(0))
    mt = torch_model.DecoderLM(cfg_t, device="cpu", use_kernels=False)
    mt.load_state_dict(params_from_jax(cfg_t, _to_np(tj.params)))
    pipe_t = SyntheticPipeline(DataConfig(vocab=cfg_t.vocab, seq_len=32,
                                          global_batch=8))
    monkeypatch.setattr(pipe_t, "batch_at", lambda c: {
        k: torch.from_numpy(np.array(v)).long()
        for k, v in pipe_j.batch_at(c).items()})
    tt = Trainer(mt, adamw(lr=3e-3), pipe_t,
                 TrainerConfig(ckpt_dir=str(tmp_path / "t"), ckpt_every=0))
    tt.init()
    tj.run(3)
    tt.run(3)
    assert tt.step == tt.cursor == 3
    for mj_, mt_ in zip(tj.history, tt.history):
        for key in ("loss", "grad_norm", "update_norm"):
            assert mt_[key] == pytest.approx(mj_[key], rel=1e-5), key
    # AdamW divides each gradient by its own magnitude, so an entry whose
    # gradient lies within f32 rounding of 0 may step anywhere in
    # [-lr, lr]: all but 0.1% of the entries agree to 1e-6, and none is
    # off by 0.1 lr.
    want = params_from_jax(cfg_t, _to_np(tj.params))
    got = dict(mt.named_parameters())
    diff = torch.cat([(got[k].detach() - want[k]).abs().reshape(-1)
                      for k in want])
    assert float(diff.max()) <= 0.1 * 3e-3
    assert int((diff > 1e-6).sum()) <= 1e-3 * diff.numel()
    assert int(tt.opt_state["step"]) == int(tj.opt_state.step) == 3
    for name in ("mu", "nu"):
        want = params_from_jax(cfg_t, _to_np(getattr(tj.opt_state, name)))
        for k in want:
            scale = max(float(want[k].abs().max()), 1e-30)
            assert float((tt.opt_state[name][k] - want[k]).abs().max()) \
                <= 1e-4 * scale, (name, k)


# ---------------------------------------------------------------------------
# The switch: use_kernels=False is the model's own plain code.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_2_7b",
                                  "gemma3_12b", "olmo_1b"])
def test_plain_forward_equals_the_default_cpu_forward(arch, monkeypatch):
    """On the CPU the default model runs the kernels' plain versions.  Its
    forward equals the use_kernels=False forward: exactly where the two
    are the same arithmetic (mamba2: the same norm expression, and both pad
    a sequence longer than a chunk), and to f32 rounding where attention
    differs in where the scale is applied (flash's plain version after the
    product, JAX's jnp path folded into q)."""
    monkeypatch.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)
    cfg = reduced_config(get_config(arch))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 72)))
    outs = []
    for use_kernels in (True, False):
        m = torch_model.DecoderLM(cfg, device="cpu", seed=5,
                                  use_kernels=use_kernels)
        with torch.no_grad():
            outs.append(m({"tokens": toks}))
    if arch == "mamba2_130m":
        assert torch.equal(outs[0], outs[1])
    else:
        assert float((outs[0] - outs[1]).abs().max()) \
            <= 1e-5 * float(outs[1].abs().max())
