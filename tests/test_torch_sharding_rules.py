"""The port's logical-axis rules (``repro_torch.parallel.sharding``'s model
half) against the JAX package's, on the CPU.

* ``default_rules`` (and ``sequence_parallel=True``) is JAX's table entry
  for entry; ``spec_for`` gives JAX's spec for every logical name, dims
  {1, 7, 9, 16, 24, 48, 56, 256, 32768}, on meshes of 1x1, 1x4, 4x4, 16x16
  and 2x16x16 (plain ``.shape`` descriptions on both sides), and for the
  multi-axis cases of ``test_sharding.py``; unknown names and wrong ranks
  raise in both.  A one-axis tuple is compared as its name, as jax 0.9's
  ``PartitionSpec`` prints it.
* The attention shard plan (``_attn_shard_plan``, ``_pad_heads``) and
  ``fsdp_use`` agree with JAX; attention under a mesh that pads heads
  gives what it gives without one.
* ``param_axes`` of every architecture at full width (built on ``meta``)
  is JAX's ``abstract_params`` axes, carried by ``convert``'s naming rule
  with the stacked superblock axis dropped; the optimizers' ``state_axes``
  follow the port's state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import get_config as jax_get_config
from repro.launch.abstract import abstract_params as jax_abstract_params
from repro.models import layers as jax_layers
from repro.models.model import DecoderLM as JaxDecoderLM
from repro.parallel import sharding as jsh
from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.launch.abstract import abstract_opt_state, abstract_params
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import layers
from repro_torch.models.model import DecoderLM, param_axes
from repro_torch.parallel import sharding as tsh
from repro_torch.training import optimizer as topt

DIMS = (1, 7, 9, 16, 24, 48, 56, 256, 32768)
MESHES = {"1x1": {"data": 1, "model": 1}, "1x4": {"data": 1, "model": 4},
          "4x4": {"data": 4, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def norm(spec):
    """A spec as a tuple of entries, a one-axis tuple as its name."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(tuple(e) if isinstance(e, tuple) else e)
    return tuple(out)


@pytest.mark.parametrize("seq_par", [False, True])
def test_default_rules_table_is_jax(seq_par):
    jt = jsh.default_rules(sequence_parallel=seq_par).table
    tt = tsh.default_rules(sequence_parallel=seq_par).table
    assert tt == jt


@pytest.mark.parametrize("seq_par", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_for_every_name_and_dim(seq_par, mesh_name):
    jr = jsh.default_rules(sequence_parallel=seq_par)
    tr = tsh.default_rules(sequence_parallel=seq_par)
    mesh = FakeMesh(MESHES[mesh_name])
    tmesh = tsh.ModelMesh.of(MESHES[mesh_name])
    names = sorted(jr.table) + [None]
    for name in names:
        for d in DIMS:
            want = norm(jsh.spec_for((d,), (name,), mesh, jr))
            assert norm(tsh.spec_for((d,), (name,), mesh, tr)) == want
            assert norm(tsh.spec_for((d,), (name,), tmesh, tr)) == want
    # pairs: a later dim cannot take a mesh axis an earlier one took
    for a in ("batch", "experts", "cache_seq", "embed", "heads"):
        for b in ("cache_seq", "mlp", "embed", "batch", "kv_heads"):
            for d0 in (1, 16, 256):
                for d1 in (48, 56, 32768):
                    want = norm(jsh.spec_for((d0, d1), (a, b), mesh, jr))
                    assert norm(tsh.spec_for((d0, d1), (a, b), mesh,
                                             tr)) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape,axes", [
    ((64, 2048, 1408), ("experts", "embed", "mlp")),
    ((8, 128, 32768, 8, 256),
     (None, "batch", "cache_seq", "kv_heads", "head_dim")),
    ((8, 1, 524288, 8, 256),
     (None, "batch", "cache_seq", "kv_heads", "head_dim")),
    ((128, 32768, 512), ("batch", "cache_seq", "kv_lora")),
    ((256, 4096, 2048), ("batch", "seq", "act_embed")),
    ((56, 128, 7168), ("w_heads", "head_dim", "embed")),
])
def test_spec_for_multi_axis_cases(mesh_name, shape, axes):
    mesh = FakeMesh(MESHES[mesh_name])
    for seq_par in (False, True):
        jr = jsh.default_rules(sequence_parallel=seq_par)
        tr = tsh.default_rules(sequence_parallel=seq_par)
        assert norm(tsh.spec_for(shape, axes, mesh, tr)) == \
            norm(jsh.spec_for(shape, axes, mesh, jr))


def test_spec_for_raises_as_jax_and_no_mesh_is_empty():
    mesh = FakeMesh(MESHES["16x16"])
    with pytest.raises(KeyError):
        jsh.spec_for((4,), ("nope",), mesh, jsh.default_rules())
    with pytest.raises(KeyError):
        tsh.spec_for((4,), ("nope",), mesh, tsh.default_rules())
    with pytest.raises(AssertionError):
        jsh.spec_for((4, 4), ("batch",), mesh, jsh.default_rules())
    with pytest.raises(ValueError):
        tsh.spec_for((4, 4), ("batch",), mesh, tsh.default_rules())
    assert tsh.spec_for((4,), ("batch",)) == tsh.PartitionSpec() == ()
    with tsh.sharding_ctx(tsh.ModelMesh.of(MESHES["16x16"])):
        assert tsh.active_mesh().shape == MESHES["16x16"]
        assert norm(tsh.spec_for((256,), ("batch",))) == ("data",)
        x = torch.zeros(4, 4)
        assert tsh.constrain(x, ("batch", None)) is x
        with pytest.raises(KeyError):
            tsh.constrain(x, ("batch", "nope"))
        with pytest.raises(ValueError):
            tsh.constrain(x, ("batch",))
    assert tsh.active_mesh() is None
    assert tsh.spec_for((256,), ("batch",)) == ()


def test_meshes_and_shard_shapes():
    m = make_production_mesh()
    assert list(m.shape.items()) == [("data", 16), ("model", 16)]
    assert m.device is None
    mp = make_production_mesh(multi_pod=True)
    assert list(mp.shape.items()) == [("pod", 2), ("data", 16),
                                      ("model", 16)]
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    ns = tsh.named_sharding((8, 256, 32768, 8, 128),
                            (None, "batch", "cache_seq", "kv_heads",
                             "head_dim"), mp)
    assert norm(ns.spec) == (None, ("pod", "data"), "model", None, None)
    assert ns.shard_shape((8, 256, 32768, 8, 128)) == (8, 8, 2048, 8, 128)
    with pytest.raises(ValueError):
        tsh.NamedSharding(m, tsh.PartitionSpec("model")).shard_shape((24,))
    tree = {"a": torch.empty((256, 7), device="meta"),
            "b": [torch.empty((16,), device="meta"), 3]}
    axes = {"a": ("batch", None), "b": [("mlp",), ()]}
    sh = tsh.tree_shardings(tree, axes, m)
    assert sh["a"].shard_shape((256, 7)) == (16, 7)
    assert sh["b"][0].shard_shape((16,)) == (1,) and sh["b"][1] is None


@pytest.mark.parametrize("model", [1, 3, 4, 8, 16])
def test_attn_shard_plan_and_pad_heads_match_jax(model, monkeypatch):
    mesh = FakeMesh({"data": 2, "model": model})
    tmesh = tsh.ModelMesh.of(mesh.shape)
    monkeypatch.setattr(jsh._CTX, "mesh", mesh, raising=False)
    with tsh.sharding_ctx(tmesh):
        for h in (1, 2, 4, 6, 8, 12, 16, 20, 24, 40, 48, 56, 64):
            assert layers._attn_shard_plan(h) == \
                jax_layers._attn_shard_plan(h)
    monkeypatch.setattr(jsh._CTX, "mesh", None, raising=False)
    assert layers._attn_shard_plan(24) == jax_layers._attn_shard_plan(24) \
        == ("seq", 24)
    r = np.random.default_rng(model)
    a = r.standard_normal((3, 5, 7)).astype(np.float32)
    for axis in range(3):
        for h_pad in (a.shape[axis], a.shape[axis] + 1,
                      2 * a.shape[axis] + 3):
            want = np.asarray(jax_layers._pad_heads(jnp.asarray(a), h_pad,
                                                    axis))
            got = layers._pad_heads(torch.from_numpy(a), h_pad, axis)
            assert np.array_equal(got.numpy(), want)


def test_fsdp_use_casts_and_releases_embed():
    w = np.random.default_rng(0).standard_normal((64, 4, 16)).astype(
        np.float32)
    ax = ("embed", "w_heads", "head_dim")
    want_plain = np.asarray(jsh.fsdp_use(jnp.asarray(w), ax, jnp.bfloat16)
                            .astype(jnp.float32))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    with jsh.sharding_ctx(mesh):
        want_mesh = np.asarray(jax.jit(
            lambda x: jsh.fsdp_use(x, ax, jnp.bfloat16))(jnp.asarray(w))
            .astype(jnp.float32))
    got = tsh.fsdp_use(torch.from_numpy(w), ax, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), want_plain)
    seen = []
    real = tsh.constrain

    def spy(x, axes):
        seen.append(tuple(axes))
        return real(x, axes)

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(tsh, "constrain", spy)
        with tsh.sharding_ctx(make_host_mesh()):
            got_m = tsh.fsdp_use(torch.from_numpy(w), ax, torch.bfloat16)
            with pytest.raises(KeyError):
                tsh.fsdp_use(torch.from_numpy(w), ("embed", "x", None),
                             torch.bfloat16)
    assert seen[0] == ("embed_full", "w_heads", "head_dim")
    assert np.array_equal(got_m.float().numpy(), want_mesh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_under_a_padding_mesh_matches_no_mesh(dtype):
    """Reduced musicgen (4 heads) on a 'model' axis of 3: heads padded to
    6 (JAX's plan), the dead heads add exactly 0 up to the products'
    rounding; seq_sp (no padding) on an axis of 16 changes nothing."""
    cfg = dataclasses.replace(reduced_config(get_config("musicgen_medium")),
                              n_kv_heads=2)
    p = layers.Attention(cfg, torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((2, 9, cfg.d_model)).astype(
        np.float32)).to(dtype)
    q_pos = torch.arange(9, dtype=torch.int32)
    with torch.no_grad():
        k, v = layers.project_kv(cfg, p, x, q_pos)
        base = layers.attention(cfg, p, x, k, v, q_pos, q_pos,
                                use_kernel=False)
        seen = []
        real = layers._pad_heads
        with pytest.MonkeyPatch.context() as mp_:
            mp_.setattr(layers, "_pad_heads",
                        lambda a, h, ax: seen.append(h) or real(a, h, ax))
            with tsh.sharding_ctx(tsh.ModelMesh.of({"data": 1,
                                                    "model": 3})):
                padded = layers.attention(cfg, p, x, k, v, q_pos, q_pos,
                                          use_kernel=False)
            with tsh.sharding_ctx(tsh.ModelMesh.of({"data": 1,
                                                    "model": 16})):
                sp = layers.attention(cfg, p, x, k, v, q_pos, q_pos,
                                      use_kernel=False)
    assert seen == [6, 6, 6, 6]
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    assert float((padded.float() - base.float()).abs().max()) <= \
        tol * float(base.float().abs().max())
    assert torch.equal(sp, base)


def _jax_axes_by_port_name(tree, cfg):
    """JAX's axes tree -> {port state_dict name: axes}: ``convert``'s
    naming rule, the stacked superblock axis dropped."""
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, name + ".")
            elif name.startswith("blocks."):
                assert v[0] is None
                rest = name.split(".", 1)[1]
                for i in range(cfg.n_superblocks):
                    out[f"blocks.{i}.{rest}"] = tuple(v[1:])
            else:
                out[name] = tuple(v)

    walk(tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_are_jax_abstract_params_axes(arch):
    cfg = get_config(arch)
    model = DecoderLM(cfg, device="meta")
    shapes_j, axes_j = jax_abstract_params(JaxDecoderLM(jax_get_config(arch)))
    want = _jax_axes_by_port_name(axes_j, cfg)
    got = param_axes(model)
    assert got == want
    p_abs, p_axes = abstract_params(model)
    assert p_axes == got and list(p_abs) == [n for n, _ in
                                             model.named_parameters()]
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in p_abs.values())
    assert all(len(p_axes[n]) == t.ndim for n, t in p_abs.items())
    assert sum(t.numel() for t in p_abs.values()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes_j))


def test_optimizer_state_axes_follow_the_port_state():
    cfg = reduced_config(get_config("zamba2_2_7b"))
    model = DecoderLM(cfg, device="meta")
    p_abs, p_axes = abstract_params(model)
    for opt in (topt.adamw(), topt.adafactor()):
        state, axes = abstract_opt_state(opt, p_abs, p_axes)
        assert axes["step"] == () and state["step"].shape == ()
        assert state["step"].device.type == "meta"
        for key in set(state) - {"step"}:
            assert set(state[key]) == set(axes[key]) == set(p_abs)
            for name, t in state[key].items():
                assert t.device.type == "meta"
                assert len(axes[key][name]) == t.ndim, (key, name)
    ada = topt.adafactor().state_axes(p_axes)
    name = "blocks.0.mamba_0.mamba.wz"
    assert ada["vr"][name] == ("embed",) and ada["vc"][name] == (
        "ssm_inner",)
    assert ada["vr"]["blocks.0.mamba_0.ln.scale"] == ("norm",)
    assert ada["vc"]["blocks.0.mamba_0.ln.scale"] == (None,)
    assert topt.adamw().state_axes(p_axes)["mu"] == p_axes
