"""The port's dry-run (``repro_torch.launch.{mesh,abstract,dryrun}``) against
the JAX package's abstract state, on the CPU (nothing is allocated: the
port builds on the ``meta`` device, JAX traces with ``eval_shape``).

* ``input_specs`` is JAX's for the 10 architectures x 4 shapes;
  ``cache_axes`` and ``abstract_cache`` are JAX's ``init_cache`` tree at
  (128, 32768), the stacked superblock axis dropped.
* ``lower_cell(..., trace=False)``'s ``argument_size_in_bytes`` equals the
  per-device bytes computed here from JAX's abstract state (params and
  optimizer state, or params, cache and inputs) and JAX's ``spec_for``,
  for every cell on both production meshes.  Two differences are allowed,
  each computed exactly: the 4-byte int32 ``pos`` of JAX's cache (a
  Python int in the port), and Adafactor's state of a stacked 1-axis leaf
  (JAX factors the (n_superblocks, d) stack; the port keeps each
  superblock's full moment and a (1,) placeholder).  Skipped cells carry
  JAX's ``supports_shape`` reason.
* ``lower_cell`` with ``trace=True`` on reduced configs (dense, local
  window, Mamba2, shared attention, MoE + MLA, audio, vision) ends ``ok``;
  reduced olmo's prefill flops equal a count written out from the config.
* ``python -m repro_torch.launch.dryrun`` writes a record (the port's
  counterpart of JAX's ``test_real_dryrun_subprocess``), and both
  launchers' ``--dry-run`` print one.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.launch import abstract as jax_abstract
from repro.models.model import DecoderLM as JaxDecoderLM
from repro.parallel import sharding as jsh
from repro.training import optimizer as jax_opt
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, input_specs,
                                 reduced_config)
from repro_torch.launch import dryrun
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.abstract import abstract_cache, batch_axes
from repro_torch.models.model import DecoderLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_batch_axes_are_jax(arch):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    for s in SHAPES:
        want = jax_base.input_specs(cfg_j, jax_base.SHAPES[s])
        got = input_specs(cfg_t, SHAPES[s])
        assert list(got) == list(want)
        for k, sds in want.items():
            assert got[k][0] == tuple(sds.shape)
            assert _dtype_name(got[k][1]) == _dtype_name(sds.dtype)
        assert batch_axes(cfg_t, SHAPES[s]) == jax_abstract.batch_axes(
            cfg_j, jax_base.SHAPES[s])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_abstract_cache_are_jax(arch):
    cfg = get_config(arch)
    c_j, a_j = jax_abstract.abstract_cache(JaxDecoderLM(jax_get_config(arch)),
                                           128, 32768)
    c_t, a_t = abstract_cache(DecoderLM(cfg, device="meta"), 128, 32768)
    assert a_t["pos"] == a_j["pos"] == () and c_t["pos"] == 0
    assert len(c_t["layers"]) == len(a_t["layers"]) == cfg.n_superblocks
    for i, (sb, sb_ax) in enumerate(zip(c_t["layers"], a_t["layers"])):
        assert set(sb) == set(sb_ax) == set(c_j["layers"])
        for key, bufs in sb.items():
            assert set(bufs) == set(sb_ax[key]) == set(c_j["layers"][key])
            for name, t in bufs.items():
                sds = c_j["layers"][key][name]
                assert t.device.type == "meta"
                assert (cfg.n_superblocks,) + tuple(t.shape) == sds.shape
                assert _dtype_name(t.dtype) == _dtype_name(sds.dtype)
                assert (None,) + sb_ax[key][name] == \
                    a_j["layers"][key][name]
    with pytest.raises(ValueError):
        abstract_cache(DecoderLM(reduced_config(cfg), device="cpu"), 1, 8)


# ---------------------------------------------------------------------------
# Argument bytes of every cell against JAX's abstract state.
# ---------------------------------------------------------------------------

_JAX_STATE = {}


def _jax_state(arch):
    """(cfg, model, params, param axes, opt state, opt axes) of JAX's
    dry-run, built once an architecture."""
    if arch not in _JAX_STATE:
        cfg = jax_get_config(arch)
        model = JaxDecoderLM(cfg)
        p_abs, p_axes = jax_abstract.abstract_params(model)
        opt = (jax_opt.adafactor(lr=1e-2) if cfg.param_count() > 1e11
               else jax_opt.adamw(lr=3e-4))
        o_abs, o_axes = jax_abstract.abstract_opt_state(opt, p_abs, p_axes)
        _JAX_STATE[arch] = (cfg, model, p_abs, p_axes, o_abs, o_axes)
    return _JAX_STATE[arch]


def _shard_bytes(shape, dtype, axes, mesh) -> int:
    spec = jsh.spec_for(shape, axes, mesh, jsh.default_rules())
    n = 1
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        flat = (e,) if isinstance(e, str) else (e or ())
        n *= d // math.prod(mesh.shape[a] for a in flat)
    return n * np.dtype(dtype).itemsize


def _tree_bytes(tree, axes, mesh) -> int:
    return sum(jax.tree.leaves(jax.tree.map(
        lambda s, ax: _shard_bytes(s.shape, s.dtype, ax, mesh), tree, axes)))


def _adafactor_difference(p_abs, p_axes, mesh) -> int:
    """Port minus JAX bytes of Adafactor's state of the stacked 1-axis
    leaves (n_sb, d): JAX's vr (n_sb,) replicated and vc (d,) on the
    leaf's axis; the port's, each superblock, vr (d,) on that axis and vc
    (1,) replicated."""
    f32 = np.float32

    def one(s, ax):
        if len(s.shape) != 2:
            return 0
        n_sb, d = s.shape
        jax_b = (_shard_bytes((n_sb,), f32, (None,), mesh)
                 + _shard_bytes((d,), f32, ax[1:], mesh))
        return n_sb * (_shard_bytes((d,), f32, ax[1:], mesh) + 4) - jax_b

    return sum(jax.tree.leaves(jax.tree.map(one, p_abs["blocks"],
                                            p_axes["blocks"])))


def _jax_argument_bytes(arch, shape_name, multi_pod) -> int:
    cfg, model, p_abs, p_axes, o_abs, o_axes = _jax_state(arch)
    shape = jax_base.SHAPES[shape_name]
    mesh = FakeMesh(MESHES[multi_pod])
    specs = dict(jax_base.input_specs(cfg, shape))
    b_axes = jax_abstract.batch_axes(cfg, shape)
    if shape.is_train:
        n = dryrun.microbatch_policy(cfg)
        specs = {k: jax.ShapeDtypeStruct((n, v.shape[0] // n) + v.shape[1:],
                                         v.dtype) for k, v in specs.items()}
        b_axes = {k: (None,) + ax for k, ax in b_axes.items()}
    total = _tree_bytes(p_abs, p_axes, mesh) + _tree_bytes(specs, b_axes,
                                                           mesh)
    if shape.is_train:
        total += _tree_bytes(o_abs, o_axes, mesh)
        if isinstance(o_abs, jax_opt.AdafactorState):
            total += _adafactor_difference(p_abs, p_axes, mesh)
        return total
    c_abs, c_axes = jax_abstract.abstract_cache(model, shape.global_batch,
                                                shape.seq_len)
    # the port's cache position is a Python int: JAX's 4-byte int32 scalar
    return total + _tree_bytes(c_abs, c_axes, mesh) - 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_and_skips_are_jax_every_cell(arch):
    cfg_j = jax_get_config(arch)
    for shape_name in SHAPES:
        ok, why = cfg_j.supports_shape(jax_base.SHAPES[shape_name])
        for mp in (False, True):
            rec = dryrun.lower_cell(arch, shape_name, multi_pod=mp,
                                    trace=False)
            assert rec["mesh"] == ("2x16x16" if mp else "16x16")
            assert rec["chips"] == (512 if mp else 256)
            if not ok:
                assert rec["status"] == "skipped" and rec["reason"] == why
                continue
            assert rec["status"] == "ok", rec
            mem = rec["memory"]
            assert mem["argument_size_in_bytes"] == _jax_argument_bytes(
                arch, shape_name, mp), (arch, shape_name, mp)
            assert mem["temp_size_in_bytes"] is None
            assert mem["per_device_total"] == (
                mem["argument_size_in_bytes"] - mem["alias_size_in_bytes"]
                + mem["output_size_in_bytes"])
            assert rec["fits"] is None and rec["device_bytes"] is None
            assert rec["n_microbatches"] == (
                dryrun.microbatch_policy(cfg_j) if shape_name == "train_4k"
                else 1)
            assert rec["optimizer"] == ("adafactor" if arch == "arctic_480b"
                                        else "adamw")
            assert "cost" not in rec and rec["notes"]


def test_fits_holds_the_total_to_device_bytes():
    rec = dryrun.lower_cell("olmo_1b", "decode_32k", trace=False,
                            device_bytes=80 * 2 ** 30)
    assert rec["fits"] is True and rec["device_bytes"] == 80 * 2 ** 30
    rec = dryrun.lower_cell("olmo_1b", "decode_32k", trace=False,
                            device_bytes=2 ** 20)
    assert rec["fits"] is False


# ---------------------------------------------------------------------------
# The meta trace on reduced configs.
# ---------------------------------------------------------------------------

def _reduced(arch, **changes):
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _full_chunk(arch):
    """The reduced SSM at the full configuration's scan chunk (256; the
    reduced 32 would loop over 1024 chunks of a 32k prompt)."""
    return {"ssm": dataclasses.replace(reduced_config(get_config(arch)).ssm,
                                       chunk=get_config(arch).ssm.chunk)}


TRACED = [("olmo_1b", {}), ("gemma3_12b", {}),
          ("mamba2_130m", _full_chunk("mamba2_130m")),
          ("zamba2_2_7b", _full_chunk("zamba2_2_7b")),
          ("musicgen_medium", {}), ("internvl2_26b", {}),
          # 16 experts: one a rank of the 16-way 'model' axis
          ("deepseek_v2_lite_16b",
           {"moe": dataclasses.replace(
               reduced_config(get_config("deepseek_v2_lite_16b")).moe,
               n_experts=16)})]


@pytest.mark.parametrize("arch,changes", TRACED, ids=[a for a, _ in TRACED])
def test_trace_on_reduced_configs_ends_ok(arch, changes):
    """Every shape on the 16x16 mesh; MoE's expert-parallel ranks also on
    2x16x16 (32 batch slices)."""
    extra = _reduced(arch, **changes)
    for shape_name in SHAPES:
        for mp in (False, True) if arch == "deepseek_v2_lite_16b" else (
                False,):
            rec = dryrun.lower_cell(arch, shape_name, multi_pod=mp,
                                    extra=extra, trace=True)
            ok, why = get_config(arch).supports_shape(SHAPES[shape_name])
            assert rec["status"] == ("ok" if ok else "skipped"), rec
            if ok:
                assert rec["cost"]["model_flops"] > 0
                assert rec["trace_s"] >= 0


def test_reduced_olmo_prefill_flops_are_counted_from_the_config():
    extra = _reduced("olmo_1b")
    rec = dryrun.lower_cell("olmo_1b", "prefill_32k", extra=extra,
                            trace=True)
    B, S = 32, 32768
    D, H, KV, hd = extra["d_model"], extra["n_heads"], extra["n_kv_heads"], \
        extra["d_model"] // extra["n_heads"]
    F, V, L = extra["d_ff"], extra["vocab"], extra["n_layers"]
    assert extra["mlp"] == "swiglu" and not extra["head_dim"]
    per_layer = (2 * B * S * D * H * hd            # q
                 + 2 * 2 * B * S * D * KV * hd     # k, v
                 + 2 * 2 * B * H * S * S * hd      # scores, weights x v
                 + 2 * B * S * H * hd * D          # out
                 + 3 * 2 * B * S * D * F)          # swiglu
    assert rec["cost"]["model_flops"] == L * per_layer + 2 * B * D * V


# ---------------------------------------------------------------------------
# The CLI and the launchers.
# ---------------------------------------------------------------------------

def test_dryrun_cli_writes_the_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "olmo_1b", "--shape", "decode_32k", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.load(open(tmp_path / "olmo_1b.decode_32k.single.json"))
    assert rec["status"] == "ok" and rec["optimizer"] == "adamw"
    assert rec["cost"]["model_flops"] > 0
    assert rec["memory"]["per_device_total"] < 16 * 2 ** 30
    assert rec["fits"] is None
    assert "[ok     ] olmo_1b.decode_32k.single" in out.stdout


def test_dryrun_cli_exits_1_on_a_failing_cell(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "lower_cell", boom)
    assert dryrun.main(["--arch", "olmo_1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    rec = json.load(open(tmp_path / "olmo_1b.decode_32k.single.json"))
    assert rec["status"] == "error" and "planted" in rec["error"]


@pytest.mark.parametrize("launcher,argv", [
    (launch_train, ["--arch", "olmo_1b", "--dry-run"]),
    (launch_serve, ["--arch", "mamba2_130m", "--dry-run", "--shape",
                    "long_500k", "--multi-pod"])])
def test_launchers_dry_run_print_a_record(launcher, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = launcher.main(argv)
    printed = json.loads(buf.getvalue())
    assert printed == json.loads(json.dumps(rec))
    assert rec["status"] == "ok" and rec["cost"]["model_flops"] > 0
    assert rec["shape"] == ("train_4k" if launcher is launch_train
                            else "long_500k")
    assert rec["mesh"] == ("16x16" if launcher is launch_train
                           else "2x16x16")
