"""MoE's expert-parallel branch (``repro_torch.models.moe``) against the JAX
package's ``_moe_shard``, on the CPU.

JAX runs its branch under ``shard_map`` on a model mesh; in one process
with one device it cannot, so each rank's body, ``_moe_shard(cfg, p, x,
r, n, cap)`` with the rank's slice of the expert weights, is called
directly, and the layouts are assembled from those calls as ``shard_map``
assembles them (batch slices, capacity from the data-rank token count, the
partials summed in ascending rank order).

* Per rank, for 1, 2 and 4 ranks, in f32 and bf16, on reduced
  ``deepseek_v2_lite_16b`` (swiglu, a shared expert), reduced
  ``arctic_480b`` (swiglu, a dense residual MLP) and a gelu variant, with
  planted ties (repeated tokens) and a capacity that drops tokens: the same
  tokens routed and kept (the exactly-zero rows of each rank's partial are
  JAX's) and the values JAX's to the two frameworks' rounding.  (XLA's CPU
  dot, exp and silu round differently from torch's, so the products are
  not JAX's bits.)
* Layouts, bit for bit against the port's own per-rank ``moe_shard``:
  under a 1x1 mesh ``moe_block`` is its no-mesh result; under 1x4 the
  rank-ordered sum of the four ranks; under 2x2 with B divisible each batch
  half's two ranks at capacity from (B*S)//2, and with B indivisible the
  whole batch (replicated) at that capacity.  Each layout also against
  JAX's per-rank outputs assembled the same way, to rounding.
* A rule table that shards the sequence (``sequence_parallel=True``)
  raises, as do experts that do not split over the ranks and a mesh device
  other than x's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import moe
from repro_torch.parallel import sharding as tsh

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = {"deepseek_v2_lite_16b": ("deepseek_v2_lite_16b", {}),
         "arctic_480b": ("arctic_480b", {}),
         "gelu": ("deepseek_v2_lite_16b", {"mlp": "gelu"})}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """case -> (port cfg, JAX cfg, JAX params, port MoE), JAX's init
    carried into the port."""
    out = {}
    for case, (arch, changes) in CASES.items():
        cj = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                 **changes)
        ct = dataclasses.replace(reduced_config(get_config(arch)), **changes)
        pj, _ = jax_moe.init_moe(cj, jax.random.PRNGKey(3))
        pt = moe.MoE(ct, None, "cpu")
        sd = {}

        def flat(d, pre=""):
            for k, v in d.items():
                if isinstance(v, dict):
                    flat(v, pre + k + ".")
                else:
                    sd[pre + k] = torch.from_numpy(np.array(v))

        flat(pj)
        pt.load_state_dict(sd, strict=True)
        out[case] = (ct, cj, pj, pt)
    return out


def tokens(cfg, B, S, seed):
    """x (B,S,D) f32 with planted ties: the second half of each sequence
    repeats the first, so gates tie exactly and capacity drops among
    equal weights."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x[:, S // 2:] = x[:, :(S - S // 2)]
    return x


def jax_rank(cj, pj, x, r, n, cap, jdt):
    """JAX's per-rank body with the rank's slice of the expert weights."""
    e_loc = cj.moe.n_experts // n
    pr = dict(pj)
    for w in ("wi", "wo", "wg"):
        if w in pj:
            pr[w] = pj[w][r * e_loc:(r + 1) * e_loc]
    y = jax.jit(lambda p, x: jax_moe._moe_shard(cj, p, x, r, n, cap))(
        pr, jnp.asarray(x, jdt))
    return np.asarray(y.astype(jnp.float32))


def jax_rank_sum(cj, pj, x, n, cap, jdt):
    """The ranks' partials summed in ascending rank order, in ``jdt``."""
    y = None
    for r in range(n):
        part = jnp.asarray(jax_rank(cj, pj, x, r, n, cap, jdt), jdt)
        y = part if y is None else y + part
    return np.asarray(y.astype(jnp.float32))


def jax_residuals(cj, pj, x, jdt):
    """JAX's shared-expert and dense-residual MLPs of ``moe_block``."""
    xj = jnp.asarray(x, jdt)
    out = jnp.zeros(xj.shape, jdt)
    if cj.moe.n_shared:
        out = out + jax_layers.apply_mlp(cj, pj["shared"], xj)
    if cj.moe.dense_residual:
        out = out + jax_layers.apply_mlp(cj, pj["dense"], xj)
    return out


def assert_close(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_each_rank_routes_and_computes_as_jax(pairs, case, dtype):
    ct, cj, pj, pt = pairs[case]
    B, S = 2, 12
    x = tokens(ct, B, S, seed=7)
    xt = torch.from_numpy(x).to(dtype)
    for cap in (moe.capacity(ct, B * S), 3):
        for n in (1, 2, 4):
            for r in range(n):
                want = jax_rank(cj, pj, x, r, n, cap, JDT[dtype])
                with torch.no_grad():
                    got = moe.moe_shard(ct, pt, xt, cap, r, n).float()
                got = got.numpy()
                what = (case, dtype, cap, n, r)
                # the same tokens routed to and kept by the rank's experts
                assert np.array_equal((got == 0).all(-1),
                                      (want == 0).all(-1)), what
                assert_close(got, want, dtype, what)


def test_rank_arguments_are_checked(pairs):
    ct, _, _, pt = pairs["deepseek_v2_lite_16b"]
    x = torch.zeros((1, 4, ct.d_model))
    with pytest.raises(ValueError):
        moe.moe_shard(ct, pt, x, 2, 0, 3)      # 4 experts over 3 ranks
    with pytest.raises(ValueError):
        moe.moe_shard(ct, pt, x, 2, 4, 4)


def _port_layout(ct, pt, xt, n_data, n, cap):
    """The port's per-rank moe_shard assembled as shard_map would."""
    rows = xt.shape[0] // n_data
    outs = []
    for d in range(n_data):
        xd = xt[d * rows:(d + 1) * rows]
        y = moe.moe_shard(ct, pt, xd, cap, 0, n)
        for r in range(1, n):
            y = y + moe.moe_shard(ct, pt, xd, cap, r, n)
        outs.append(y)
    y = torch.cat(outs, dim=0)
    if ct.moe.n_shared:
        y = y + moe.apply_mlp(ct, pt.shared, xt)
    if ct.moe.dense_residual:
        y = y + moe.apply_mlp(ct, pt.dense, xt)
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout,B", [("1x1", 4), ("1x4", 4), ("2x2", 4),
                                      ("2x2", 3)])
def test_moe_block_layouts(pairs, case, dtype, layout, B):
    ct, cj, pj, pt = pairs[case]
    S = 10
    x = tokens(ct, B, S, seed=B + 11)
    xt = torch.from_numpy(x).to(dtype)
    n_data, n = (int(a) for a in layout.split("x"))
    mesh = tsh.ModelMesh.of({"data": n_data, "model": n})
    with torch.no_grad():
        plain = moe.moe_block(ct, pt, xt)
        with tsh.sharding_ctx(mesh):
            got = moe.moe_block(ct, pt, xt)
        if n == 1:
            assert torch.equal(got.view(torch.int16 if dtype ==
                                        torch.bfloat16 else torch.int32),
                               plain.view(torch.int16 if dtype ==
                                          torch.bfloat16 else torch.int32))
            return
        cap = moe.capacity(ct, (B * S) // n_data)
        slices = n_data if B % n_data == 0 else 1
        want_port = _port_layout(ct, pt, xt, slices, n, cap)
    assert torch.equal(got, want_port), (case, dtype, layout, B)
    # JAX: each batch slice's ranks summed in rank order, + the residual MLPs
    jdt = JDT[dtype]
    rows = B // slices
    parts = [jax_rank_sum(cj, pj, x[d * rows:(d + 1) * rows], n, cap, jdt)
             for d in range(slices)]
    want = np.asarray((jnp.asarray(np.concatenate(parts, 0), jdt)
                       + jax_residuals(cj, pj, x, jdt)).astype(jnp.float32))
    assert_close(got.float().numpy(), want, dtype, (case, layout, B))


def test_sequence_parallel_device_and_split_errors(pairs):
    ct, _, _, pt = pairs["deepseek_v2_lite_16b"]
    x = torch.zeros((2, 8, ct.d_model))
    mesh = tsh.ModelMesh.of({"data": 1, "model": 2})
    with tsh.sharding_ctx(mesh, tsh.default_rules(sequence_parallel=True)):
        with pytest.raises(NotImplementedError):
            moe.moe_block(ct, pt, x)
    with tsh.sharding_ctx(tsh.ModelMesh.of({"data": 1, "model": 2},
                                           "meta")):
        with pytest.raises(ValueError):
            moe.moe_block(ct, pt, x)
    with tsh.sharding_ctx(tsh.ModelMesh.of({"data": 1, "model": 3})):
        with pytest.raises(ValueError):
            moe.moe_block(ct, pt, x)
    # sequence-parallel rules with a seq the axis does not divide: seq
    # falls back to replicated, as in JAX, and the branch runs
    with tsh.sharding_ctx(mesh, tsh.default_rules(sequence_parallel=True)):
        y = moe.moe_block(ct, pt, torch.zeros((2, 7, ct.d_model)))
    assert y.shape == (2, 7, ct.d_model)
