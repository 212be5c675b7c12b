"""Shared helpers of the port's model parity tests: a reduced architecture
built by JAX's ``DecoderLM.init`` and carried into the port, and both
packages' forward, serving (prefill + decode steps) and loss-and-gradient
runs with ``COMPUTE_DTYPE`` patched for the call."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import model as jax_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as torch_model
from repro_torch.models.convert import params_from_jax

F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


def _cfgs(arch, **changes):
    cfg_j = jax_reduced_config(jax_get_config(arch))
    cfg_t = reduced_config(get_config(arch))
    return (dataclasses.replace(cfg_j, **changes),
            dataclasses.replace(cfg_t, **changes))


def build_pair(arch, **changes):
    """(port cfg, JAX model, JAX params, port model) of the reduced arch,
    JAX's params carried into the port."""
    cfg_j, cfg_t = _cfgs(arch, **changes)
    mj = jax_model.DecoderLM(cfg_j, remat=False)
    params = jax.jit(lambda k: mj.init(k)[0])(jax.random.PRNGKey(0))
    mt = torch_model.DecoderLM(cfg_t, device="cpu")
    mt.load_state_dict(params_from_jax(
        cfg_t, jax.tree.map(np.asarray, params)), strict=True)
    return cfg_t, mj, params, mt

def serve_jax(mj, params, batch, fed, dtype):
    """JAX's prefill + one decode step per row of ``fed`` with
    COMPUTE_DTYPE ``dtype``: (f32 logits, final cache)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "COMPUTE_DTYPE", dtype)
        L = sum(v.shape[1] for k, v in batch.items() if k != "labels")
        c, _ = mj.init_cache(next(iter(batch.values())).shape[0],
                             L + len(fed))
        prefill = jax.jit(lambda p, b, c: mj.prefill(p, b, c))
        decode = jax.jit(lambda p, c, t: mj.decode_step(p, c, t))
        c, lg = prefill(params, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, c)
        out = [lg]
        for tok in fed:
            lg, c = decode(params, c, jnp.asarray(tok))
            out.append(lg)
    return [np.asarray(o.astype(jnp.float32)) for o in out], c


def serve_port(mt, batch, fed, dtype):
    """The port's prefill + decode steps, as ``serve_jax``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_model, "COMPUTE_DTYPE", dtype)
        L = sum(v.shape[1] for k, v in batch.items() if k != "labels")
        with torch.no_grad():
            c = mt.init_cache(next(iter(batch.values())).shape[0],
                              L + len(fed))
            c, lg = mt.prefill({k: torch.from_numpy(v)
                                for k, v in batch.items()}, c)
            out = [lg]
            for tok in fed:
                lg, c = mt.decode_step(c, torch.from_numpy(tok))
                out.append(lg)
    return [o.float().numpy() for o in out], c


def forward_jax(mj, params, batch, dtype):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "COMPUTE_DTYPE", dtype)
        fwd = jax.jit(lambda p, b: mj.forward(p, b))
        return np.asarray(fwd(params, {k: jnp.asarray(v) for k, v in
                                       batch.items()}).astype(jnp.float32))


def forward_port(mt, batch, dtype):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_model, "COMPUTE_DTYPE", dtype)
        with torch.no_grad():
            return mt.forward({k: torch.from_numpy(v)
                               for k, v in batch.items()}).float().numpy()


def assert_caches_close(ct, cj, tol):
    """Every cache buffer of the port within ``tol`` of the largest entry
    of JAX's (stacked over superblocks), positions equal."""
    assert ct["pos"] == int(cj["pos"])
    for i, sb in enumerate(ct["layers"]):
        for key, bufs in sb.items():
            for name, t in bufs.items():
                want = np.asarray(cj["layers"][key][name][i].astype(
                    jnp.float32))
                got = t.float().numpy()
                if name == "k_pos":
                    np.testing.assert_array_equal(got, want)
                else:
                    scale = max(float(np.abs(want).max()), 1e-30)
                    assert np.abs(got - want).max() <= tol * scale, \
                        (i, key, name)

def loss_and_grads(cfg, mj, params, mt, batch):
    """JAX's and the port's (loss, grads by the port's names), f32, the
    port's model its plain code (``use_kernels=False``) under remat."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_model, "COMPUTE_DTYPE", jnp.float32)
        mp.setattr(torch_model, "COMPUTE_DTYPE", torch.float32)
        lj, gj = jax.jit(jax.value_and_grad(
            lambda p, b: mj.loss(p, b, chunk_tokens=48)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
        mt.use_kernels = False
        try:
            loss = mt.loss({k: torch.from_numpy(v) for k, v in
                            batch.items()}, chunk_tokens=48)
            names = [k for k, _ in mt.named_parameters()]
            gt = dict(zip(names, torch.autograd.grad(
                loss, list(mt.parameters()))))
        finally:
            mt.use_kernels = True
    return (float(lj), params_from_jax(cfg, jax.tree.map(np.asarray, gj)),
            float(loss.detach()), gt)


def assert_grads_close(lj, gj, lt, gt):
    assert abs(lt - lj) <= 1e-5 * abs(lj)
    assert gt.keys() == gj.keys()
    for k in gj:
        scale = max(float(gj[k].abs().max()), 1e-30)
        assert float((gt[k] - gj[k]).abs().max()) <= 1e-4 * scale, k
