"""Optimizers of the port, ``repro/training/optimizer.py`` in PyTorch:
AdamW and Adafactor on named parameter dicts (a module's
``named_parameters()``), no ``torch.optim``.

    opt = adamw(lr=3e-4)
    state = opt.init(params)                  # f32 tensors mirroring params
    update_norm = opt.update(grads, state, params)

``update`` changes ``params`` and ``state`` in place, one parameter at a
time, so that no second copy of the whole tree is ever held (a full-width
zamba2 has 9.69 GB of f32 params); it returns the global norm of the
updates, the trainer's ``update_norm`` metric.  The arithmetic is JAX's,
in its order: f32 moments, bias corrections ``1 - b**step`` in f32,
``u = -lr_t * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, then ``p + u`` in
p's dtype.  (``torch.optim.AdamW`` applies the decay and the correction
in another order.)  ``step`` is an int32 scalar tensor of the state.

``opt.state_axes(param_axes)`` gives the logical axes of the state from
those of the parameters (``{name: axes}``, ``models.model.param_axes``), so
the parameters' sharding applies to the moments (JAX ``:88,154``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Dict]
    update: Callable[[Params, Dict, Params], torch.Tensor]
    state_axes: Callable[[Dict], Dict]


def apply_updates(params: Params, updates: Params) -> None:
    """``p <- (p + u)`` in p's dtype, for every named parameter, in place."""
    with torch.no_grad():
        for name, p in params.items():
            p.copy_((p + updates[name]).to(p.dtype))


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sum of squares of every leaf, an f32 scalar."""
    return torch.sqrt(_total(torch.sum(torch.square(x.float()))
                             for x in tree.values()))


def _total(terms) -> torch.Tensor:
    """The terms summed one after another, in order."""
    total = None
    for t in terms:
        total = t if total is None else total + t
    return total


def clip_by_global_norm(grads: Params, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _zeros_f32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _step_f32(state: Dict) -> torch.Tensor:
    return state["step"].to(torch.float32)


# ---------------------------------------------------------------------------
# AdamW.
# ---------------------------------------------------------------------------

def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          max_grad_norm: Optional[float] = 1.0,
          schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
          ) -> Optimizer:
    """state = {"step", "mu": {name: f32}, "nu": {name: f32}}.  Grads are
    clipped to ``max_grad_norm`` first (their global norm over all
    parameters), then each parameter is updated on its own."""

    def init(params):
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "mu": {k: _zeros_f32(p) for k, p in params.items()},
                "nu": {k: _zeros_f32(p) for k, p in params.items()}}

    def update(grads, state, params):
        scale = None
        if max_grad_norm is not None:
            norm = global_norm(grads)
            scale = torch.clamp(max_grad_norm / (norm + 1e-9), max=1.0)
        state["step"] += 1
        step = _step_f32(state)
        lr_t = lr if schedule is None else lr * schedule(step)
        bc1 = 1 - b1 ** step
        bc2 = 1 - b2 ** step
        sq = []
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name]
                if scale is not None:
                    g = g * scale.to(g.dtype)
                g = g.float()
                m = b1 * state["mu"][name] + (1 - b1) * g
                v = b2 * state["nu"][name] + (1 - b2) * torch.square(g)
                u = -lr_t * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                             + weight_decay * p.float())
                state["mu"][name].copy_(m)
                state["nu"][name].copy_(v)
                sq.append(torch.sum(torch.square(u)))
                p.copy_((p + u).to(p.dtype))
        return torch.sqrt(_total(sq))

    def state_axes(param_axes):
        return {"step": (), "mu": dict(param_axes), "nu": dict(param_axes)}

    return Optimizer(init, update, state_axes)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments).
# ---------------------------------------------------------------------------

def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def adafactor(lr: float = 1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """state = {"step", "vr": {name: f32}, "vc": {name: f32}}: for a
    parameter of 2 or more axes the row moment (its last axis reduced) and
    the column moment (its second-last reduced), else the full moment and a
    (1,) placeholder.  No global clipping; each update is clipped by its
    own RMS."""

    def init(params):
        vr = {k: _zeros_f32(p, p.shape[:-1] if _factored(p) else None)
              for k, p in params.items()}
        vc = {k: _zeros_f32(p, p.shape[:-2] + p.shape[-1:]
                            if _factored(p) else (1,))
              for k, p in params.items()}
        return {"step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params)),
                "vr": vr, "vc": vc}

    def update(grads, state, params):
        state["step"] += 1
        beta = 1.0 - _step_f32(state) ** (-decay)
        sq = []
        with torch.no_grad():
            for name, p in params.items():
                g = grads[name].float()
                vr, vc = state["vr"][name], state["vc"][name]
                g2 = torch.square(g) + eps
                if _factored(g):
                    nvr = beta * vr + (1 - beta) * g2.mean(-1)
                    nvc = beta * vc + (1 - beta) * g2.mean(-2)
                    r = nvr / torch.clamp(nvr.mean(-1, keepdim=True),
                                          min=eps)
                    pre = r[..., None] * nvc[..., None, :]
                    u = g * torch.rsqrt(torch.clamp(pre, min=eps))
                    vc.copy_(nvc)
                else:
                    nvr = beta * vr + (1 - beta) * g2
                    u = g * torch.rsqrt(torch.clamp(nvr, min=eps))
                vr.copy_(nvr)
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                u = -lr * (u + weight_decay * p.float())
                sq.append(torch.sum(torch.square(u)))
                p.copy_((p + u).to(p.dtype))
        return torch.sqrt(_total(sq))

    def state_axes(param_axes):
        """A factored parameter's row moment drops its last axis, its
        column moment its second-last; a 1-axis parameter's full moment
        keeps its axes and its (1,) placeholder is replicated.  The port
        factors each superblock's own tensor, so these follow the port's
        state, not JAX's stacked one."""
        return {"step": (),
                "vr": {k: ax[:-1] if len(ax) >= 2 else ax
                       for k, ax in param_axes.items()},
                "vc": {k: ax[:-2] + ax[-1:] if len(ax) >= 2 else (None,)
                       for k, ax in param_axes.items()}}

    return Optimizer(init, update, state_axes)


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


def cosine_schedule(warmup: int, total: int, floor: float = 0.1):
    """step (f32 tensor) -> linear warm-up to 1 over ``warmup`` steps, then
    a cosine from 1 to ``floor`` at ``total``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return warm * cos
    return fn
