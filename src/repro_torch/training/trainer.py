"""Training loop of the port, ``repro/training/trainer.py`` in PyTorch: the
train-step factory (microbatches, compression, the optimizer) and the
host-level ``Trainer`` that commits checkpoints through the control plane
and resumes from them exactly.

The step differentiates the model's ``loss`` with autograd.  A model for
training is built with ``use_kernels=False`` (its plain code; the card's
kernels have no backward and raise under autograd) and ``remat=True``, as
the JAX package trains with ``use_ssd_kernel=False`` and per-block
``jax.checkpoint``.  ``make_serve_step`` and ``make_prefill`` run the
model under ``torch.inference_mode()``, where a model built with kernels
runs them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from repro_torch.models.model import DecoderLM
from repro_torch.montecarlo import rng as rng_mod

from . import checkpoint as ckpt
from . import compress as compress_mod
from .optimizer import Optimizer, global_norm

Params = Dict[str, torch.Tensor]


def make_train_step(model: DecoderLM, opt: Optimizer,
                    n_microbatches: int = 1,
                    compression: Optional[str] = None) -> Callable:
    """Returns ``train_step(opt_state, residual, batch, generator=None) ->
    (residual, metrics)``, which updates the model's parameters and
    ``opt_state`` in place.

    With ``n_microbatches > 1`` every leaf of ``batch`` has a leading
    microbatch axis, (n_micro, B / n_micro, ...); each microbatch's
    gradients are added to f32 buffers as ``g / n_micro`` and the loss is
    the mean of the microbatches' losses.  ``compression`` ("int8" with
    noise from ``generator``, or "topk") round-trips the gradients with
    error feedback through ``residual`` before the optimizer.  ``metrics``
    holds f32 scalar tensors: ``loss``, ``grad_norm`` (of the gradients the
    optimizer gets, before its clipping) and ``update_norm``."""
    params = dict(model.named_parameters())

    def grads_of(batch):
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def train_step(opt_state, residual, batch, generator=None):
        if n_microbatches == 1:
            loss, grads = grads_of(batch)
        else:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            losses = []
            for i in range(n_microbatches):
                l, g = grads_of({k: v[i] for k, v in batch.items()})
                for k in grads:
                    grads[k] = grads[k] + g[k].float() / n_microbatches
                del g
                losses.append(l)
            loss = torch.stack(losses).mean()

        if compression == "int8":
            grads, residual = compress_mod.int8_compress(grads, residual,
                                                         generator)
        elif compression == "topk":
            grads, residual = compress_mod.topk_compress(grads, residual)
        elif compression is not None:
            raise ValueError(f"compression {compression!r}: int8, topk or "
                             f"None")

        grad_norm = global_norm(grads)
        update_norm = opt.update(grads, opt_state, params)
        return residual, {"loss": loss, "grad_norm": grad_norm,
                          "update_norm": update_norm}

    return train_step


def make_serve_step(model: DecoderLM) -> Callable:
    """serve_step(cache, tokens) -> (logits, cache): one decode step under
    ``torch.inference_mode()``."""

    def serve_step(cache, tokens):
        with torch.inference_mode():
            return model.decode_step(cache, tokens)

    return serve_step


def make_prefill(model: DecoderLM) -> Callable:
    """prefill(cache, batch) -> (cache, logits of the last position), under
    ``torch.inference_mode()``."""

    def prefill(cache, batch):
        with torch.inference_mode():
            return model.prefill(batch, cache)

    return prefill


@dataclass
class TrainerConfig:
    ckpt_dir: str = "build/train_ckpt"
    ckpt_every: int = 50
    n_microbatches: int = 1
    compression: Optional[str] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Host-level loop: the data cursor, checkpoints through the control
    plane, preemption-safe resume.

    ``init()`` makes the optimizer state (and the compression residual)
    for the model's parameters, which the model drew from its seed.  A
    step's int8 rounding noise comes from a generator keyed by (``seed``,
    the step number), as its batch is keyed by the cursor.  A checkpoint
    holds the parameters and the optimizer state, as JAX's does: the
    compression residual starts from zero on a restore.
    ``history`` holds each step's metrics as floats, with ``step_s``, the
    host time of the step ending in a device synchronisation."""

    def __init__(self, model: DecoderLM, opt: Optimizer, pipeline,
                 tcfg: TrainerConfig, plane=None, seed: int = 0):
        self.model = model
        self.opt = opt
        self.pipe = pipeline
        self.tcfg = tcfg
        self.plane = plane
        self.seed = seed
        self.device = next(model.parameters()).device
        self.step_fn = make_train_step(model, opt, tcfg.n_microbatches,
                                       tcfg.compression)
        self.opt_state: Optional[Dict] = None
        self.residual: Optional[Params] = None
        self.step = 0
        self.cursor = 0
        self.history: list = []

    @property
    def params(self) -> Params:
        return dict(self.model.named_parameters())

    def init(self) -> None:
        self.opt_state = self.opt.init(self.params)
        self.residual = (compress_mod.init_residual(self.params)
                         if self.tcfg.compression else None)

    def state(self) -> Dict:
        """What a checkpoint holds: {"params", "opt"}."""
        return {"params": self.params, "opt": self.opt_state}

    def try_restore(self) -> bool:
        manifest = ckpt.latest_manifest(self.tcfg.ckpt_dir, self.plane)
        if manifest is None:
            return False
        _, self.step, self.cursor = ckpt.restore(self.state(), manifest)
        return True

    def save(self) -> None:
        ckpt.save(self.tcfg.ckpt_dir, self.step, self.state(), self.cursor,
                  self.plane)

    def run(self, n_steps: int) -> Dict[str, float]:
        last: Dict[str, float] = {}
        nm = self.tcfg.n_microbatches
        for _ in range(n_steps):
            batch = {k: v.to(self.device)
                     for k, v in self.pipe.batch_at(self.cursor).items()}
            if nm > 1:
                batch = {k: v.reshape((nm, v.shape[0] // nm) + v.shape[1:])
                         for k, v in batch.items()}
            gen = None
            if self.tcfg.compression == "int8":
                gen = rng_mod.generator(rng_mod.derive(
                    rng_mod.root(self.seed), rng_mod.CHUNK_DOMAIN,
                    self.step), self.device)
            _sync(self.device)
            t0 = time.perf_counter()
            self.residual, metrics = self.step_fn(self.opt_state,
                                                  self.residual, batch, gen)
            _sync(self.device)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_s"] = time.perf_counter() - t0
            self.step += 1
            self.cursor += 1
            self.history.append(metrics)
            last = metrics
            if self.tcfg.ckpt_every and self.step % self.tcfg.ckpt_every == 0:
                self.save()
        return last
