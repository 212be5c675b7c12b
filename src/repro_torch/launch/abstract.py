"""Abstract (no-allocation) state for the dry-run, ``repro/launch/
abstract.py`` in PyTorch.

JAX traces its initialisers with ``jax.eval_shape``; the port builds on the
``meta`` device, whose tensors carry a shape and a dtype and no storage,
so a 480 G-parameter model "initialises" in seconds and allocates nothing.
Each function returns (tree of meta tensors, tree of logical axes) with the
same structure; ``parallel.sharding.tree_shardings`` maps the pair onto a
mesh.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs
from repro_torch.models.model import DecoderLM, param_axes
from repro_torch.training.optimizer import Optimizer


def abstract_params(model: DecoderLM) -> Tuple[Dict, Dict]:
    """({state_dict name: meta tensor}, {name: logical axes})."""
    params = {k: torch.empty_like(p, device="meta")
              for k, p in model.named_parameters()}
    return params, param_axes(model)


def abstract_opt_state(opt: Optimizer, params: Dict,
                       axes: Dict) -> Tuple[Dict, Dict]:
    """The optimizer's ``init`` on meta parameters, and its state's axes."""
    meta = {k: torch.empty_like(p, device="meta") for k, p in params.items()}
    return opt.init(meta), opt.state_axes(axes)


def abstract_cache(model: DecoderLM, batch: int, max_len: int
                   ) -> Tuple[Dict, Dict]:
    """``init_cache(batch, max_len)`` of a meta model, and its axes."""
    if model.head.device.type != "meta":
        raise ValueError("abstract_cache needs a model built on the meta "
                         "device")
    return model.init_cache(batch, max_len), model.cache_axes()


def batch_axes(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, tuple]:
    """Logical axes for every entry of ``input_specs(cfg, shape)``."""
    out = {}
    for name, (shp, _) in input_specs(cfg, shape).items():
        if name in ("tokens", "labels"):
            out[name] = ("batch",) + (None,) * (len(shp) - 1)
        elif name in ("frame_emb", "patch_emb"):
            out[name] = ("batch",) + (None,) * (len(shp) - 2) + ("act_embed",)
        else:
            raise KeyError(name)
    return out
