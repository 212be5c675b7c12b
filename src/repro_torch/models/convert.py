"""Carry the JAX package's params over to the port's ``DecoderLM``.

``params_from_jax(cfg, tree)`` takes the param pytree of ``repro.models.
model.DecoderLM.init`` with its leaves as numpy arrays (the caller converts
them; this module imports no JAX) and returns the port's ``state_dict``.
JAX stacks each block kind's params over superblocks on a leading axis; the
port keeps one module per superblock, so ``blocks/<key>/<name>`` of shape
(n_superblocks, ...) becomes ``blocks.<i>.<key>.<name>`` for each i.  Every
other leaf -- ``embed``, ``head``, ``final_norm`` and zamba2's unstacked
weight-shared block ``shared/...`` -- keeps its name with dots.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def params_from_jax(cfg: ArchConfig, tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX param pytree (numpy leaves) -> the port's ``state_dict`` (f32)."""
    n_sb = cfg.n_superblocks
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if not name.startswith("blocks."):
            sd[name] = t
            continue
        _, rest = name.split(".", 1)
        if t.shape[0] != n_sb:
            raise ValueError(f"{name}: leading axis {t.shape[0]} is not the "
                             f"{n_sb} superblocks of {cfg.name}")
        for i in range(n_sb):
            sd[f"blocks.{i}.{rest}"] = t[i].clone()
    return sd
