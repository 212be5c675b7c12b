"""Carry trees between the JAX package's layout and the port's ``DecoderLM``.

``params_from_jax(cfg, tree)`` takes the param pytree of ``repro.models.
model.DecoderLM.init`` -- or any tree shaped like it: gradients, AdamW's
``mu``/``nu``, Adafactor's ``vr``/``vc`` with their reduced trailing axes --
with its leaves as numpy arrays (the caller converts them; this module
imports no JAX) and returns it keyed by the port's ``state_dict`` names.
JAX stacks each block kind's params over superblocks on a leading axis; the
port keeps one module per superblock, so ``blocks/<key>/<name>`` of shape
(n_superblocks, ...) becomes ``blocks.<i>.<key>.<name>`` for each i.  Every
other leaf -- ``embed``, ``head``, ``final_norm`` and zamba2's unstacked
weight-shared block ``shared/...`` -- keeps its name with dots.  The
MoE (``ffn/router``, ``ffn/wi``, ``ffn/shared/wi``, ...), MLA
(``attn/wdkv``, ``attn/wuk``, ...) and audio-stub (no ``embed``) trees
carry by the same rule.  ``params_to_jax(cfg, sd)`` is the inverse: it
stacks the superblocks again and nests the names, numpy leaves out.

JAX's Adafactor factors a stacked leaf as one tensor, so for a leaf that is
1-D a superblock its ``vr`` is (n_superblocks,) and its ``vc`` (d,): that
state has no counterpart a superblock (the ``vr`` would split into scalars,
the ``vc`` raises ``ValueError``); the port's Adafactor factors each
superblock's own tensor.
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
    """JAX param-shaped pytree (numpy leaves) -> the port's ``state_dict``
    names, f32 tensors."""
    n_sb = cfg.n_superblocks
    sd: Dict[str, torch.Tensor] = {}
    for name, arr in _flatten(tree).items():
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if not name.startswith("blocks."):
            sd[name] = t
            continue
        _, rest = name.split(".", 1)
        if t.ndim == 0 or t.shape[0] != n_sb:
            raise ValueError(f"{name}: leading axis {tuple(t.shape[:1])} is "
                             f"not the {n_sb} superblocks of {cfg.name}")
        for i in range(n_sb):
            sd[f"blocks.{i}.{rest}"] = t[i].clone()
    return sd


def params_to_jax(cfg: ArchConfig, sd: Mapping[str, torch.Tensor]
                  ) -> Dict[str, object]:
    """The port's ``state_dict``-named tensors -> JAX's nested pytree with
    each block kind's leaves stacked over superblocks (numpy leaves)."""
    n_sb = cfg.n_superblocks
    flat: Dict[str, np.ndarray] = {}
    stacked: Dict[str, list] = {}
    for name, t in sd.items():
        arr = t.detach().cpu().numpy()
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            stacked.setdefault(f"blocks.{rest}", [None] * n_sb)[int(i)] = arr
        else:
            flat[name] = arr
    for name, arrs in stacked.items():
        if any(a is None for a in arrs):
            raise ValueError(f"{name}: not every one of the {n_sb} "
                             f"superblocks of {cfg.name} is given")
        flat[name] = np.stack(arrs)
    tree: Dict[str, object] = {}
    for name, arr in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree
