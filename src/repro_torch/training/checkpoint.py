"""Sharded checkpoints with manifests committed through the control plane,
``repro/training/checkpoint.py`` in PyTorch, in the JAX package's format.

Save: every leaf of a nested dict of tensors is written as its own ``.npy``
shard, named by its dotted path (``params.blocks.0.mamba_0.ln.scale``,
``opt.mu.head``, ``opt.step``), then the *manifest* -- step, shard
directory, shard count and digest, and the data cursor -- is committed
through the Fast Flexible Paxos control plane
(``repro_torch.cluster.coordinator.ControlPlane``), or written as the
directory's ``MANIFEST`` file without one.  A checkpoint exists iff its
manifest committed: shards written by a host that died before the commit
are never seen.  The digest is JAX's sampled one: sha256 over each leaf's
name and the first 4096 bytes of its data, in leaf order.

Restore: read the latest manifest, check the digest over the shards (their
first 4096 bytes, read through a memory map) before anything is loaded,
then copy each shard into the caller's template tensor in place, a leaf at
a time -- no second copy of the state is held on the device.  A template
leaf on the ``meta`` device is checked but not loaded: a serving model
restores its parameters without allocating the optimizer's state.
"""
from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.coordinator import ControlPlane

DIGEST_BYTES = 4096


def _leaves(tree: Mapping, prefix: str = ""
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(dotted name, tensor) of every leaf, depth first in sorted key
    order, as JAX flattens a dict."""
    for k, v in sorted(tree.items()):
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, name + ".")
        else:
            yield re.sub(r"[^A-Za-z0-9_.-]", "_", name) or "leaf", v


def _sample(arr: np.ndarray) -> bytes:
    """The first DIGEST_BYTES bytes of arr's C-order data."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return flat[:DIGEST_BYTES].tobytes()


def save(root: str, step: int, state: Mapping, data_cursor: int,
         plane: Optional[ControlPlane] = None, host: int = 0) -> str:
    """Write shards for ``state`` and commit the manifest.  Returns the
    checkpoint's directory."""
    d = os.path.join(root, f"step-{step:08d}")
    os.makedirs(d, exist_ok=True)
    digest = hashlib.sha256()
    n = 0
    for name, leaf in _leaves(state):
        arr = leaf.detach().cpu().numpy()
        np.save(os.path.join(d, name + ".npy"), arr)
        digest.update(name.encode())
        digest.update(_sample(arr))
        n += 1
    shards = {"dir": d, "n_shards": n, "digest": digest.hexdigest()}
    if plane is not None:
        plane.commit_checkpoint(step, shards, data_cursor, host=host)
    else:  # stand-alone mode: the manifest file is the commit point
        with open(os.path.join(d, "MANIFEST"), "w") as f:
            f.write(f"{step} {data_cursor} {n} {digest.hexdigest()}")
    return d


def latest_manifest(root: str, plane: Optional[ControlPlane] = None
                    ) -> Optional[Dict]:
    """The newest committed manifest: the plane's latest checkpoint record,
    or, without a plane, the last ``step-*`` directory of ``root`` (in name
    order) that holds a MANIFEST; None when there is none."""
    if plane is not None:
        return plane.latest_checkpoint()
    best = None
    if not os.path.isdir(root):
        return None
    for name in sorted(os.listdir(root)):
        mf = os.path.join(root, name, "MANIFEST")
        if os.path.exists(mf):
            with open(mf) as f:
                step, cursor, n, dg = f.read().split()
            best = {"step": int(step), "data_cursor": int(cursor),
                    "shards": {"dir": os.path.join(root, name),
                               "n_shards": int(n), "digest": dg}}
    return best


def restore(template: Mapping, manifest: Dict) -> Tuple[Mapping, int, int]:
    """Load a checkpoint into ``template``'s tensors, in place.

    Returns (template, step, data_cursor).  Raises ``ValueError`` before
    touching the template if a shard is missing or not shaped as its
    template leaf, if the checkpoint's shard count is not the template's,
    or if the sampled digest mismatches (a torn or corrupt checkpoint)."""
    d = manifest["shards"]["dir"]
    leaves = list(_leaves(template))
    if len(leaves) != int(manifest["shards"]["n_shards"]):
        raise ValueError(f"checkpoint {d} has {manifest['shards']['n_shards']}"
                         f" shards; the template has {len(leaves)} leaves")
    digest = hashlib.sha256()
    for name, leaf in leaves:
        path = os.path.join(d, name + ".npy")
        if not os.path.exists(path):
            raise ValueError(f"checkpoint shard {path} is missing")
        arr = np.load(path, mmap_mode="r")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shard {name}: shape {arr.shape}, the "
                             f"template's {tuple(leaf.shape)}")
        digest.update(name.encode())
        digest.update(_sample(arr))
        del arr                                   # one mapping at a time
    if digest.hexdigest() != manifest["shards"]["digest"]:
        raise ValueError("checkpoint digest mismatch -- torn or corrupt")
    with torch.no_grad():
        for name, leaf in leaves:
            if leaf.device.type != "meta":
                leaf.copy_(torch.from_numpy(np.load(os.path.join(
                    d, name + ".npy"))))
    return template, int(manifest["step"]), int(manifest["data_cursor"])
