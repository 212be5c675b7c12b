"""The Monte-Carlo trial mesh (the trial half of ``repro.parallel.sharding``).

The JAX package lays the trial axis over a 1-D ``Mesh`` of every process's
devices and runs one per-device body under ``shard_map``.  Here the mesh
is a plain description, a ``TrialMesh``: the global domain count D and
this process's domains, each a (global index, ``torch.device``) pair with
global index ``process_index * local_count + local_index`` (process-major,
as JAX enumerates ``jax.devices()``).  The streams run their domains one
after another (``montecarlo/streaming.py``, the port of JAX's per-device
body) and merge them; a process grid merges across processes over gloo.

A process's local domains:

  ``REPRO_DOMAINS_PER_PROCESS`` set   that many domains on the caller's
                                      device (``launch_local`` sets it; the
                                      counterpart of JAX's forced host
                                      devices)
  otherwise, on the card              one domain per visible CUDA device
  otherwise, on the CPU               one domain

Every process of a grid must have the same local count, as in JAX.  The
model-rules half of the JAX module (``Rules`` .. ``tree_shardings``) is
not ported.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import device as device_mod

# Mesh axis name of the Monte-Carlo trial dimension (JAX's ``TRIAL_AXIS``).
TRIAL_AXIS = "trials"

ENV_DOMAINS_PER_PROCESS = "REPRO_DOMAINS_PER_PROCESS"


def process_grid() -> Tuple[int, int]:
    """(process index, process count) of the joined ``torch.distributed``
    group, (0, 1) when there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class TrialMesh:
    """D trial domains, of which this process runs ``domains``.

    ``domains`` holds (global index, device) pairs in global order;
    ``shape[TRIAL_AXIS]`` is D, as on a JAX mesh."""

    size: int
    domains: Tuple[Tuple[int, torch.device], ...]
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self) -> None:
        idx = [g for g, _ in self.domains]
        if self.size < 1 or not self.domains:
            raise ValueError(f"a trial mesh needs at least one domain, got "
                             f"size {self.size} with {len(idx)} local")
        if idx != sorted(set(idx)) or idx[0] < 0 or idx[-1] >= self.size:
            raise ValueError(f"local domain indices {idx} must be distinct, "
                             f"ascending and in [0, {self.size})")
        if self.process_count > 1 and not (dist.is_available()
                                           and dist.is_initialized()):
            raise ValueError("a mesh over several processes needs "
                             "repro_torch.parallel.distributed.initialize()")

    @property
    def shape(self) -> dict:
        return {TRIAL_AXIS: self.size}

    @property
    def local_count(self) -> int:
        return len(self.domains)


def _device(device) -> torch.device:
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device=None) -> Tuple[torch.device, ...]:
    """This process's domain devices for work on ``device`` (``None`` = the
    CUDA card), by the rules of the module docstring."""
    dev = _device(device)
    env = os.environ.get(ENV_DOMAINS_PER_PROCESS)
    if env:
        count = int(env)
        if count < 1:
            raise ValueError(f"{ENV_DOMAINS_PER_PROCESS}={env}: need >= 1")
        return (dev,) * count
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def trial_mesh(device=None, domains: Optional[int] = None) -> TrialMesh:
    """The global trial mesh: every process's domains (``local_devices``,
    or ``domains`` of them on ``device`` when given).  A single process
    sees only its own, so the same construction covers both."""
    devs = (local_devices(device) if domains is None
            else (_device(device),) * int(domains))
    if not devs:
        raise ValueError("no domain: a trial mesh needs at least one")
    p, count = process_grid()
    local = len(devs)
    return TrialMesh(size=local * count,
                     domains=tuple((p * local + i, d)
                                   for i, d in enumerate(devs)),
                     process_index=p, process_count=count)


def all_reduce(x: torch.Tensor, mesh: TrialMesh, op: str) -> torch.Tensor:
    """``x`` reduced over every process of ``mesh`` (``op`` "sum" or
    "max"), through a host copy over gloo; ``x`` itself for one process."""
    if mesh.process_count == 1:
        return x
    host = x.detach().cpu().contiguous().clone()
    dist.all_reduce(host, op={"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX}[op])
    return host.to(x.device)
