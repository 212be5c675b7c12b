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

Every process of a grid must have the same local count, as in JAX.

The model-rules half (``Rules`` .. ``tree_shardings``, JAX ``:80-238``):
models name each tensor dimension by a *logical* axis, and a rule table maps
each name to a preference list of mesh axes; the first candidate that is
on the mesh, not used by an earlier dimension, and whose size divides the
dimension wins (``spec_for``), else the dimension is replicated.  The mesh
is a plain description, a ``ModelMesh`` (an ordered ``{axis: size}`` and,
for execution, a ``torch.device``), and ``spec_for`` returns a
``PartitionSpec``, a tuple with one entry a dimension: ``None``, or the
winning candidate as the table writes it (a tuple of axis names).
``NamedSharding.shard_shape`` gives one device's shard of a shape.  The
port has no SPMD partitioner: ``constrain`` resolves the spec (unknown
names and wrong ranks raise, as in JAX) and returns its input unchanged,
and only MoE's expert-parallel branch (``models/moe.py``) runs differently
under a mesh, one rank after another.
"""
from __future__ import annotations

import contextlib
import math
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

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


# ---------------------------------------------------------------------------
# Logical-axis rules of the model stack (JAX ``sharding.py:37,80-238``).
# ---------------------------------------------------------------------------

AxisSpec = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of them (sharded over their product)."""

    def __new__(cls, *entries: AxisSpec) -> "PartitionSpec":
        return super().__new__(cls, entries)


def _flat(entry: AxisSpec) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else (entry or ())


@dataclass(frozen=True)
class ModelMesh:
    """A model mesh: its axes in order with their sizes, and the device
    its ranks run on (``None``: the tensors' own).  Building one touches
    no device."""

    axes: Tuple[Tuple[str, int], ...]
    device: Optional[torch.device] = None

    def __post_init__(self) -> None:
        names = [a for a, _ in self.axes]
        if len(set(names)) != len(names) or any(
                int(n) < 1 for _, n in self.axes):
            raise ValueError(f"mesh axes {self.axes}: names must be distinct "
                             f"and sizes >= 1")

    @classmethod
    def of(cls, shape: Mapping[str, int], device=None) -> "ModelMesh":
        dev = None if device is None else torch.device(device)
        return cls(tuple((a, int(n)) for a, n in shape.items()), dev)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)


def axis_size(mesh, spec: AxisSpec) -> int:
    """The number of devices a spec entry spans on ``mesh``."""
    return math.prod(mesh.shape[a] for a in _flat(spec))


@dataclass(frozen=True)
class Rules:
    """logical name -> preference list of mesh axis specs."""
    table: Dict[str, Tuple[AxisSpec, ...]]

    def candidates(self, name: Optional[str]) -> Tuple[AxisSpec, ...]:
        if name is None:
            return (None,)
        if name not in self.table:
            raise KeyError(f"unknown logical axis {name!r}")
        return self.table[name]


def default_rules(sequence_parallel: bool = False,
                  expert_all_to_all: bool = False) -> Rules:
    """JAX's table, entry for entry: batch on ('pod', 'data'), the weights'
    d_model ('embed') on 'data' (FSDP), heads / mlp / experts / vocab on
    'model', activations' d_model and seq replicated unless
    ``sequence_parallel``.  ``expert_all_to_all`` changes nothing, as in
    JAX."""
    t: Dict[str, Tuple[AxisSpec, ...]] = {
        # activations
        "batch": (("pod", "data"), ("data",), None),
        "seq": (("model",), None) if sequence_parallel else (None,),
        "seq_sp": (("model",), None),
        "act_embed": (None,),
        "heads": (("model",), None),
        "kv_heads": (("model",), None),
        "head_dim": (None,),
        "mlp_act": (("model",), None),
        "vocab_act": (("model",), None),
        "cache_seq": (("data", "model"), ("model",), ("data",), None),
        # weights
        "embed": (("data",), None),
        "embed_full": (None,),
        "embed_td": (("model",), None),
        "mlp": (("model",), None),
        "w_heads": (("model",), None),
        "w_kv_heads": (("model",), None),
        "w_vocab": (("model",), None),
        "experts": (("model",),),
        "kv_lora": (None,),
        "ssm_inner": (("model",), None),
        "ssm_state": (None,),
        "conv": (None,),
        "norm": (None,),
    }
    return Rules(t)


class _Ctx(threading.local):
    mesh: Optional[Any] = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[Rules] = None):
    """Activate (mesh, rules) for this thread; ``mesh=None`` clears them."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules or (default_rules() if mesh is not None else None)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh=None, rules: Optional[Rules] = None) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec with divisibility fallback:
    a candidate is skipped when one of its mesh axes is not on the mesh
    (e.g. 'pod' on a single-pod mesh), is already used by an earlier
    dimension, or when its size does not divide the dimension.  ``mesh``
    is anything with an ordered ``.shape`` mapping; without one (nor an
    active one) the spec is empty."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None or rules is None:
        return PartitionSpec()
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims, "
                         f"axes {tuple(axes)} name {len(axes)}")
    mesh_axes = set(mesh.shape.keys())
    used: set = set()
    out = []
    for dim, name in zip(shape, axes):
        chosen: AxisSpec = None
        for cand in rules.candidates(name):
            flat = _flat(cand)
            if any(a not in mesh_axes for a in flat) or any(
                    a in used for a in flat):
                continue
            if cand is not None and dim % axis_size(mesh, cand) != 0:
                continue
            chosen = cand
            break
        used.update(_flat(chosen))
        out.append(chosen)
    return PartitionSpec(*out)


def constrain(x, axes: Sequence[Optional[str]]):
    """Resolve ``x``'s logical sharding under the active mesh (raising as
    ``spec_for`` does) and return ``x`` itself: there is no partitioner."""
    if _CTX.mesh is not None:
        spec_for(x.shape, axes, _CTX.mesh, _CTX.rules)
    return x


def fsdp_use(w: torch.Tensor, axes: Sequence[Optional[str]],
             dtype: torch.dtype) -> torch.Tensor:
    """Cast a weight to its compute dtype, then release its FSDP
    ('embed') dimension to 'embed_full' -- in that order, so that a
    partitioner would gather the cast and not the f32 master copy."""
    w = w.to(dtype)
    if _CTX.mesh is None:
        return w
    return constrain(w, tuple("embed_full" if a == "embed" else a
                              for a in axes))


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: how one tensor lies across the mesh."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's shard of ``shape``: each dimension over the
        product of its entry's mesh axes."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} longer than shape "
                             f"{tuple(shape)}")
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = axis_size(self.mesh, entry)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide over {entry} ({n})")
            out[i] //= n
        return tuple(out)


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   mesh, rules: Optional[Rules] = None) -> NamedSharding:
    return NamedSharding(mesh, spec_for(shape, axes, mesh,
                                        rules or default_rules()))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(tree, tree_axes, mesh, rules: Optional[Rules] = None):
    """A tree of tensors (or anything with ``.shape``) -- dicts keyed by
    ``state_dict`` names, lists, nested -- and a tree of logical-axes
    tuples of the same structure -> the same structure of
    ``NamedSharding``s.  A leaf without a shape (an int) maps to None."""
    rules = rules or default_rules()

    def walk(t, ax):
        if _is_axes(ax):
            shape = getattr(t, "shape", None)
            return (None if shape is None
                    else named_sharding(tuple(shape), ax, mesh, rules))
        if isinstance(t, Mapping):
            if set(t) != set(ax):
                raise ValueError(f"tree keys {sorted(t)} vs axes keys "
                                 f"{sorted(ax)}")
            return {k: walk(v, ax[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if len(t) != len(ax):
                raise ValueError(f"tree of {len(t)} vs axes of {len(ax)}")
            return type(t)(walk(v, a) for v, a in zip(t, ax))
        raise TypeError(f"no axes for a leaf {type(t).__name__}")

    return walk(tree, tree_axes)
