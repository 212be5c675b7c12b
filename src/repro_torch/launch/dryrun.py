"""Dry-run of the port: every (architecture x input shape) cell on the
production mesh, built and run on the ``meta`` device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3_12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--device-bytes N] [--jobs N] [--out build/dryrun]

The JAX package lowers and compiles each cell for 512 placeholder TPU
devices (``repro/launch/dryrun.py``); PyTorch has no such compiler.  Its
counterpart here, a cell at a time (``lower_cell``):

* the abstract state on ``meta`` (``launch/abstract.py``): parameters,
  the optimizer's state (train) or the KV / SSM cache (prefill, decode),
  and the inputs (``configs.input_specs``), microbatched for train as
  ``(n_micro, B / n_micro, ...)``;
* ``memory``: each device's shard bytes of the step's arguments and
  outputs on the mesh, from the same logical-axis rules
  (``parallel.sharding``), the donated state aliased, as JAX's
  ``memory_analysis`` reports them; ``fits`` holds ``per_device_total``
  against ``--device-bytes`` (default: the card's memory; null without a
  card);
* the trace (``trace``): the cell's step run on meta tensors at full size
  under the mesh's ``sharding_ctx`` (attention's head padding, MoE's
  expert-parallel ranks) and ``torch.utils.flop_counter.FlopCounterMode``
  -- the prefill, one decode step over a ``seq_len``-deep cache, or for
  train one microbatch's loss and backward with remat (the body the step
  runs ``n_micro`` times) -- as the proof that the program's shapes hold,
  with ``cost.model_flops`` (every matrix product, remat's recompute
  included) and its seconds.

Records keep JAX's keys (``arch, shape, mesh, chips, status, reason,
optimizer, n_microbatches, memory``) and go to ``<out>/<arch>.<shape>.
{single,multi}.json``; the exit code is 1 if any cell fails.  With
``--both-meshes`` the 2 x 16 x 16 cells are not traced (their program is
the 16 x 16 one with another batch split); alone, every cell is.  A
trace is host work in one Python thread; ``--jobs N`` runs N cells at a
time in worker processes (``run_cells``), the largest first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing
import os
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (ARCH_IDS, SHAPES, ArchConfig,
                                      ShapeSpec, get_config, input_specs)
from repro_torch.launch.abstract import (abstract_cache, abstract_opt_state,
                                         abstract_params, batch_axes)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import DecoderLM
from repro_torch.parallel.sharding import (default_rules, sharding_ctx,
                                           tree_shardings)
from repro_torch.training import optimizer as opt_mod

NOTES = (
    "temp_size_in_bytes is null: no compiler reports a device's activation "
    "temporaries; the meta trace runs the global program.",
    "collectives, raw_scanned, hlo_bytes and the roofline come from the "
    "JAX package's benchmarks/roofline.py, which the port leaves out.",
    "argument bytes: the cache's pos is a Python int (JAX: a 4-byte int32 "
    "scalar).",
)
ADAFACTOR_NOTE = (
    "argument bytes: Adafactor factors each superblock's tensor; JAX "
    "factors a stacked 1-axis leaf (n_superblocks, d) as a matrix.")


def choose_optimizer(cfg: ArchConfig):
    """AdamW by default; Adafactor for the O(100B) MoE (opt-state memory)."""
    if cfg.param_count() > 1e11:
        return opt_mod.adafactor(lr=1e-2), "adafactor"
    return opt_mod.adamw(lr=3e-4), "adamw"


def microbatch_policy(cfg: ArchConfig) -> int:
    """Grad-accumulation factor for train_4k, by d_model (JAX's)."""
    if cfg.d_model >= 3000:
        return 8
    if cfg.d_model >= 1500:
        return 4
    return 2


def default_device_bytes() -> Optional[int]:
    """The card's memory, or None without one."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return None


def sharded_bytes(tree, axes, mesh, rules) -> int:
    """Bytes of one device's shards of every tensor of ``tree``."""
    shardings = tree_shardings(tree, axes, mesh, rules)

    def walk(t, s):
        if isinstance(t, torch.Tensor):
            return math.prod(s.shard_shape(t.shape)) * t.element_size()
        if isinstance(t, dict):
            return sum(walk(v, s[k]) for k, v in t.items())
        if isinstance(t, (list, tuple)):
            return sum(walk(v, x) for v, x in zip(t, s))
        return 0

    return walk(tree, shardings)


def _meta_inputs(specs: Dict, ids=torch.int64) -> Dict[str, torch.Tensor]:
    """Meta tensors of ``input_specs``; ids as ``ids`` (the port's data
    pipeline gives int64)."""
    return {k: torch.empty(shp, dtype=ids if not dt.is_floating_point
                           else dt, device="meta")
            for k, (shp, dt) in specs.items()}


def _memory(model: DecoderLM, cfg: ArchConfig, shape: ShapeSpec, mesh,
            rules, opt, n_micro: int) -> Dict[str, Any]:
    """Per-device argument, output and alias bytes of the cell's step."""
    p_abs, p_axes = abstract_params(model)
    specs = input_specs(cfg, shape)
    b_axes = batch_axes(cfg, shape)
    if shape.is_train and n_micro > 1:
        specs = {k: ((n_micro, shp[0] // n_micro) + shp[1:], dt)
                 for k, (shp, dt) in specs.items()}
        b_axes = {k: (None,) + ax for k, ax in b_axes.items()}
    inputs = _meta_inputs(specs, torch.int32)
    p_bytes = sharded_bytes(p_abs, p_axes, mesh, rules)
    in_bytes = sharded_bytes(inputs, b_axes, mesh, rules)
    if shape.is_train:           # params and optimizer state donated
        o_abs, o_axes = abstract_opt_state(opt, p_abs, p_axes)
        state = p_bytes + sharded_bytes(o_abs, o_axes, mesh, rules)
        args, out, alias = state + in_bytes, state, state
    else:                        # the cache donated; logits (B,1,V) out
        c_abs, c_axes = abstract_cache(model, shape.global_batch,
                                       shape.seq_len)
        cache = sharded_bytes(c_abs, c_axes, mesh, rules)
        logits = torch.empty((shape.global_batch, 1, cfg.vocab),
                             dtype=torch.bfloat16, device="meta")
        args, alias = p_bytes + cache + in_bytes, cache
        out = cache + sharded_bytes(logits, ("batch", "seq", "vocab_act"),
                                    mesh, rules)
    return {"argument_size_in_bytes": args, "output_size_in_bytes": out,
            "alias_size_in_bytes": alias, "temp_size_in_bytes": None,
            "per_device_total": args - alias + out}


def _trace(model: DecoderLM, cfg: ArchConfig, shape: ShapeSpec, mesh,
           rules, n_micro: int) -> Dict[str, Any]:
    """The cell's step on meta tensors at full size under the mesh: its
    matrix-product flops and seconds."""
    specs = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    with sharding_ctx(mesh, rules), FlopCounterMode(display=False) as fc:
        if shape.is_train:
            specs = {k: ((shp[0] // n_micro,) + shp[1:], dt)
                     for k, (shp, dt) in specs.items()}
            params = [p for p in model.parameters()]
            loss = model.loss(_meta_inputs(specs))
            torch.autograd.grad(loss, params)
        else:
            with torch.no_grad():
                cache = model.init_cache(B, S)
                if shape.kind == "prefill":
                    model.prefill(_meta_inputs(specs), cache)
                else:
                    cache["pos"] = S - 1
                    model.decode_step(cache,
                                      _meta_inputs(specs)["tokens"])
    return {"model_flops": fc.get_total_flops(),
            "trace_s": time.perf_counter() - t0}


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               rules=None, extra: Optional[Dict[str, Any]] = None,
               trace: bool = True,
               device_bytes: Optional[int] = None) -> Dict[str, Any]:
    """One (arch, shape, mesh) cell's record.  ``extra`` replaces fields
    of the configuration; ``device_bytes`` (default
    ``default_device_bytes()``) is what ``fits`` holds the per-device
    total against."""
    cfg = get_config(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    shape = SHAPES[shape_name]
    ok, why = cfg.supports_shape(shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
    }
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = rules or default_rules()
    opt, opt_name = choose_optimizer(cfg)
    rec["optimizer"] = opt_name
    n_micro = microbatch_policy(cfg) if shape.is_train else 1
    rec["n_microbatches"] = n_micro
    t0 = time.perf_counter()
    model = DecoderLM(cfg, device="meta", remat=shape.is_train,
                      use_kernels=False)
    rec["memory"] = _memory(model, cfg, shape, mesh, rules, opt, n_micro)
    rec["abstract_s"] = time.perf_counter() - t0
    device_bytes = (default_device_bytes() if device_bytes is None
                    else device_bytes)
    rec["device_bytes"] = device_bytes
    rec["fits"] = (None if device_bytes is None else
                   rec["memory"]["per_device_total"] <= device_bytes)
    notes = list(NOTES) + ([ADAFACTOR_NOTE] if opt_name == "adafactor"
                           else [])
    if trace:
        t = _trace(model, cfg, shape, mesh, rules, n_micro)
        rec["cost"] = {"model_flops": t["model_flops"]}
        rec["trace_s"] = t["trace_s"]
        notes.append("cost.model_flops: every matrix product of the "
                     "global program on meta tensors "
                     "(torch.utils.flop_counter), remat's recompute "
                     "included" + ("; one microbatch's loss and backward, "
                                   "run n_microbatches times a step"
                                   if shape.is_train else ""))
    else:
        notes.append("not traced: memory from the abstract state only")
    rec["notes"] = notes
    rec["status"] = "ok"
    return rec


def summary_line(rec: Dict[str, Any], tag: str) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        mem = rec["memory"]["per_device_total"] / 2 ** 30
        extra = f" mem/dev={mem:.2f}GiB fits={rec['fits']}"
        if "cost" in rec:
            extra += (f" flops={rec['cost']['model_flops']:.3e}"
                      f" trace={rec['trace_s']:.1f}s")
    elif status == "skipped":
        extra = f" ({rec['reason'][:60]})"
    else:
        extra = f" ERROR {rec['error'][:120]}"
    return f"[{status:7s}] {tag}{extra}"


def _cell(arch: str, shape: str, multi_pod: bool, trace: bool,
          device_bytes: Optional[int]) -> Dict[str, Any]:
    """``lower_cell``, an exception turned into an ``error`` record."""
    try:
        return lower_cell(arch, shape, multi_pod=multi_pod, trace=trace,
                          device_bytes=device_bytes)
    except Exception as e:
        return {"arch": arch, "shape": shape, "status": "error",
                "mesh": "2x16x16" if multi_pod else "16x16",
                "error": repr(e), "traceback": traceback.format_exc()}


def run_cells(cells: Sequence[Tuple[str, str, bool, bool]],
              jobs: int = 1, device_bytes: Optional[int] = None,
              on_record=None) -> List[Dict[str, Any]]:
    """The records of ``cells`` ((arch, shape, multi_pod, trace) each), in
    their order.  ``jobs`` > 1 runs them in that many worker processes
    (spawned: a parent that holds a CUDA context cannot fork), the traced
    cells of the largest models first.  ``on_record(cell, rec)`` is called
    as each record arrives."""
    recs: List[Optional[Dict[str, Any]]] = [None] * len(cells)
    if jobs <= 1:
        for i, c in enumerate(cells):
            recs[i] = _cell(*c, device_bytes)
            if on_record:
                on_record(c, recs[i])
        return recs
    cost = {a: get_config(a).param_count() for a in {c[0] for c in cells}}
    order = sorted(range(len(cells)), key=lambda i: (
        -cells[i][3], -(cells[i][1] == "train_4k"), -cost[cells[i][0]]))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(jobs, mp_context=ctx) as ex:
        futs = {ex.submit(_cell, *cells[i], device_bytes): i for i in order}
        for f in futs:
            i = futs[f]
            recs[i] = f.result()
            if on_record:
                on_record(cells[i], recs[i])
    return recs


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device-bytes", type=int, default=None,
                    help="per-device memory 'fits' is held to (default: "
                         "the card's; none without a card)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at a time, in worker processes")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp, not (mp and args.both_meshes))
             for a, s in pairs for mp in meshes]
    device_bytes = (default_device_bytes() if args.device_bytes is None
                    else args.device_bytes)
    os.makedirs(args.out, exist_ok=True)

    def write(cell, rec):
        tag = f"{cell[0]}.{cell[1]}.{'multi' if cell[2] else 'single'}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(summary_line(rec, tag), flush=True)

    recs = run_cells(cells, args.jobs, device_bytes, write)
    return 1 if any(r["status"] == "error" for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
