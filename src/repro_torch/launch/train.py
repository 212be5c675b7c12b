"""Training launcher of the port (``repro/launch/train.py`` in PyTorch).

  PYTHONPATH=src python -m repro_torch.launch.train --arch <id> [--steps N]
      [--seq 128] [--batch 4] [--microbatches M] [--compression int8|topk]
      [--ckpt-dir DIR] [--smoke] [--device cpu]
      [--dry-run [--shape train_4k] [--multi-pod]]

On the card it trains the FULL configuration (the counterpart of the JAX
launcher's full run on a TPU slice); ``--smoke``, or ``--device cpu``,
trains the reduced configuration -- the same train step, optimizer,
checkpoint and control-plane path, small.  The model runs its plain code
under autograd (``DecoderLM(use_kernels=False, remat=True)``; the card's
kernels have no backward).  The control plane (Fast Flexible Paxos, n=11)
commits the checkpoint manifests and data cursors.  Stub frontends are
dropped, and the backbone trains on token batches, as the JAX launcher
does.  ``--dry-run`` runs the FULL configuration's cell (``--shape``) on
the production mesh through ``launch.dryrun.lower_cell`` in this process,
on the meta device, and prints its record as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.cluster.coordinator import ControlPlane
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.quorum import QuorumSpec
from repro_torch.models.model import DecoderLM
from repro_torch.training.data import DataConfig, SyntheticPipeline
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced configuration")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the full configuration's dry-run record")
    ap.add_argument("--shape", default="train_4k",
                    help="the dry-run's input shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the dry-run on the 2x16x16 mesh")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default=None,
                    choices=[None, "int8", "topk"])
    ap.add_argument("--ckpt-dir", default="build/train_ckpt")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' trains the reduced "
                         "configuration with the plain versions")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch import dryrun
        rec = dryrun.lower_cell(args.arch, args.shape,
                                multi_pod=args.multi_pod)
        print(json.dumps(rec, indent=1))
        return rec
    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke or dev.type == "cpu":
        cfg = reduced_config(cfg)
        print(f"[smoke] {args.arch} reduced to d_model={cfg.d_model} "
              f"n_layers={cfg.n_layers} vocab={cfg.vocab}")
    if cfg.frontend:
        print(f"[note] {args.arch} uses a stub frontend ({cfg.frontend}); "
              "the smoke loop trains the backbone on token batches.")
        cfg = dataclasses.replace(cfg, frontend=None)

    model = DecoderLM(cfg, device=dev, seed=0, remat=True, use_kernels=False)
    pipe = SyntheticPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    plane = ControlPlane(QuorumSpec.paper_headline(11), seed=0)
    tr = Trainer(model, adamw(lr=1e-3, schedule=cosine_schedule(
        warmup=10, total=1000)), pipe,
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=10,
                      n_microbatches=args.microbatches,
                      compression=args.compression),
        plane=plane)
    tr.init()
    if tr.try_restore():
        print(f"[resume] restored step {tr.step} cursor {tr.cursor}")
    n_params = sum(p.numel() for p in model.parameters())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"[train] {n_params / 1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}, on {where}")
    for _ in range(args.steps):
        m = tr.run(1)
        if tr.step % 5 == 0:
            print(f"  step {tr.step:4d} loss {m['loss']:.4f} "
                  f"grad_norm {m['grad_norm']:.3f} "
                  f"({m['step_s'] * 1e3:.0f} ms)")
    tr.save()
    print(f"[done] final loss {m['loss']:.4f}; "
          f"manifest committed via control plane "
          f"(step {plane.latest_checkpoint()['step']})")
    return tr


if __name__ == "__main__":
    main()
