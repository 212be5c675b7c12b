"""Serving launcher of the port: prefill + batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_2_7b
      [--batch 4] [--prompt-len 1024] [--tokens 32] [--layers N] [--smoke]
      [--device cpu] [--dry-run [--shape decode_32k] [--multi-pod]]

Serves the full configuration of any of the ten architectures on the card
-- where every prefill runs the SSD kernel in each Mamba2 layer, flash
attention in each GQA attention block and RMSNorm at every norm -- with
weights from the port's seeded initialiser and a random prompt batch made
from a seed (bf16 frame or patch embeddings for the stub frontends).
``--layers`` keeps the full width and cuts the depth to N layers (a model
whose weights do not fit the card whole); ``--smoke`` serves the reduced
configuration; ``--device cpu`` runs the plain versions on the CPU.
Prints prefill ms and decode tok/s.  ``--dry-run`` instead runs the FULL
configuration's serving cell (``--shape`` decode_32k, long_500k or
prefill_32k) on the production mesh through ``launch.dryrun.lower_cell``
in this process, on the meta device, and prints its record as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.configs import ArchConfig, get_config, reduced_config
from repro_torch.models.model import DecoderLM


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg: ArchConfig, batch: int, prompt_len: int, device,
                 seed: int = 1) -> Dict[str, torch.Tensor]:
    """A request batch of ``prompt_len`` positions, with the keys of JAX's
    ``input_specs`` for a prefill, made from ``seed``: "tokens" (batch,
    prompt_len) int64 ids in [1, vocab); for ``audio_frames`` instead
    "frame_emb" (batch, prompt_len, d_model), for ``vision_patches`` also
    "patch_emb" (batch, vision_tokens, d_model) -- standard normal in
    bf16, as ``training.data.frontend_batch_at`` draws them."""
    gen = torch.Generator().manual_seed(seed)

    def emb(rows):
        return torch.randn((batch, rows, cfg.d_model), generator=gen
                           ).to(torch.bfloat16).to(device)

    if cfg.frontend == "audio_frames":
        return {"frame_emb": emb(prompt_len)}
    out = {"tokens": torch.randint(1, cfg.vocab, (batch, prompt_len),
                                   generator=gen).to(device)}
    if cfg.frontend == "vision_patches":
        out["patch_emb"] = emb(cfg.vision_tokens)
    return out


def prefill_len(batch: Dict[str, torch.Tensor]) -> int:
    """Positions a prefill of ``batch`` fills: the patches and the tokens,
    or the frames."""
    return sum(batch[k].shape[1] for k in ("patch_emb", "frame_emb",
                                           "tokens") if k in batch)


def generate(model: DecoderLM, batch: Dict[str, torch.Tensor],
             n_tokens: int) -> Dict:
    """Prefill ``batch`` (what ``DecoderLM.prefill`` takes: see
    ``prompt_batch``), then ``n_tokens`` greedy decode steps, with a cache
    of ``prefill_len(batch) + n_tokens`` positions.

    Returns the prefill's last-position logits (B, V), the list of each
    decode step's logits (B, V), the greedy tokens (B, n_tokens + 1) -- the
    prefill's pick, then each step's --, the final cache, and the host
    times of the prefill (ms) and of the decode loop (s), each ending in a
    device synchronisation."""
    first = next(iter(batch.values()))
    dev, B = first.device, first.shape[0]
    with torch.inference_mode():
        cache = model.init_cache(B, prefill_len(batch) + n_tokens)
        _sync(dev)
        t0 = time.perf_counter()
        cache, logits = model.prefill(batch, cache)
        nxt = logits[:, -1].argmax(-1)[:, None]
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_logits = logits[:, -1]
        toks, step_logits = [nxt], []
        t0 = time.perf_counter()
        for _ in range(n_tokens):
            logits, cache = model.decode_step(cache, nxt)
            step_logits.append(logits[:, -1])
            nxt = logits[:, -1].argmax(-1)[:, None]
            toks.append(nxt)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return {"prefill_logits": prefill_logits,
            "step_logits": step_logits,
            "tokens": torch.cat(toks, dim=1), "cache": cache,
            "prefill_ms": prefill_ms, "decode_s": decode_s}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (full width)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced configuration")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the full configuration's dry-run record")
    ap.add_argument("--shape", default="decode_32k",
                    help="the dry-run's input shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the dry-run on the 2x16x16 mesh")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch import dryrun
        rec = dryrun.lower_cell(args.arch, args.shape,
                                multi_pod=args.multi_pod)
        print(json.dumps(rec, indent=1))
        return rec
    dev = device_mod.resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
        print(f"[smoke] {args.arch} reduced")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        print(f"[depth] {args.arch} cut to {cfg.n_layers} layers")
    model = DecoderLM(cfg, device=dev, seed=0)
    batch = prompt_batch(cfg, args.batch, args.prompt_len, dev)
    out = generate(model, batch, args.tokens)
    B, P, T = args.batch, prefill_len(batch), args.tokens
    print(f"[prefill] {B}x{P} in {out['prefill_ms']:.1f} ms")
    print(f"[decode] {T} steps x {B} reqs: "
          f"{B * T / out['decode_s']:.0f} tok/s "
          f"({out['decode_s'] * 1e3 / max(T, 1):.2f} ms/step)")
    return out


if __name__ == "__main__":
    main()
