"""Card busy time and wall time of the n=11 sweep's race pass, 40 chunks of
16384 trials, in two versions of the chunk loop, in one process on one card.

    python3 tools/race_chunk_ab.py PARENT_STREAMING_PY [--rounds 3]

PARENT_STREAMING_PY is another commit's ``src/repro_torch/montecarlo/
streaming.py`` (from a ``git archive`` of it unpacked under a git-ignored
``build/``, say).  It is loaded as a sibling module of this tree's
``streaming``, so both versions run on this tree's draws (``engine``) and
kernels; only the chunk loop differs.  In each round the versions run in
order and then reversed (parent, new; new, parent; ...), each pass of 40
chunks as ``chip_smoke.py``'s profile phase times it: after a warm-up pass,
one pass timed by the host clock up to ``torch.cuda.synchronize()``
(wall), then one traced by torch.profiler (busy: the device time of every
kernel, copy and memset; device launches per chunk; the busiest kernels).
The two versions' summaries must agree first: integer fields and maxima
equal, means within 1e-5 relative.

Prints the card (``nvidia-smi`` name and power limit), then one JSON line
per version: its wall and busy milliseconds in every round and their
medians, its launches per chunk and its busiest kernels.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CHUNK, CHUNKS = 16_384, 40


def load_sibling(path: Path, name: str):
    """``path`` as module ``repro_torch.montecarlo.<name>``: its relative
    imports resolve to this tree's modules."""
    full = f"repro_torch.montecarlo.{name}"
    spec = importlib.util.spec_from_file_location(full, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[full] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="the parent's montecarlo/streaming.py")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("race_chunk_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_profile
    from repro_torch.frontier import cardinality_family
    from repro_torch.kernels.quorum_tally import kernel
    from repro_torch.montecarlo import engine, rng, streaming

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernel.build()
    parent = load_sibling(Path(args.parent).resolve(), "parent_streaming")
    dev = torch.device("cuda")
    table = engine.build_mask_table([m.masks() for m in
                                     cardinality_family(11)], device=dev)
    versions = {"parent": parent, "new": streaming}

    def run(mod):
        return mod.race_stream(rng.root(6), table, [0.0, 0.2], n=11,
                               k_proposers=2, trials=CHUNKS * CHUNK,
                               chunk=CHUNK)

    got = {k: run(m) for k, m in versions.items()}
    for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist",
              "max_ms"):
        if not torch.equal(getattr(got["parent"], f), getattr(got["new"], f)):
            raise SystemExit(f"race_chunk_ab: the versions' {f} differ")
    torch.testing.assert_close(got["new"].mean_ms, got["parent"].mean_ms,
                               rtol=1e-5, atol=0.0)

    res = {k: {"wall_ms": [], "busy_ms": []} for k in versions}
    order = list(versions)
    for r in range(args.rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            mod = versions[k]
            run(mod)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(mod)
            torch.cuda.synchronize()
            res[k]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            prof = device_profile(lambda: run(mod), top=6)
            res[k]["busy_ms"].append(prof["device_busy_s"] * 1e3)
            res[k]["launches_per_chunk"] = sum(
                prof["by_kernel_n"].values()) / CHUNKS
            res[k]["top_ms"] = prof["top"]
    for k, v in res.items():
        print(json.dumps({"version": k, "chunks": CHUNKS, **v,
                          "wall_ms_median": statistics.median(v["wall_ms"]),
                          "busy_ms_median": statistics.median(v["busy_ms"])}),
              flush=True)


if __name__ == "__main__":
    main()
