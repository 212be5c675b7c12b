"""Run one Experiment from the command line.

    python -m repro_torch.api [--config FILE] [--backend B[,B...]]
                              [--device cpu] [--smoke]

Without ``--config``: the quickstart experiment of
``examples/experiment_quickstart.py`` -- the paper-headline cardinality
system, a 3x3 grid embedded in 11 acceptors and a weighted system, under a
2-way race at 0.2 ms, 20,000 samples -- on the montecarlo and des backends,
then the n = 5 batch on the modelcheck backend.  With ``--config``: a
scenario JSON (``examples/scenarios/*.json``) on the montecarlo backend.
``--backend`` picks backends; ``--smoke`` cuts samples, DES requests,
trials and the model checker's state budget for a quick check.  The
montecarlo backend runs on the CUDA card unless ``--device cpu`` is given
(without a card and without ``--device`` the run raises).  Prints one row
per backend and system, then ``api OK``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.core.quorum import (ExplicitQuorumSystem, QuorumSpec,
                                     WeightedQuorumSystem)

from .experiment import BACKENDS, Experiment, Workload

SMOKE_SAMPLES, SMOKE_DES_REQUESTS = 2_000, 200
SMOKE_TRIALS, SMOKE_CHUNK = 20_000, 8_192
SMOKE_MAX_STATES = 20_000


def quickstart(samples: int = 20_000, des_requests: int = 1200,
               device=None) -> Experiment:
    """The three n = 11 systems of the quickstart under a 2-way race."""
    return Experiment(
        systems=[QuorumSpec.paper_headline(11),
                 ExplicitQuorumSystem.grid(3).embed(11),
                 WeightedQuorumSystem((2, 2, 2) + (1,) * 8, 12, 3, 9)],
        workload=Workload.race(k=2, delta_ms=0.2, des_requests=des_requests),
        samples=samples, device=device)


def small_batch(max_states: int = 200_000) -> Experiment:
    """Congruent n = 5 systems for the model checker."""
    return Experiment(systems=[QuorumSpec(5, 4, 2, 4),
                               ExplicitQuorumSystem.grid(1).embed(5),
                               WeightedQuorumSystem((2, 1, 1, 1, 1), 5, 2, 4)],
                      backend="modelcheck", max_states=max_states)


def _row(backend: str, label: str, row: dict) -> str:
    if backend == "modelcheck":
        return (f"[modelcheck] {label:24s} safe={bool(row['safe'])} "
                f"states={int(row['states'])}")
    ft = f" ft_fast={row['ft_phase2_fast']}" if "ft_phase2_fast" in row \
        else ""
    return (f"[{backend}] {label:24s} p50={row['p50_ms']:.3f}ms "
            f"p99={row['p99_ms']:.3f}ms "
            f"p_recovery={row['recovery_rate']:.4f} "
            f"undecided={row['undecided_rate']:.4f}{ft}")


def run(exp: Experiment, backends) -> dict:
    out = {}
    for b in backends:
        t0 = time.perf_counter()
        r = exp.run(b)
        wall = time.perf_counter() - t0
        for label in r.labels:
            print(_row(b, label, r.system(label)), flush=True)
        print(f"[{b}] wall {wall:.3f}s", flush=True)
        out[b] = r
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api")
    ap.add_argument("--config", help="scenario JSON (examples/scenarios)")
    ap.add_argument("--backend", help="comma-separated subset of "
                    f"{','.join(BACKENDS)}")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="cut samples, DES requests, trials and states")
    args = ap.parse_args(argv)
    backends = tuple(args.backend.split(",")) if args.backend else None
    for b in backends or ():
        if b not in BACKENDS:
            ap.error(f"unknown backend {b!r}; pick from {BACKENDS}")
    if args.config:
        exp = Experiment.from_config(args.config, device=args.device)
        if args.smoke and exp.trials is not None:
            exp = dataclasses.replace(
                exp, trials=min(exp.trials, SMOKE_TRIALS),
                chunk=min(exp.chunk, SMOKE_CHUNK))
        res = run(exp, backends or ("montecarlo",))
    else:
        exp = (quickstart(SMOKE_SAMPLES, SMOKE_DES_REQUESTS, args.device)
               if args.smoke else quickstart(device=args.device))
        chosen = backends or BACKENDS
        res = run(exp, [b for b in chosen if b != "modelcheck"])
        if "modelcheck" in chosen:
            res.update(run(small_batch(SMOKE_MAX_STATES if args.smoke
                                       else 200_000), ("modelcheck",)))
    print("api OK", flush=True)
    return res


if __name__ == "__main__":
    main()
