"""The full FFP-valid quorum space on n=11 as a streamed Pareto frontier.

All 271 (q1, q2c, q2f) triples that Eqs. 13/14 admit at n=11 stream through
one fast pass and one race pass of ``score_systems`` -- 10^7 trials each
(10^6 under ``--smoke``), chunks of 16384 -- and reduce to the Pareto set of
the six frontier axes.  The sweep checks itself against independent code:

  * the family equals a brute-force triple loop over Eqs. 13/14;
  * every quorum-size-minimal spec is on the frontier;
  * fast p50 is monotone in q2f along the frontier;
  * p50 and P(recovery) of three frontier specs agree with a plain per-spec
    estimate on draws of their own, within Monte-Carlo tolerance.

``--relaxed`` adds the joint 396-system FFP + Relaxed Paxos frontier under
both collision-recovery rules, and checks that the fast path and
P(recovery) do not depend on the rule.

Usage:  PYTHONPATH=src python -m repro_torch.frontier [--smoke] [--relaxed]
                                                      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core.quorum import QuorumSpec, ffp_card_ok
from repro_torch.frontier import (cardinality_family, relaxed_family,
                                  score_systems)
from repro_torch.frontier.score import AXIS_NAMES
from repro_torch.montecarlo import rng

N = 11
TRIALS = 10_000_000
TRIALS_SMOKE = 1_000_000
CHUNK = 16_384
DELTA_MS = 0.2
LEGACY_SAMPLES = 50_000
CHECK_SEED = 1234


# ---------------------------------------------------------------------------
# Independent per-spec reference: plain order statistics on draws of its
# own, sharing no code with the engine.
# ---------------------------------------------------------------------------

def _legacy_one_way(gen: torch.Generator, shape, base=0.25, mu=-1.20,
                    sigma=0.55) -> torch.Tensor:
    z = torch.randn(shape, generator=gen, device=gen.device)
    return base + torch.exp(mu + sigma * z)


def _legacy_fast_p50(gen: torch.Generator, n: int, q2f: int,
                     samples: int) -> float:
    d = _legacy_one_way(gen, (samples, n)) + _legacy_one_way(gen, (samples, n))
    return float(torch.quantile(torch.sort(d, dim=-1).values[:, q2f - 1],
                                0.5))


def _legacy_recovery_prob(gen: torch.Generator, spec: QuorumSpec,
                          delta_ms: float, samples: int) -> float:
    t_a = _legacy_one_way(gen, (samples, spec.n))
    t_b = delta_ms + _legacy_one_way(gen, (samples, spec.n))
    b_cnt = (t_b < t_a).sum(dim=-1)
    a_cnt = spec.n - b_cnt
    return float((~((a_cnt >= spec.q2f) | (b_cnt >= spec.q2f))).double()
                 .mean())


def enumerate_valid(n: int = N) -> List[QuorumSpec]:
    """Brute-force triple loop over Eqs. 13/14."""
    return [QuorumSpec(n, q1, q2c, q2f)
            for q1 in range(1, n + 1) for q2c in range(1, n + 1)
            for q2f in range(1, n + 1) if ffp_card_ok(n, q1, q2c, q2f)]


def minimal_frontier(specs: List[QuorumSpec]) -> List[QuorumSpec]:
    """Specs not dominated in (q1, q2c, q2f): larger quorums are never
    better on any scored axis."""
    keep = []
    for s in specs:
        if not any(o.q1 <= s.q1 and o.q2c <= s.q2c and o.q2f <= s.q2f
                   and (o.q1, o.q2c, o.q2f) != (s.q1, s.q2c, s.q2f)
                   for o in specs):
            keep.append(s)
    return keep


def run_sweep(quick: bool = False, seed: int = 0, device=None) -> Dict:
    """The n=11 sweep with its checks; raises AssertionError on a failed
    check.  Returns the result, the CSV rows and the per-pass rates."""
    dev = device_mod.resolve(device)
    trials = TRIALS_SMOKE if quick else TRIALS
    legacy_samples = 5_000 if quick else LEGACY_SAMPLES
    members = cardinality_family(N)
    specs = [m.system for m in members]
    if ({(s.q1, s.q2c, s.q2f) for s in specs}
            != {(s.q1, s.q2c, s.q2f) for s in enumerate_valid(N)}):
        raise AssertionError("cardinality_family differs from the "
                             "brute-force enumeration")
    result = score_systems(members, trials=trials, chunk=CHUNK,
                           delta_ms=DELTA_MS, seed=seed, device=dev)
    rows = [("sweep.n_valid_configs", len(members)),
            ("sweep.trials", trials),
            ("sweep.fast_trials_per_sec", trials / result.wall_s["fast"]),
            ("sweep.race_trials_per_sec", trials / result.wall_s["race"]),
            ("sweep.n_frontier_systems", len(result.frontier_indices))]
    for i in result.frontier_indices:
        row = result.row(i)
        rows += [(f"sweep.[{result.labels[i]}].{a}", row[a])
                 for a in AXIS_NAMES]

    # streamed vs the independent per-spec reference.
    check = rng.root(CHECK_SEED)
    tol_rec = 4.5 * (0.5 / legacy_samples) ** 0.5
    front = result.frontier_indices
    for i in (front[0], front[len(front) // 2], front[-1]):
        s = specs[i]
        row = result.row(i)
        old_p50 = _legacy_fast_p50(
            rng.generator(rng.derive(check, rng.CHUNK_DOMAIN, i), dev),
            s.n, s.q2f, legacy_samples)
        old_rec = _legacy_recovery_prob(
            rng.generator(rng.derive(check, rng.CHUNK_DOMAIN, 100 + i), dev),
            s, DELTA_MS, legacy_samples)
        if abs(old_p50 - row["fast_p50_ms"]) >= 0.05:
            raise AssertionError(f"{s.label}: fast p50 {row['fast_p50_ms']} "
                                 f"vs per-spec {old_p50}")
        if abs(old_rec - row["p_recovery"]) >= tol_rec:
            raise AssertionError(f"{s.label}: P(recovery) "
                                 f"{row['p_recovery']} vs per-spec {old_rec}")
    rows.append(("sweep.streamed_vs_perspec_checked", 3))

    minimal = {(s.q1, s.q2c, s.q2f) for s in minimal_frontier(specs)}
    scored = {(specs[i].q1, specs[i].q2c, specs[i].q2f) for i in front}
    if not minimal <= scored:
        raise AssertionError(f"minimal specs off the frontier: "
                             f"{sorted(minimal - scored)}")
    rows.append(("sweep.minimal_subset_of_frontier", len(minimal)))

    by_q2f = sorted(front, key=lambda i: specs[i].q2f)
    lats = [result.row(i)["fast_p50_ms"] for i in by_q2f]
    if not all(a <= b + 0.05 for a, b in zip(lats, lats[1:])):
        raise AssertionError(f"fast p50 not monotone in q2f: {lats}")
    return {"result": result, "rows": rows, "trials": trials}


def run_relaxed(quick: bool = False, seed: int = 0, device=None) -> Dict:
    """Joint FFP + Relaxed frontier under both collision-recovery rules."""
    dev = device_mod.resolve(device)
    trials = TRIALS_SMOKE if quick else TRIALS
    ffp = cardinality_family(N)
    members = ffp + relaxed_family(N)
    coord = score_systems(members, trials=trials, chunk=CHUNK,
                          delta_ms=DELTA_MS, seed=seed, device=dev)
    front = coord.frontier_indices
    on_front = [i for i in front if i >= len(ffp)]
    if not on_front:
        raise AssertionError("no relaxed-valid/FFP-invalid system on the "
                             "joint frontier")
    uncoord = score_systems(members, trials=trials, chunk=CHUNK,
                            delta_ms=DELTA_MS, seed=seed, device=dev,
                            recovery="uncoordinated")
    cv, uv = np.asarray(coord.values), np.asarray(uncoord.values)
    for a in ("fast_p50_ms", "p_recovery"):
        k = AXIS_NAMES.index(a)
        if not np.array_equal(cv[:, k], uv[:, k]):
            raise AssertionError(f"{a} depends on the recovery rule")
    rows = [("relaxed.n_joint_systems", len(members)),
            ("relaxed.trials", trials),
            ("relaxed.race_trials_per_sec", trials / coord.wall_s["race"]),
            ("relaxed.n_frontier_systems", len(front)),
            ("relaxed.n_relaxed_on_frontier", len(on_front)),
            ("relaxed.rule_invariants_checked", 2)]
    i = on_front[0]
    rows.append((f"relaxed.[{coord.labels[i]}].race_p999_ms.uncoordinated",
                 uncoord.row(i)["race_p999_ms"]))
    return {"coordinated": coord, "uncoordinated": uncoord, "rows": rows}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.frontier")
    ap.add_argument("--smoke", action="store_true",
                    help="10^6 streamed trials per pass instead of 10^7")
    ap.add_argument("--relaxed", action="store_true",
                    help="also run the joint FFP + Relaxed Paxos frontier "
                         "under both collision-recovery rules")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run_sweep(quick=args.smoke, device=args.device)
    rows = out["rows"]
    if args.relaxed:
        rows = rows + run_relaxed(quick=args.smoke,
                                  device=args.device)["rows"]
    for name, val in rows:
        print(f"{name},{val:.6g}")


if __name__ == "__main__":
    main()
