"""What decides ``correct``: the program's answers against the reference's.

For each checked request, systems are matched by label, then:

``systems_missing``  labels on one side only (the program scored other
                     systems than the configuration states)
``count_gap``        the largest difference of n_trials, n_fast,
                     n_recovery or n_undecided over the systems (exact)
``hist_gap``         the largest share of a system's decided trials that
                     sit in another sketch bucket than the reference's
                     (half the L1 distance of the histograms over the
                     reference's decided count; exact)
``quantile_gap``     the largest relative difference of a read-out
                     quantile (0.5, 0.99, 0.999) from the reference's

Each number is held to its limit in ``limits.json``; ``PERF.md`` gives the
readings each limit was set from.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

LIMITS: Dict[str, float] = json.loads(
    (Path(__file__).resolve().parent / "limits.json").read_text())


def gaps(labels: Sequence[str], answer: dict, ref_labels: Sequence[str],
         ref: dict) -> Dict[str, float]:
    """The compared numbers of one request."""
    at = {lab: j for j, lab in enumerate(labels)}
    pairs = [(at[lab], i) for i, lab in enumerate(ref_labels) if lab in at]
    out = {"systems_missing": float(len(set(labels) ^ set(ref_labels)))}
    if not pairs:
        return dict(out, count_gap=math.inf, hist_gap=math.inf,
                    quantile_gap=math.inf)
    pj, ri = (np.array(x) for x in zip(*pairs))
    c_p = np.asarray(answer["counts"], np.int64)[:, pj]
    c_r = np.asarray(ref["counts"], np.int64)[:, ri]
    out["count_gap"] = float(np.abs(c_p - c_r).max())
    h_p = np.asarray(answer["hist"], np.int64)[pj]
    h_r = np.asarray(ref["hist"], np.int64)[ri]
    if h_p.shape != h_r.shape:
        out["hist_gap"] = math.inf
    else:
        moved = np.abs(h_p - h_r).sum(axis=1) / 2.0
        out["hist_gap"] = float((moved / np.maximum(h_r.sum(axis=1),
                                                    1)).max())
    q_p = np.asarray(answer["quantiles"], np.float64)[:, pj]
    q_r = np.asarray(ref["quantiles"], np.float64)[:, ri]
    both = np.isnan(q_p) & np.isnan(q_r)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(q_p - q_r) / np.abs(q_r)
    rel = np.where(both, 0.0, np.where(np.isnan(rel), math.inf, rel))
    out["quantile_gap"] = float(rel.max())
    return out


def worst(per_request: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest reading of each number over the checked requests."""
    return {k: max(r[k] for r in per_request) for k in LIMITS}


def verdict(numbers: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and none missing or not a number."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": LIMITS[k]}
              for k in LIMITS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
