"""Quorum-system kinds a configuration lists under ``"systems"``.

Each kind is a module of its own, found by the entry's ``"kind"``, with two
functions over the entry and the cluster size ``n``:

``port(entry, n)``
    the program's labelled members (``repro_torch.frontier.Member``), built
    with the program's own constructors; imports the program inside.
``reference(entry, n)``
    the same systems worked out again from the entry alone, as plain
    records: ``{"label", "card": (q1, q2c, q2f) or None, "p1", "p2c",
    "p2f"}``, each phase a pair of (G, n) float64 weights and (G,)
    thresholds.  Nothing of the program is imported.

The two sides are matched by label.  A new kind is a new module here.
"""
from typing import List

import numpy as np

from ffpbench import find


def kind(name: str):
    return find.piece("systems", name)


def port_members(config: dict) -> list:
    out = []
    for entry in config["systems"]:
        out.extend(kind(entry["kind"]).port(entry, config["n"]))
    return out


def reference_systems(config: dict) -> List[dict]:
    out = []
    for entry in config["systems"]:
        out.extend(kind(entry["kind"]).reference(entry, config["n"]))
    labels = [s["label"] for s in out]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate system labels in {config['name']}")
    return out


def card_record(label: str, n: int, q1: int, q2c: int, q2f: int) -> dict:
    """A cardinality system: one all-ones row a phase."""
    ones = np.ones((1, n))
    return {"label": label, "card": (q1, q2c, q2f),
            "p1": (ones, np.array([q1], float)),
            "p2c": (ones, np.array([q2c], float)),
            "p2f": (ones, np.array([q2f], float))}


def rows_record(label: str, n: int, phases: dict) -> dict:
    """A system given as quorum rows: ``phases[ph]`` a list of (weights
    over the first acceptors, threshold); acceptors past the weights'
    length join no quorum."""
    rec = {"label": label, "card": None}
    for ph in ("p1", "p2c", "p2f"):
        w = np.zeros((len(phases[ph]), n))
        t = np.zeros(len(phases[ph]))
        for g, (wg, tg) in enumerate(phases[ph]):
            w[g, :len(wg)] = wg
            t[g] = tg
        rec[ph] = (w, t)
    return rec
