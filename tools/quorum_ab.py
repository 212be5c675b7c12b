"""Device time of tally_decide, masked_tally and race_card_hist built from
several copies of ``quorum_tally.cu``, at the main path's shapes, in one
process on one card.

    python3 tools/quorum_ab.py LABEL=PATH [LABEL=PATH ...] [--rounds 3]

Each PATH is a ``quorum_tally.cu`` (another commit's, say, from a ``git
archive`` unpacked under a git-ignored ``build/``) whose ``qt_tally_decide``
and ``qt_masked_tally`` take the C arguments the port's do.  Each is built
with the port's ``nvcc`` flags.  Then, in rounds, the variants run in order
and reversed (A B C, C B A, ...), each timed by torch.profiler as
``chip_smoke.py`` times a kernel (device microseconds per recorded launch,
20 calls):

- ``tally_decide`` at the n=11 sweep's race chunk: 16384 trials x 11
  acceptors, K = 2, the sweep's draws;
- ``masked_tally`` at the masked race's shape: 8192 trials x 12 acceptors
  against the 39 fast quorum rows of the mixed n=12 batch's 13 systems;
- ``race_card_hist`` (variants that have it, through this tree's wrapper
  with the variant's library) at the sweep chunk of ``chip_smoke.py``'s
  RACE_CARD_CASES: the kernel and its one fill, summed.

Every variant's outputs are held to the plain versions first (equal; the
race chunk's sums within 1e-5 relative).  Prints the card (``nvidia-smi``
name and power limit), the sweep chunk's histogram increments and the
distinct cells they touch (all told, and summed over each column's groups
of 32 consecutive trials: the atomics left when a warp merges equal cells),
then one JSON line per kernel: each variant's device microseconds in every
round and their median.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def bind(path: Path):
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.qt_tally_decide.argtypes = [P, I, I, I, I, P, P, P, P, P]
    lib.qt_tally_decide.restype = I
    lib.qt_masked_tally.argtypes = [P, P, P, I, I, I, I, P, P]
    lib.qt_masked_tally.restype = I
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+",
                    help="LABEL=path/to/quorum_tally.cu")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("quorum_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (RACE_CARD_CASES, kernel_device_us,
                            mixed_members, race_card_inputs)
    from repro_torch.kernels import _build
    from repro_torch.kernels.quorum_tally import kernel, ref
    from repro_torch.montecarlo import engine, rng, streaming

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    variants = dict(v.split("=", 1) for v in args.variants)
    with ThreadPoolExecutor(len(variants)) as ex:  # one nvcc each, at once
        futs = {k: ex.submit(_build.build, Path(p).resolve(),
                             f"quorum_tally_ab_{k}")
                for k, p in variants.items()}
        paths = {k: f.result()[0] for k, f in futs.items()}
    libs = {k: bind(p) for k, p in paths.items()}
    card_libs = {k: kernel.bind(p) for k, p in paths.items()
                 if hasattr(libs[k], "qt_race_card_hist")}

    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    offsets = torch.tensor([0.0, 0.2], device=dev)
    v11 = engine._draw_race(rng.generator(rng.root(11), dev), offsets,
                            streaming.default_delay(), n=11, k_proposers=2,
                            samples=16_384)["votes"]
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device=dev)
    M, G2f, _ = table["p2f_w"].shape
    v12 = engine._draw_race(rng.generator(rng.root(12), dev), offsets,
                            streaming.default_delay(), n=12, k_proposers=2,
                            samples=8192)["votes"]
    w = table["p2f_w"].reshape(M * G2f, 12).contiguous()
    t = table["p2f_t"].reshape(M * G2f).contiguous()

    S, G = v11.shape[0], M * G2f
    counts = torch.empty((S, 2), dtype=torch.int32, device=dev)
    winner = torch.empty(S, dtype=torch.int32, device=dev)
    mx = torch.empty(S, dtype=torch.int32, device=dev)
    reached = torch.empty(S, dtype=torch.bool, device=dev)
    out = torch.empty((v12.shape[0], G), dtype=torch.int32, device=dev)

    def decide(lib):
        return lambda: lib.qt_tally_decide(
            v11.data_ptr(), S, 11, 2, 7, counts.data_ptr(),
            winner.data_ptr(), mx.data_ptr(), reached.data_ptr(), stream)

    def masked(lib):
        return lambda: lib.qt_masked_tally(
            v12.data_ptr(), w.data_ptr(), t.data_ptr(), v12.shape[0], 12, G,
            2, out.data_ptr(), stream)

    want_d = ref.tally_decide(v11, 2, 7)
    want_m = ref.masked_tally(v12, w, t, 2)
    for k, lib in libs.items():
        if decide(lib)() or masked(lib)():
            raise SystemExit(f"quorum_ab: {k}: a launch failed")
        torch.cuda.synchronize()
        for a, b in zip((counts, winner, mx, reached, out),
                        (*want_d, want_m)):
            if not torch.equal(a, b):
                raise SystemExit(f"quorum_ab: {k} differs from the plain "
                                 f"version")

    card_args, card_kw = race_card_inputs(RACE_CARD_CASES[0], dev)
    want_c = ref.race_card_hist(*card_args, **card_kw)
    votes, arrive, classic, valid, pairs = card_args
    groups = 0
    for s0 in range(0, votes.shape[0], 32):
        part = ref.race_card_hist(votes[s0:s0 + 32], arrive[s0:s0 + 32],
                                  classic[s0:s0 + 32], valid[s0:s0 + 32],
                                  pairs, **card_kw)
        groups += int(part[0].count_nonzero()) + int(
            part[4].count_nonzero())
    print(json.dumps({"race_card_hist_sweep_chunk": {
        "increments": int(want_c[0].sum()) + int(want_c[4].sum()),
        "distinct_cells": int(want_c[0].count_nonzero())
        + int(want_c[4].count_nonzero()),
        "distinct_cells_per_32_trials_of_a_column": groups}}), flush=True)

    def card(lib):
        def call():
            kernel._lib = lib                  # the variant's library
            kernel._CARD_PLANS.clear()
            return kernel.race_card_hist(*card_args, **card_kw)
        return call

    for k, lib in card_libs.items():
        for f, a, b in zip(("FH", "Fsum", "Fmax", "cnt", "RH", "Rsum",
                            "Rmax"), card(lib)(), want_c):
            ok = (bool(((a - b).abs() <= 1e-5 * b.abs()).all())
                  if f in ("Fsum", "Rsum") else torch.equal(a, b))
            if not ok:
                raise SystemExit(f"quorum_ab: {k}: race_card_hist {f} "
                                 f"differs from the plain version")

    kerns = {"tally_decide": ("tally_decide_kernel", decide, libs),
             "masked_tally": ("masked_tally_kernel", masked, libs),
             "race_card_hist": (("race_card_kernel", "Memset"), card,
                                card_libs)}
    times = {(kern, k): [] for kern, (_, _, ls) in kerns.items() for k in ls}
    order = list(libs)
    for r in range(args.rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            for kern, (symbol, fn, ls) in kerns.items():
                if k in ls:
                    us = kernel_device_us(fn(ls[k]), symbol, reps=20)[0]
                    times[(kern, k)].append(us)
    for kern, (_, _, ls) in kerns.items():
        print(json.dumps({"kernel": kern, "device_us": {
            k: {"rounds": times[(kern, k)],
                "median": statistics.median(times[(kern, k)])}
            for k in ls}}), flush=True)


if __name__ == "__main__":
    main()
