"""Device time of tally_votes, tally_decide, masked_tally and
race_card_hist built from several copies of ``quorum_tally.cu``, at the
main path's shapes (and tally_votes and masked_tally also at a large
shape), in one process on one card.

    python3 tools/quorum_ab.py LABEL=PATH [LABEL=PATH ...] [--rounds 3]

Each PATH is a ``quorum_tally.cu`` (another commit's, say, from a ``git
archive`` unpacked under a git-ignored ``build/``; or a file that defines
a variant's macro and includes one) whose ``qt_tally_votes`` and
``qt_tally_decide`` take the C arguments the port's do.  Each is built
with the port's ``nvcc`` flags.  Then, in rounds, the variants run in order
and reversed (A B C, C B A, ...), each timed by torch.profiler as
``chip_smoke.py`` times a kernel (device microseconds per recorded launch,
20 calls):

- ``tally_votes`` at ``ops.quorum_reached``'s shape, the n=11 sweep's race
  chunk (16384 trials x 11 acceptors, K = 2, the sweep's draws), and at
  2^20 x 11;
- ``tally_decide`` at the same 16384 x 11;
- ``masked_tally`` at the masked race's shape (8192 trials x 12 acceptors
  against the 39 fast quorum rows of the mixed n=12 batch's 13 systems)
  and at 65,536 x 12 against the same rows.  Sources with
  ``qt_masked_plan`` run through this tree's wrapper with the variant's
  library; older ones through their own C arguments;
- ``race_card_hist`` (sources with this tree's C entry points, through
  its wrapper with the variant's library) at the sweep chunk of
  ``chip_smoke.py``'s RACE_CARD_CASES: the kernel and its one fill,
  summed.

Every variant's outputs are held to the plain versions first at every shape
(equal; the race chunk's sums within 1e-5 relative), unless ``--probe``
(variants that cut a part of a kernel out, to see where its time goes).
Prints the card
(``nvidia-smi`` name and power limit), the sweep chunk's histogram
increments and the distinct cells they touch (all told, and summed over
each column's groups of 32 consecutive trials: the atomics left when a warp
merges equal cells), then one JSON line per kernel and shape: each
variant's device microseconds in every round and their median, and the
shape's bound (bytes once over 3.35 TB/s).
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
    lib.qt_tally_votes.argtypes = [P, I, I, I, P, P]
    lib.qt_tally_votes.restype = I
    lib.qt_tally_decide.argtypes = [P, I, I, I, I, P, P, P, P, P]
    lib.qt_tally_decide.restype = I
    if not hasattr(lib, "qt_masked_plan"):  # the C arguments before it
        lib.qt_masked_tally.argtypes = [P, P, P, I, I, I, I, P, P]
        lib.qt_masked_tally.restype = I
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+",
                    help="LABEL=path/to/quorum_tally.cu")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--probe", action="store_true",
                    help="skip the checks against the plain versions: for "
                         "variants that cut parts of a kernel out, to see "
                         "where its time goes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("quorum_ab: CUDA is not available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (HBM_BYTES_PER_S, RACE_CARD_CASES,
                            kernel_device_us, mixed_members,
                            race_card_inputs)
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
    # sources with this tree's C entry points run through its wrappers
    new_libs = {k: kernel.LIB.bind(p) for k, p in paths.items()
                if hasattr(libs[k], "qt_masked_plan")}

    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    offsets = torch.tensor([0.0, 0.2], device=dev)

    def draw(n, samples, seed):
        return engine._draw_race(rng.generator(rng.root(seed), dev), offsets,
                                 streaming.default_delay(), n=n,
                                 k_proposers=2, samples=samples)["votes"]

    v11, v11_large = draw(11, 16_384, 11), draw(11, 2 ** 20, 14)
    v12, v12_large = draw(12, 8192, 12), draw(12, 65_536, 15)
    table = engine.build_mask_table([m.masks(12) for m in mixed_members()],
                                    device=dev)
    M, G2f, _ = table["p2f_w"].shape
    w = table["p2f_w"].reshape(M * G2f, 12).contiguous()
    t = table["p2f_t"].reshape(M * G2f).contiguous()
    G = M * G2f

    S = v11.shape[0]
    counts = torch.empty((S, 2), dtype=torch.int32, device=dev)
    winner = torch.empty(S, dtype=torch.int32, device=dev)
    mx = torch.empty(S, dtype=torch.int32, device=dev)
    reached = torch.empty(S, dtype=torch.bool, device=dev)
    outs = {}

    def votes_out(v, cols):
        key = (v.data_ptr(), cols)
        if key not in outs:
            outs[key] = torch.empty((v.shape[0], cols), dtype=torch.int32,
                                    device=dev)
        return outs[key]

    def tally(v):
        return lambda lib: lambda: lib.qt_tally_votes(
            v.data_ptr(), v.shape[0], v.shape[1], 2,
            votes_out(v, 2).data_ptr(), stream)

    def decide(lib):
        return lambda: lib.qt_tally_decide(
            v11.data_ptr(), S, 11, 2, 7, counts.data_ptr(),
            winner.data_ptr(), mx.data_ptr(), reached.data_ptr(), stream)

    def masked(v):
        def make(lib):
            if k_of[id(lib)] in new_libs:   # this tree's wrapper
                nl = new_libs[k_of[id(lib)]]

                def call():
                    kernel.LIB.use(nl)              # the variant's library
                    return kernel.masked_tally(v, w, t, 2)
                return call
            out = votes_out(v, G)
            return lambda: lib.qt_masked_tally(
                v.data_ptr(), w.data_ptr(), t.data_ptr(), v.shape[0], 12, G,
                2, out.data_ptr(), stream)
        return make

    k_of = {id(lib): k for k, lib in libs.items()}

    def result(fn, v, cols):
        r = fn()
        if isinstance(r, torch.Tensor):
            return r
        if r:
            raise SystemExit("quorum_ab: a launch failed")
        return votes_out(v, cols)

    for k, lib in ({} if args.probe else libs).items():
        for v in (v11, v11_large):
            got = result(tally(v)(lib), v, 2)
            torch.cuda.synchronize()
            if not torch.equal(got, ref.tally_votes(v, 2)):
                raise SystemExit(f"quorum_ab: {k}: tally_votes "
                                 f"{tuple(v.shape)} differs from the plain "
                                 f"version")
        for v in (v12, v12_large):
            got = result(masked(v)(lib), v, G)
            torch.cuda.synchronize()
            if not torch.equal(got, ref.masked_tally(v, w, t, 2)):
                raise SystemExit(f"quorum_ab: {k}: masked_tally "
                                 f"{tuple(v.shape)} differs from the plain "
                                 f"version")
        if decide(lib)():
            raise SystemExit(f"quorum_ab: {k}: a launch failed")
        torch.cuda.synchronize()
        for a, b in zip((counts, winner, mx, reached),
                        ref.tally_decide(v11, 2, 7)):
            if not torch.equal(a, b):
                raise SystemExit(f"quorum_ab: {k}: tally_decide differs "
                                 f"from the plain version")

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
            kernel.LIB.use(lib)                # the variant's library
            return kernel.race_card_hist(*card_args, **card_kw)
        return call

    for k, lib in ({} if args.probe else new_libs).items():
        for f, a, b in zip(("FH", "Fsum", "Fmax", "cnt", "RH", "Rsum",
                            "Rmax"), card(lib)(), want_c):
            ok = (bool(((a - b).abs() <= 1e-5 * b.abs()).all())
                  if f in ("Fsum", "Rsum") else torch.equal(a, b))
            if not ok:
                raise SystemExit(f"quorum_ab: {k}: race_card_hist {f} "
                                 f"differs from the plain version")

    def nbytes(v, cols):          # votes read once, outputs written once
        return 4 * v.numel() + 4 * v.shape[0] * cols

    # (label, device symbol, variant -> call, variants, bytes once)
    kerns = [
        ("tally_votes 16384x11", "tally_votes_kernel", tally(v11), libs,
         nbytes(v11, 2)),
        (f"tally_votes {v11_large.shape[0]}x11", "tally_votes_kernel",
         tally(v11_large), libs, nbytes(v11_large, 2)),
        ("tally_decide 16384x11", "tally_decide_kernel", decide, libs,
         4 * v11.numel() + 16 * S + S),
        (f"masked_tally 8192x12 x {G} rows", "masked_tally_kernel",
         masked(v12), libs, nbytes(v12, G) + 4 * w.numel() + 4 * G),
        (f"masked_tally {v12_large.shape[0]}x12 x {G} rows",
         "masked_tally_kernel", masked(v12_large), libs,
         nbytes(v12_large, G) + 4 * w.numel() + 4 * G),
        ("race_card_hist sweep chunk", ("race_card_kernel", "Memset"), card,
         new_libs, None),
    ]
    times = {(label, k): [] for label, _, _, ls, _ in kerns for k in ls}
    order = list(libs)
    for r in range(args.rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            for label, symbol, fn, ls, _ in kerns:
                if k in ls:
                    us = kernel_device_us(fn(ls[k]), symbol, reps=20)[0]
                    times[(label, k)].append(us)
    for label, _, _, ls, b in kerns:
        print(json.dumps({"kernel": label, "bound_us": (
            None if b is None else b / HBM_BYTES_PER_S * 1e6),
            "device_us": {k: {"rounds": times[(label, k)],
                              "median": statistics.median(
                                  times[(label, k)])} for k in ls}}),
              flush=True)


if __name__ == "__main__":
    main()
