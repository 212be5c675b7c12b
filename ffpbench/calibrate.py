"""Readings the limits of ``limits.json`` are set from, on the card, at a
cell's own size (the benchmark's runs never call this).

    python3 ffpbench/calibrate.py --workload <cell> --seeds 12 --control 3

For each seed, the program answers the requests a run checks (as many as
``run.CHECKED_REQUESTS``, on the run's keys) and the reference works them
out again: the compared numbers of sound runs, whose largest is the lower
reading.  Then the control (``control.py``: the reference in the program's
place, delays carried in bfloat16) answers the same requests on its first
seeds: its smallest number that fails is the upper reading.  Prints one
JSON line: every seed's numbers and, for each number, the largest sound and
the smallest control reading.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]

from ffpbench import compare, keys, run  # noqa: E402


def readings(make, cell, seeds, device, ref, known):
    """Each seed's compared numbers; ``known`` caches the reference's
    answers by key."""
    out = {}
    side = make(cell["config"], cell["traffic"], device)
    for seed in seeds:
        per = []
        for i in range(run.CHECKED_REQUESTS):
            key = keys.request_key(seed, i)
            h = side.stream(key)
            q, c = side.readout(h)
            if key not in known:
                known[key] = ref.request(key)
            per.append(compare.gaps(side.labels, {
                "quantiles": q, "counts": c, "hist": side.hist(h)},
                ref.labels, known[key]))
        out[str(seed)] = compare.worst(per)
    side.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args(argv)
    run._environment()
    import torch
    from ffpbench.control import Control
    from ffpbench.reference import Reference
    from ffpbench.sut import Program
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cell = run.load_cell(args.workload)
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    ref = Reference(cell["config"], cell["traffic"], dev)
    t = time.perf_counter()
    known = {}
    sound = readings(Program, cell, seeds, dev, ref, known)
    t_sound = time.perf_counter() - t
    control = readings(Control, cell, seeds[:args.control], dev, ref,
                       known)
    summary = {k: {"lower": max(v[k] for v in sound.values()),
                   "upper": min(v[k] for v in control.values()),
                   "limit": compare.LIMITS[k]} for k in compare.LIMITS}
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(dev),
                      "sound_s": t_sound, "summary": summary,
                      "sound": sound, "control": control}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
