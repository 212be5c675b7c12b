"""Run one cell of the benchmark for one run and print its result line.

    python3 ffpbench/run.py --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its configuration
(``configs/<config>.json``) and traffic mix (``traffic/<mix>.json``) are
found by name.  Set-up builds the program's mask table and warms up one
request of the cell's own shape.  The window is a closed loop with one
client: request i, on ``keys.request_key(seed, i)``, is one streamed pass
over every system (``sut.Program``) and its readout on the host; the next
is sent when it is answered, until ``--seconds`` have passed.  After the
window a sample of the requests, drawn from the seed, is worked out again
by the plain reference (``reference.py``) and compared (``compare.py``).

With ``--trace 1`` the first ``TRACE_SECONDS`` of the window run under
``torch.profiler`` and every readout is timed after a synchronise; the line
then carries the per-layer metrics (``metrics/<name>.py``) and a breakdown.

The run needs a CUDA card (as many as the cell asks for) and the program's
sources beside this folder (``src/repro_torch``); without either it exits
non-zero and prints no result.  Nothing here imports JAX or the JAX package,
and once the window has closed the run refuses to print a result if either
was loaded (``loaded_forbidden``).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "ffpbench"
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
CHECKED_REQUESTS = 3
TRACE_SECONDS = 2.0


def _environment() -> None:
    """Fixed cache directories inside the checkout, and the program's
    sources on the path."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its configuration, traffic
    mix, chips, and the names and units of the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((root / files[w["config"]]).read_text())
    traffic = json.loads(
        (root / "ffpbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if int(traffic.get("clients", 1)) != 1:
        raise ValueError(f"{w['traffic']}: the loop has one client, not "
                         f"{traffic['clients']}")
    if int(traffic["trials_per_request"]) <= int(traffic["chunk"]):
        # the program answers a request of one chunk through its
        # materializing entry, drawn from the key itself; the reference
        # works out the chunked stream only
        raise ValueError(f"{w['traffic']}: a request needs more than one "
                         f"chunk")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    e2e = [m["name"] for m in bench["end_to_end"] if mine(m)]
    layer = [m["name"] for m in bench["per_layer"]
             if mine(m) and m["moves"] in e2e]
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return {"name": name, "chips": int(w["chips"]), "config": config,
            "traffic": traffic, "end_to_end": e2e, "per_layer": layer,
            "units": units}


def loaded_forbidden(modules=None) -> list:
    """Top-level names of ``modules`` (``sys.modules`` by default) that the
    benchmark may not load, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({k.split(".")[0] for k in names} & set(FORBIDDEN))


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def cell_shapes(cell: dict) -> dict:
    """The shapes the per-layer readers count work from."""
    from ffpbench import reference, systems
    tr = cell["traffic"]
    recs = systems.reference_systems(cell["config"])
    return {"name": cell["name"], "pass": tr["pass"],
            "n": int(cell["config"]["n"]), "systems": len(recs),
            "k_proposers": int(tr["k_proposers"]), "chunk": int(tr["chunk"]),
            "trials_per_request": int(tr["trials_per_request"]),
            "chunks_per_request": -(-int(tr["trials_per_request"])
                                    // int(tr["chunk"])),
            "bins": reference.sketch_bins(float(tr["precision"])),
            "rows": [tuple(r[ph][0].shape[0] for ph in ("p1", "p2c", "p2f"))
                     for r in recs]}


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool,
             device, t0: float = None, make_program=None,
             setup_split: dict = None) -> dict:
    """Set up, run the window, check the sampled answers and read the
    metrics; returns the result line as a dict.  ``make_program(config,
    traffic, device)`` builds what the window drives (the program by
    default).  ``setup_split`` holds the seconds of set-up spent before
    the call (imports, the CUDA context); the program's import, its table
    and the warm-up are added to it."""
    import torch
    from torch.profiler import record_function

    from ffpbench import compare, keys, metrics, trace
    from ffpbench.reference import Reference
    from ffpbench.sut import Program

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    config, traffic = cell["config"], cell["traffic"]
    prog = (make_program or Program)(config, traffic, dev)
    split = dict(setup_split or {}, **getattr(prog, "timings", {}))
    tw = time.perf_counter()
    prog.readout(prog.stream(keys.warmup_key(seed)))
    sync()
    setup_s = time.perf_counter() - t0
    split["warmup_s"] = time.perf_counter() - tw

    pick = random.Random(keys.root(seed))
    sample, latencies, readouts = [], [], []
    prof = trace.Profiler() if trace_on else None
    traced = 0
    if prof is not None:
        prof.start()
    i, w0 = 0, time.perf_counter()
    while True:
        span = record_function if trace_on else (
            lambda _: contextlib.nullcontext())
        ta = time.perf_counter()
        with span("ffpbench.stream"):
            s = prog.stream(keys.request_key(seed, i))
        if trace_on:
            sync()
            tr = time.perf_counter()
        with span("ffpbench.readout"):
            q, c = prog.readout(s)
        tb = time.perf_counter()
        latencies.append(tb - ta)
        if trace_on:
            readouts.append(tb - tr)
        # reservoir sample, kept on the host: a summary held on the card
        # changes the allocator's layout for every later request, by which
        # ones the seed picks (on an H100, up to 6 % of trials_per_s)
        j = len(sample) if len(sample) < CHECKED_REQUESTS else (
            pick.randrange(i + 1))
        if j < CHECKED_REQUESTS:
            kept = (i, {"quantiles": q, "counts": c, "hist": prog.hist(s)})
            if j == len(sample):
                sample.append(kept)
            else:
                sample[j] = kept
        i += 1
        if prof is not None and not traced and tb - w0 >= TRACE_SECONDS:
            prof.stop()
            traced = i
        if tb - w0 >= seconds:
            break
    window_s = tb - w0
    if prof is not None and not traced:
        prof.stop()
        traced = i
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    shapes = cell_shapes(cell)
    record = {"cell": shapes, "setup_s": setup_s, "latencies_s": latencies,
              "window_s": window_s,
              "trials": i * shapes["trials_per_request"],
              "readout_s": readouts, "trace": None,
              "device": {"kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu")}}
    if prof is not None:
        rec = prof.records()
        record["trace"] = dict(rec, requests=traced,
                               chunks=traced * shapes["chunks_per_request"],
                               trials=traced * shapes["trials_per_request"])

    # the check: the sampled answers against the reference, once the
    # program's state is freed
    labels = list(prog.labels)
    answers = sorted(sample, key=lambda x: x[0])
    del sample, s
    prog.close()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(config, traffic, dev)
    per = [compare.gaps(labels, a, ref.labels,
                        ref.request(keys.request_key(seed, j)))
           for j, a in answers]
    correct, checks = compare.verdict(compare.worst(per))
    failed = sum(not compare.verdict(p)[0] for p in per)

    names = cell["per_layer"] if trace_on else cell["end_to_end"]
    out = {}
    for name in names:
        v = metrics.read(name, record)
        if v is not None:
            out[name] = {"value": v, "unit": cell["units"][name]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": record["device"]["kind"],
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": i, "failed": failed,
              "metrics": out, "device": device_info}
    if record["trace"] is not None and record["trace"]["spans"]:
        rt = record["trace"]
        w = trace.window(rt["spans"])
        busy = trace.busy_intervals(trace.in_window(rt["device"], w), w)
        device_info["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        device_info["window_s"] = (w[1] - w[0]) * 1e-6
        if cuda:
            device_info["power_limit_w"] = _power_limit_w()
        result["breakdown"] = trace.breakdown(rt)
    result["setup_split"] = split
    result["checks"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]} for k, v in checks.items()}
    return result


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    cell = load_cell(args.workload)
    import torch
    t_import = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"ffpbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has {have}. No result.",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda:0")             # the CUDA context
    torch.cuda.synchronize()
    split = {"imports_s": t_import - T0,
             "context_s": time.perf_counter() - t_import}
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t0=T0, setup_split=split)
    found = loaded_forbidden()
    if found:
        print(f"ffpbench: the run loaded {found}, which the benchmark may "
              f"not load. No result.", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                              result["setup_split"].items()), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
