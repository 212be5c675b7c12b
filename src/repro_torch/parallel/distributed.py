"""Multi-process trial mesh: ``torch.distributed`` over gloo and a local
multi-process launcher (``repro.parallel.distributed``; DESIGN.md §10).

A sharded stream's merge (``streaming._mesh_merge``: SUM of counts and
histograms, MAX of maxima, a count-weighted mean summed in global domain
order) is already a valid cross-process reduction.  All a process grid
needs is (a) every process agreeing on the global domain grid and (b)
per-domain work keyed by the global domain index, so a 2-process x
2-domain run and a 1-process x 4-domain run are the same program.  This
module supplies (a); ``parallel.sharding.trial_mesh`` and the streams
derive (b).  The merge moves a few KB to a few MB once a pass, over gloo
on host copies of the summary, on the CPU and on the card alike.

Entry points:

``initialize()``      read coordinator / process count / process id from
                      arguments or the ``REPRO_*`` environment (set by
                      ``launch_local`` and by cluster launch scripts) and
                      join ``torch.distributed`` over gloo.  Idempotent; a
                      no-op for a single process, so callers invoke it
                      unconditionally, before any CUDA work.
``launch_local()``    N local processes x D domains each
                      (``REPRO_DOMAINS_PER_PROCESS``, in place of JAX's
                      forced host devices), coordinated over a free
                      localhost port.
``main()``            ``python -m repro_torch.parallel.distributed launch
                      --processes 2 --devices-per-process 2 -- <cmd...>``
                      runs any command as a cooperating process grid;
                      ``stream`` is the fixed-workload worker that layouts
                      are compared with; ``selftest`` all-reduces the
                      global domain indices.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import sharding

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"
ENV_DOMAINS_PER_PROCESS = sharding.ENV_DOMAINS_PER_PROCESS

INIT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class DistInfo:
    """The process-grid coordinates a multi-process run is keyed by
    (``local_device_count``: this process's trial domains)."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_multiprocess(self) -> bool:
        return self.process_count > 1


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> DistInfo:
    """Join ``torch.distributed`` (gloo, ``tcp://<coordinator>``) from
    arguments or the ``REPRO_*`` environment.

    A single process (no coordinator, or one process) is a no-op, and so
    is a second call; ``device`` (``None`` = the CUDA card) only sizes the
    returned ``DistInfo``.  Call it before any CUDA work: the grid's merge
    runs on host copies, so nothing here touches the card."""
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NUM_PROCESSES, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PROCESS_ID, "0"))
    if coordinator is None or num_processes <= 1 or dist.is_initialized():
        return info(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return info(device)


def info(device=None) -> DistInfo:
    """The current process-grid coordinates for work on ``device``
    (``None`` = the CUDA card)."""
    p, count = sharding.process_grid()
    local = len(sharding.local_devices(device))
    return DistInfo(process_index=p, process_count=count,
                    local_device_count=local,
                    global_device_count=local * count)


# ---------------------------------------------------------------------------
# Local multi-process launcher.
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ``_free_port`` closes the probe socket before process 0 binds the port,
# so another process (another launch, in parallel) can take it in between;
# process 0 then dies with EADDRINUSE.  ``launch_local`` retries the whole
# bring-up on a fresh port when a failing process's output matches these
# markers (gRPC, raw-errno and torch's TCPStore spellings).
EADDRINUSE_MARKERS = ("EADDRINUSE", "address already in use",
                      "Address already in use", "Failed to listen",
                      "failed to listen on any local network address")
LAUNCH_PORT_RETRIES = 3

# After one process fails, the others may wait in a collective for a peer
# that is gone: they get this long to end on their own, then are killed.
_PEER_GRACE_S = 10.0


def _is_addr_in_use(text: str) -> bool:
    return any(m in text for m in EADDRINUSE_MARKERS)


def _src_root() -> str:
    # .../src/repro_torch/parallel/distributed.py -> .../src
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def launch_local(num_processes: int, devices_per_process: int,
                 argv: Sequence[str], *, timeout_s: float = 900.0,
                 port_retries: int = LAUNCH_PORT_RETRIES) -> List[str]:
    """Run ``argv`` as ``num_processes`` cooperating local processes of
    ``devices_per_process`` trial domains each.

    Every process gets ``REPRO_COORDINATOR`` (a free localhost port),
    ``REPRO_NUM_PROCESSES``, ``REPRO_PROCESS_ID`` and
    ``REPRO_DOMAINS_PER_PROCESS``; the command itself calls
    ``initialize()``.  Returns each process's stdout + stderr, in process
    order; raises ``RuntimeError`` with the failing processes' output on a
    non-zero exit or the time limit.  A failure whose output matches
    ``EADDRINUSE_MARKERS`` retries on a fresh port, up to
    ``port_retries`` times."""
    if num_processes < 1 or devices_per_process < 1:
        raise ValueError(f"need at least 1 process and 1 domain, got "
                         f"{num_processes} x {devices_per_process}")
    for attempt in range(port_retries + 1):
        try:
            return _launch_once(num_processes, devices_per_process, argv,
                                timeout_s=timeout_s)
        except RuntimeError as e:
            if attempt < port_retries and _is_addr_in_use(str(e)):
                continue                    # lost the race: fresh port
            raise
    raise AssertionError("unreachable")     # the loop returns or raises


def _launch_once(num_processes: int, devices_per_process: int,
                 argv: Sequence[str], *, timeout_s: float) -> List[str]:
    port = _free_port()
    base = dict(os.environ)
    base[ENV_DOMAINS_PER_PROCESS] = str(devices_per_process)
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")      # every peer is local
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_src_root(), base.get("PYTHONPATH", "")) if p)

    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(num_processes)]
    procs = []
    for i in range(num_processes):
        e = dict(base)
        e[ENV_COORDINATOR] = f"localhost:{port}"
        e[ENV_NUM_PROCESSES] = str(num_processes)
        e[ENV_PROCESS_ID] = str(i)
        procs.append(subprocess.Popen(list(argv), env=e, stdout=logs[i],
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout_s
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if any(p.returncode not in (None, 0) for p in procs):
                deadline = min(deadline, now + _PEER_GRACE_S)
            if now > deadline:
                timed_out = not any(p.returncode not in (None, 0)
                                    for p in procs)
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if timed_out:
        raise RuntimeError(
            f"multi-process launch timed out after {timeout_s:.0f}s; "
            f"process outputs:\n" + "\n---\n".join(outs))
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        blob = "\n---\n".join(f"[proc {i} rc={procs[i].returncode}]\n"
                              f"{outs[i]}" for i in failed)
        raise RuntimeError(f"multi-process launch failed:\n{blob}")
    return outs


# ---------------------------------------------------------------------------
# Fixed-workload stream worker: the layout-comparison probe.
# ---------------------------------------------------------------------------

# ``fixed`` is the JAX package's acceptance workload (paper-headline + Fast
# Paxos at n=11, a 2-way race at 0.2 ms, 50,011 trials, chunk 2048);
# ``sweep`` the n=11 sweep's race pass (all 271 FFP-valid systems, 10^7
# trials, chunk 16384, on the race-pass key of ``score_systems``).
WORKLOADS = ("fixed", "sweep")


def workload(name: str, device, seed: int = 0):
    """(key, table, offsets) of a named worker workload on ``device``."""
    import torch

    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.frontier import cardinality_family
    from repro_torch.montecarlo import engine, rng

    if name == "fixed":
        table = engine.build_mask_table(
            [QuorumSpec.paper_headline(11), QuorumSpec.fast_paxos(11)],
            device=device)
        key = rng.root(seed)
    elif name == "sweep":
        table = engine.build_mask_table(
            [m.masks() for m in cardinality_family(11)], device=device)
        key = rng.derive(rng.root(seed), rng.PASS_DOMAIN, rng.RACE_PASS)
    else:
        raise ValueError(f"unknown workload {name!r}; pick one of "
                         f"{WORKLOADS}")
    offsets = torch.tensor([0.0, 0.2], dtype=torch.float32,
                           device=engine._table_device(table))
    return key, table, offsets


def _stream_worker(out_path: str, *, trials: int, chunk: int, seed: int,
                   precision: float, name: str = "fixed",
                   device=None) -> None:
    """Run a named workload through ``race_stream`` on the global trial
    mesh and, from process 0, write the merged ``StreamSummary``, its
    quantiles, the wall, this process's kernel launches and the grid to
    ``out_path`` (npz)."""
    dinfo = initialize(device=device)
    import numpy as np
    import torch

    from repro_torch import device as device_mod
    from repro_torch.kernels.quorum_tally import ops as qt_ops
    from repro_torch.montecarlo import streaming

    dev = device_mod.resolve(device)
    key, table, offsets = workload(name, dev, seed)
    mesh = sharding.trial_mesh(dev)
    qt_ops.reset_launches()
    t0 = time.perf_counter()
    state = streaming.race_stream(key, table, offsets, n=11, k_proposers=2,
                                  trials=trials, chunk=chunk,
                                  precision=precision, shard=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = dict(qt_ops.LAUNCHES)
    if dinfo.process_index != 0:
        return
    qs = state.quantile([0.5, 0.999, 0.9999]).cpu().numpy()
    host = state.to_numpy()
    np.savez(out_path, **host, p50_ms=qs[0], p999_ms=qs[1], p9999_ms=qs[2],
             wall_s=np.float64(wall),
             race_card_hist_launches=np.int64(
                 launches.get("race_card_hist", 0)),
             process_count=np.int64(dinfo.process_count),
             global_devices=np.int64(mesh.size))


def run_stream_layout(num_processes: int, devices_per_process: int,
                      out_path: str, *, trials: int = 50_011,
                      chunk: int = 2_048, seed: int = 0,
                      precision: float = 0.01, name: str = "fixed",
                      device=None,
                      timeout_s: float = 600.0) -> Dict[str, object]:
    """Launch the stream worker on an (N processes x D domains) local grid
    and return process 0's merged summary as an {name: ndarray} dict.  Any
    two layouts of the same N*D are bit-identical in counts, histogram and
    maxima."""
    import numpy as np
    cmd = [sys.executable, "-m", "repro_torch.parallel.distributed",
           "stream", "--out", out_path, "--trials", str(trials),
           "--chunk", str(chunk), "--seed", str(seed), "--precision",
           str(precision), "--workload", name]
    if device is not None:
        cmd += ["--device", str(device)]
    launch_local(num_processes, devices_per_process, cmd,
                 timeout_s=timeout_s)
    with np.load(out_path) as z:
        return {k: z[k] for k in z.files}


def selftest(device=None, quiet: bool = False) -> bool:
    """All-reduce the global domain indices over the grid: D(D-1)/2."""
    import torch
    dinfo = initialize(device=device)
    mesh = sharding.trial_mesh(device)
    got = int(sharding.all_reduce(
        torch.tensor(sum(g for g, _ in mesh.domains), dtype=torch.int64),
        mesh, "sum"))
    want = mesh.size * (mesh.size - 1) // 2
    if not quiet:
        print(f"proc {dinfo.process_index}/{dinfo.process_count}: "
              f"{mesh.size} global domains, sum(domain index) = {got} "
              f"(want {want}) {'OK' if got == want else 'FAIL'}",
              flush=True)
    return got == want


# ---------------------------------------------------------------------------
# CLI.
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.parallel.distributed",
        description="multi-process trial-mesh launcher / worker")
    sub = ap.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("launch", help="run a command as N local processes "
                                       "x D trial domains each")
    lp.add_argument("--processes", type=int, default=2)
    lp.add_argument("--devices-per-process", type=int, default=4)
    lp.add_argument("--timeout", type=float, default=900.0)
    lp.add_argument("argv", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")

    sp = sub.add_parser("stream", help="fixed-workload race_stream worker "
                                       "(called by run_stream_layout)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--trials", type=int, default=50_011)
    sp.add_argument("--chunk", type=int, default=2_048)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--precision", type=float, default=0.01)
    sp.add_argument("--workload", choices=WORKLOADS, default="fixed")
    sp.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    st = sub.add_parser("selftest", help="probe: all-reduce of the global "
                                         "domain indices across the grid")
    st.add_argument("--quiet", action="store_true")
    st.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")

    args = ap.parse_args(argv)
    if args.cmd == "launch":
        cmd = list(args.argv)
        if cmd and cmd[0] == "--":
            cmd = cmd[1:]
        if not cmd:
            ap.error("launch needs a command after --")
        outs = launch_local(args.processes, args.devices_per_process, cmd,
                            timeout_s=args.timeout)
        for i, o in enumerate(outs):
            sys.stdout.write(f"--- proc {i} ---\n{o}")
        return 0
    if args.cmd == "stream":
        _stream_worker(args.out, trials=args.trials, chunk=args.chunk,
                       seed=args.seed, precision=args.precision,
                       name=args.workload, device=args.device)
        return 0
    return 0 if selftest(args.device, args.quiet) else 1


if __name__ == "__main__":
    sys.exit(main())
