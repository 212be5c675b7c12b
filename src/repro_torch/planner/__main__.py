"""CLI for the planner service (``python -m repro.planner`` in PyTorch;
DESIGN.md §11).

  python -m repro_torch.planner serve [--host H] [--port P]
      [--batch-window S] [--device D]
      run the persistent search-and-serve process on the CUDA card (or
      ``--device cpu``: the kernels' plain versions); prints one
      ``planner: listening on H:P`` line once the socket is bound
      (``--port 0`` picks a free port — watch that line for the choice).

  python -m repro_torch.planner query [--host H] [--port P] (--json
      '{...}' | query flags)
      send one JSON request to a running server (this package's or the
      JAX package's: the wire format is shared) and print the reply.
      ``--op stats|ping|shutdown`` for the control verbs.

  python -m repro_torch.planner plan (query flags) [--device D]
      one-shot in-process planning — same query surface, no server.

Query flags (query/plan): --n, --family, --trials, --objective,
--faults FAST,PHASE1,CLASSIC, --workload-k, --workload-delta-ms,
--chunk, --precision, --seed.
"""
from __future__ import annotations

import argparse
import json
import sys


def _add_query_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--n", type=int, default=11)
    p.add_argument("--family", default="cardinality",
                   help="cardinality | grid | weighted | all")
    p.add_argument("--trials", type=int, default=None,
                   help="final successive-halving budget "
                        "(default 10^6; 10^5 with --quick)")
    p.add_argument("--objective", default="race_p999_ms",
                   help="race_p999_ms | fast_p50_ms | p_recovery")
    p.add_argument("--faults", default="0,0,0", metavar="F,P1,C",
                   help="minimum crash budgets fast,phase1,classic")
    p.add_argument("--workload-k", type=int, default=2,
                   help="racing proposers (race workload)")
    p.add_argument("--workload-delta-ms", type=float, default=0.2)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--precision", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="10^5 final trials (smoke scale)")


def _query_dict(args) -> dict:
    try:
        f_fast, f_p1, f_classic = (int(x) for x in args.faults.split(","))
    except ValueError:
        raise SystemExit(f"--faults wants FAST,PHASE1,CLASSIC integers, "
                         f"got {args.faults!r}")
    trials = args.trials
    if trials is None:
        trials = 100_000 if args.quick else 1_000_000
    q = {"n": args.n, "family": args.family, "trials": trials,
         "objective": args.objective,
         "faults": {"fast": f_fast, "phase1": f_p1, "classic": f_classic},
         "workload": {"kind": "race", "k": args.workload_k,
                      "delta_ms": args.workload_delta_ms},
         "seed": args.seed}
    if args.chunk is not None:
        q["chunk"] = args.chunk
    if args.precision is not None:
        q["precision"] = args.precision
    return q


def _print_result(r: dict) -> None:
    print(json.dumps(r, indent=2, sort_keys=True, default=float))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.planner", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run the persistent planner service")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=None,
                   help=f"default {7421}; 0 picks a free port")
    s.add_argument("--batch-window", type=float, default=0.05,
                   help="seconds to let concurrent requests batch")
    s.add_argument("--device", default=None,
                   help="where the searches run (default: the CUDA card)")

    q = sub.add_parser("query", help="query a running planner")
    q.add_argument("--host", default="127.0.0.1")
    q.add_argument("--port", type=int, default=None)
    q.add_argument("--op", default="plan",
                   help="plan | stats | ping | shutdown")
    q.add_argument("--json", dest="json_query", default=None,
                   help="full JSON request (overrides the query flags)")
    _add_query_flags(q)

    p = sub.add_parser("plan", help="one-shot in-process planning")
    _add_query_flags(p)
    p.add_argument("--device", default=None,
                   help="where the search runs (default: the CUDA card)")

    args = ap.parse_args(argv)

    if args.cmd == "serve":
        from .service import DEFAULT_PORT, PlannerServer
        port = args.port if args.port is not None else DEFAULT_PORT
        server = PlannerServer(host=args.host, port=port,
                               batch_window_s=args.batch_window,
                               device=args.device)
        print(f"planner: listening on {server.host}:{server.port}",
              flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
        return 0

    if args.cmd == "query":
        from .service import DEFAULT_PORT, query_server
        port = args.port if args.port is not None else DEFAULT_PORT
        if args.json_query is not None:
            payload = json.loads(args.json_query)
        elif args.op != "plan":
            payload = {"op": args.op}
        else:
            payload = {"op": "plan", **_query_dict(args)}
        reply = query_server(payload, host=args.host, port=port)
        _print_result(reply)
        return 0 if reply.get("ok") else 1

    # plan: in-process one-shot
    from .service import Planner
    result = Planner(device=args.device).plan(_query_dict(args))
    _print_result(result.to_dict())
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
