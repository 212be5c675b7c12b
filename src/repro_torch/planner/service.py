"""Search-and-serve planner: queries in, recommended quorum systems out
(``repro.planner.service`` in PyTorch).

The long-lived half of DESIGN.md §11.  A ``Planner`` runs on one device
(``None`` = the CUDA card; ``"cpu"`` runs the kernels' plain versions) and
holds one ``EngineCache`` (launch plans + score memo) and an LRU of finished
``SearchResult``s keyed by search *geometry* — everything that determines
which systems get scored and how (n, family, workload, trial budget,
engine knobs), deliberately EXCLUDING the fault budget and the objective:
two queries that differ only in how they rank the frontier share one
search, one set of launch plans, one frontier.

  Planner.plan(query)        in-process front door (``api.plan`` and
                             ``Experiment.plan`` land here)
  Planner.plan_group([...])  one search answering many queries — the
                             batching primitive the server uses
  PlannerServer              JSON-lines-over-TCP wrapper: a single worker
                             thread drains the request queue in small
                             windows, groups concurrent requests by
                             geometry, and answers each with its own
                             fault-budget/objective ranking
  query_server               client helper (the CLI's ``query`` verb)

A query names a *minimum* crash-budget triple; filtering only the
frontier for it is complete — any valid system meeting the budget is
dominated by (or is) a frontier member whose maximize axes are at least
as large, hence also meeting the budget.

Every response carries ``engine_compiles`` — the kernel state (library
load, launch plans; ``cache.trace_total``) this query built, always 0 on
the CPU — so callers can assert that a repeat same-geometry query is
answered entirely from warm state.  The wire format is the JAX package's:
its ``repro.planner.query_server`` talks to this ``PlannerServer``.
"""
from __future__ import annotations

import json
import socket
import socketserver
import threading
import time
from collections import OrderedDict
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core.quorum import QuorumSpec

from .cache import EngineCache, _delay_token, shard_token, trace_total
from .search import (DEFAULT_SLACK, Rung, SearchResult, default_schedule,
                     search)

DEFAULT_PORT = 7421
DEFAULT_TRIALS = 1_000_000
_OBJECTIVES = ("race_p999_ms", "fast_p50_ms", "p_recovery")

# One search at a time in the process, across every Planner: the kernels'
# launch-plan caches are process-wide dicts without a lock of their own, and
# a search's ``engine_compiles`` is a delta of the process-wide
# ``trace_total()``, so it counts only that search's plans while no other
# search runs.
_SEARCH_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Query / result records (JSON in, JSON out).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PlanQuery:
    """One planning request.

    ``workload`` is a ``Workload`` (in-process) or, over the wire, any
    dict ``Workload.from_dict`` accepts: the ``{"kind": ...}`` constructor
    shorthand (``{"kind": "race", "k": 3, "delta_ms": 0.5}``,
    ``{"kind": "wan", "inter_region_ms": 30.0}``) or a full serialized
    ``Workload.to_dict()`` — trace-driven delays and Markov regime chains
    included.  ``faults`` is the
    minimum crash-budget triple the recommendation must satisfy:
    ``{"fast": 1, "phase1": 2, "classic": 2}`` (missing keys default 0).
    ``objective`` ranks the budget-satisfying frontier members:
    one of ``race_p999_ms`` (default), ``fast_p50_ms``, ``p_recovery``
    (all minimized).  ``trials`` is the FINAL successive-halving budget;
    the schedule below it is derived (``search.default_schedule``) unless
    ``schedule`` pins explicit ``[trials, slack]`` rungs.  The query
    names no device: the planner that answers it runs on its own.
    ``shard`` splits each rung's trials over the trial mesh, as in
    ``streaming.race_stream`` (on the wire a bool; in process also a
    ``parallel.sharding.TrialMesh``).  ``use_kernel``, the JAX package's
    kernel switch, is kept so that its requests parse and selects nothing
    (the planner's device picks every kernel).
    """

    n: int = 11
    family: str = "cardinality"       # a families.FAMILIES name, or "all"
    workload: object = None
    faults: Dict[str, int] = field(default_factory=dict)
    trials: int = DEFAULT_TRIALS
    objective: str = "race_p999_ms"
    schedule: Optional[Tuple[Tuple[int, float], ...]] = None
    chunk: Optional[int] = None
    precision: Optional[float] = None
    seed: int = 0
    shard: bool = False
    use_kernel: bool = False
    k_max: object = "auto"
    slack: float = DEFAULT_SLACK

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.trials < 1:
            raise ValueError(f"trials must be >= 1, got {self.trials}")
        if self.objective not in _OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"pick one of {_OBJECTIVES}")
        unknown = set(self.faults) - {"fast", "phase1", "classic"}
        if unknown:
            raise ValueError(f"unknown fault-budget keys {sorted(unknown)}; "
                             f"use fast/phase1/classic")
        if self.schedule is not None:
            object.__setattr__(self, "schedule", tuple(
                (int(t), float(s)) for t, s in self.schedule))

    @classmethod
    def from_dict(cls, d: Dict) -> "PlanQuery":
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown query fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        return cls(**d)


def resolve_workload(workload):
    """None / ``Workload`` / workload dict -> a ``Workload``.

    Dicts take either form ``Workload.from_dict`` accepts: the
    ``{"kind": ...}`` constructor shorthand (``{"kind": "race", "k": 3}``)
    or a full serialized ``Workload.to_dict()`` — so WAN placements, lossy
    links, trace-driven delays and regime chains all travel over the
    planner socket as plain JSON.  The default is the standard frontier
    race (2-way, Δ=0.2 ms) — the geometry the quorum sweep and the
    scorer's tail axes assume."""
    from repro_torch.api.experiment import Workload
    from repro_torch.frontier import score as fscore

    if workload is None:
        return Workload.race(k=2, delta_ms=fscore.DEFAULT_DELTA_MS)
    if isinstance(workload, Workload):
        return workload
    if not isinstance(workload, dict):
        raise TypeError(f"workload must be a Workload or a dict, "
                        f"got {type(workload).__name__}")
    return Workload.from_dict(workload)


@dataclass
class PlanResult:
    """One planning answer (JSON-ready via ``to_dict``).

    ``ok`` False means no frontier member met the fault budget (``reason``
    says so); otherwise ``recommended`` names the winning system,
    ``system`` describes it (cardinality triples carry (q1, q2c, q2f)),
    ``predicted_ms`` the fast-path p50 and race-path p99.9 / p99.99,
    ``fault_tolerance`` the crash-budget triple, ``alternatives`` the
    other budget-satisfying frontier members, and ``search`` the halving
    telemetry (budget fraction, rungs, launch-plan counts).  ``cold`` is
    whether this query had to run the search (vs. a warm geometry hit);
    ``engine_compiles`` the kernel state it built (``cache.trace_total``).
    """

    ok: bool
    recommended: Optional[str] = None
    system: Dict = field(default_factory=dict)
    predicted_ms: Dict[str, float] = field(default_factory=dict)
    p_recovery: Optional[float] = None
    fault_tolerance: Dict[str, int] = field(default_factory=dict)
    alternatives: List[str] = field(default_factory=list)
    frontier_labels: List[str] = field(default_factory=list)
    search: Dict[str, float] = field(default_factory=dict)
    cold: bool = True
    engine_compiles: int = 0
    wall_s: float = 0.0
    reason: str = ""

    def to_dict(self) -> Dict:
        return asdict(self)


def _describe_system(member) -> Dict:
    system = getattr(member, "system", member)
    out = {"label": getattr(member, "label", "") or "",
           "type": type(system).__name__}
    if isinstance(system, QuorumSpec):
        out.update(n=system.n, q1=system.q1, q2c=system.q2c,
                   q2f=system.q2f)
    return out


# ---------------------------------------------------------------------------
# The in-process planner.
# ---------------------------------------------------------------------------

class Planner:
    """Search-and-serve core on ``device`` (``None`` = the CUDA card): one
    engine cache, one search LRU, no sockets.

    Thread-safe for the server's single worker thread + stats readers; the
    process-wide search lock (``_SEARCH_LOCK``, shared by every Planner)
    serializes plan_group, so concurrent in-process callers cannot
    duplicate a search and two planners' searches never overlap.  Other
    work that builds launch plans at the same time (an ``Experiment.run``
    on another thread) would still count in a cold search's
    ``engine_compiles``.
    """

    def __init__(self, engines: Optional[EngineCache] = None,
                 search_cache_size: int = 16, device=None):
        self.device = device_mod.resolve(device)
        self.engines = engines if engines is not None else EngineCache()
        self.search_cache_size = search_cache_size
        self._searches: "OrderedDict[tuple, SearchResult]" = OrderedDict()
        self.search_hits = 0
        self.search_misses = 0

    # -- geometry ----------------------------------------------------------
    def geometry_key(self, q: PlanQuery) -> tuple:
        """Everything that determines which systems get scored and how —
        fault budget and objective deliberately excluded, so queries that
        only rank differently share one search."""
        wl = resolve_workload(q.workload)
        racing = wl.k_proposers >= 2
        from repro_torch.frontier import score as fscore
        from repro_torch.montecarlo import streaming
        k_eff = wl.k_proposers if racing else 2
        d_eff = wl.delta_ms if racing else fscore.DEFAULT_DELTA_MS
        # None knobs resolve to the scorer's defaults before keying, so a
        # query spelling the default explicitly still shares the search
        chunk = q.chunk if q.chunk is not None else fscore.DEFAULT_CHUNK
        precision = (q.precision if q.precision is not None
                     else streaming.DEFAULT_PRECISION)
        return (q.n, q.family, k_eff, d_eff,
                _delay_token(wl.delay_for(q.n)),
                _delay_token(wl.regimes_for(q.n)),
                q.trials, q.schedule,
                chunk, precision, q.seed,
                shard_token(q.shard, self.device), repr(q.k_max), q.slack,
                wl.recovery)

    # -- planning ----------------------------------------------------------
    def plan(self, query=None, **kw) -> PlanResult:
        """Answer one query (a ``PlanQuery``, a dict, or keyword fields)."""
        if query is None:
            query = PlanQuery(**kw)
        elif isinstance(query, dict):
            query = PlanQuery.from_dict(query)
        return self.plan_group([query])[0]

    def plan_group(self, queries: Sequence[PlanQuery]) -> List[PlanResult]:
        """Answer a batch of same-geometry queries with ONE search (hence
        one set of launch plans).  Raises if geometries differ — the
        server groups before calling."""
        if not queries:
            return []
        keys = [self.geometry_key(q) for q in queries]
        if len(set(keys)) != 1:
            raise ValueError("plan_group needs same-geometry queries; "
                             "group by Planner.geometry_key first")
        t0 = time.perf_counter()
        with _SEARCH_LOCK:
            sr, cold, compiles = self._search_for(queries[0], keys[0])
        wall = time.perf_counter() - t0
        out = []
        for i, q in enumerate(queries):
            r = self._recommend(q, sr)
            r.cold = cold
            # the one cold search's compiles are attributed to the first
            # query of the batch; everyone else rode along for free
            r.engine_compiles = compiles if (cold and i == 0) else 0
            r.wall_s = wall if i == 0 else 0.0
            out.append(r)
        return out

    def _search_for(self, q: PlanQuery,
                    gkey: tuple) -> Tuple[SearchResult, bool, int]:
        hit = self._searches.get(gkey)
        if hit is not None:
            self._searches.move_to_end(gkey)
            self.search_hits += 1
            return hit, False, 0
        self.search_misses += 1
        from repro_torch.frontier import families
        members = (families.all_families(q.n) if q.family == "all"
                   else families.family(q.family, q.n))
        wl = resolve_workload(q.workload)
        racing = wl.k_proposers >= 2
        from repro_torch.frontier import score as fscore
        schedule = (tuple(Rung(t, s) for t, s in q.schedule)
                    if q.schedule is not None else
                    default_schedule(q.trials, slack=q.slack))
        sr = search(
            members, final_trials=q.trials, schedule=schedule, n=q.n,
            k_proposers=wl.k_proposers if racing else 2,
            delta_ms=wl.delta_ms if racing else fscore.DEFAULT_DELTA_MS,
            delay=wl.delay_for(q.n), chunk=q.chunk, precision=q.precision,
            shard=q.shard, k_max=q.k_max, seed=q.seed, slack=q.slack,
            regimes=wl.regimes_for(q.n), recovery=wl.recovery,
            cache=self.engines, device=self.device)
        self._searches[gkey] = sr
        while len(self._searches) > self.search_cache_size:
            self._searches.popitem(last=False)
        return sr, True, sum(r.engine_compiles for r in sr.rungs)

    def _recommend(self, q: PlanQuery, sr: SearchResult) -> PlanResult:
        from repro_torch.frontier.score import AXIS_NAMES
        fr = sr.frontier
        vals = np.asarray(fr.values, np.float64)
        names = list(fr.axis_names)
        col = {a: names.index(a) for a in AXIS_NAMES}
        need = (q.faults.get("fast", 0), q.faults.get("phase1", 0),
                q.faults.get("classic", 0))
        eligible = [i for i in fr.frontier_indices
                    if vals[i, col["ft_fast"]] >= need[0]
                    and vals[i, col["ft_phase1"]] >= need[1]
                    and vals[i, col["ft_classic"]] >= need[2]]
        base = PlanResult(ok=False,
                          frontier_labels=list(fr.frontier_labels),
                          search=sr.to_dict())
        if not eligible:
            base.reason = (f"no frontier system tolerates "
                           f"fast>={need[0]}, phase1>={need[1]}, "
                           f"classic>={need[2]} crashes at n={q.n} "
                           f"(family={q.family}); relax the budget or "
                           f"grow the cluster")
            return base
        obj = col[q.objective]
        # deterministic ranking: objective, then the other two stochastic
        # axes, then label (NaN — never decided — sorts last)
        rank_cols = [obj] + [col[a] for a in
                             ("race_p999_ms", "fast_p50_ms", "p_recovery")
                             if col[a] != obj]

        def rank(i):
            vs = [vals[i, c] for c in rank_cols]
            return tuple(np.inf if np.isnan(v) else v for v in vs) \
                + (fr.labels[i],)

        best = min(eligible, key=rank)
        race = fr.streams["race"] if fr.streams else None
        p9999 = (float(race.quantile(0.9999).cpu().numpy()[best])
                 if race is not None else float("nan"))
        base.ok = True
        base.recommended = fr.labels[best]
        base.system = _describe_system(sr.members[best])
        base.predicted_ms = {
            "fast_p50": float(vals[best, col["fast_p50_ms"]]),
            "race_p999": float(vals[best, col["race_p999_ms"]]),
            "race_p9999": p9999,
        }
        base.p_recovery = float(vals[best, col["p_recovery"]])
        base.fault_tolerance = {
            "fast": int(vals[best, col["ft_fast"]]),
            "phase1": int(vals[best, col["ft_phase1"]]),
            "classic": int(vals[best, col["ft_classic"]]),
        }
        base.alternatives = [fr.labels[i] for i in eligible if i != best]
        return base

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        out = {"search_hits": float(self.search_hits),
               "search_misses": float(self.search_misses),
               "searches_cached": float(len(self._searches))}
        out.update(self.engines.stats_dict())
        # the JAX package's key; here the kernel state built in the process
        out["trace_counts"] = {"launch_plans": trace_total()}
        out["device"] = str(self.device)
        return out


# ---------------------------------------------------------------------------
# The persistent service: JSON lines over TCP, batched by geometry.
# ---------------------------------------------------------------------------

@dataclass
class _Pending:
    query: PlanQuery
    gkey: tuple
    event: threading.Event = field(default_factory=threading.Event)
    response: Optional[Dict] = None

    def respond(self, payload: Dict) -> None:
        self.response = payload
        self.event.set()


class PlannerServer:
    """JSON-lines planner service.

    One line in, one line out per connection.  Ops:

      {"op": "plan", ...PlanQuery fields}   -> PlanResult dict
      {"op": "stats"}                       -> planner + engine telemetry
      {"op": "ping"}                        -> {"ok": true}
      {"op": "shutdown"}                    -> stops the server

    Plan requests enqueue to a single worker thread that drains the queue
    in ``batch_window_s`` windows and groups by search geometry — N
    concurrent same-geometry queries cost ONE search (one mask-table
    set of launch plans), each answered under its own fault budget and
    objective.  The worker runs every search on the planner's device
    (``planner``, or a new ``Planner(device=device)``).
    """

    def __init__(self, planner: Optional[Planner] = None,
                 host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 batch_window_s: float = 0.05, device=None):
        if planner is not None and device is not None:
            raise ValueError("pass a planner or a device, not both")
        self.planner = (planner if planner is not None
                        else Planner(device=device))
        self.batch_window_s = batch_window_s
        self._pending: List[_Pending] = []
        self._pending_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                line = self.rfile.readline()
                if not line.strip():
                    return
                payload = outer._handle_line(line)
                self.wfile.write(json.dumps(payload).encode() + b"\n")

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._worker = threading.Thread(target=self._drain, daemon=True,
                                        name="planner-worker")

    # -- lifecycle ---------------------------------------------------------
    def serve_forever(self) -> None:
        """Run until ``shutdown`` (op or call).  Blocks."""
        self._worker.start()
        try:
            self._server.serve_forever(poll_interval=0.1)
        finally:
            self.shutdown()

    def start(self) -> None:
        """Run in background threads (tests / embedding)."""
        self._worker.start()
        threading.Thread(target=self._server.serve_forever,
                         kwargs={"poll_interval": 0.1}, daemon=True,
                         name="planner-accept").start()

    def shutdown(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._wake.set()
            self._server.shutdown()
            self._server.server_close()

    # -- request handling --------------------------------------------------
    def _handle_line(self, line: bytes) -> Dict:
        try:
            msg = json.loads(line)
            op = msg.pop("op", "plan")
            if op == "ping":
                return {"ok": True, "op": "ping"}
            if op == "stats":
                return {"ok": True, **self.planner.stats()}
            if op == "shutdown":
                threading.Thread(target=self.shutdown, daemon=True).start()
                return {"ok": True, "op": "shutdown"}
            if op != "plan":
                return {"ok": False, "error": f"unknown op {op!r}"}
            query = PlanQuery.from_dict(msg)
            gkey = self.planner.geometry_key(query)
        except Exception as e:                  # malformed request
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}
        item = _Pending(query, gkey)
        with self._pending_lock:
            self._pending.append(item)
        self._wake.set()
        item.event.wait()
        return item.response

    def _drain(self) -> None:
        """Single worker: collect a window of requests, group by geometry,
        one ``plan_group`` per group."""
        while not self._stop.is_set():
            self._wake.wait(timeout=0.1)
            self._wake.clear()
            with self._pending_lock:
                if not self._pending:
                    continue
            time.sleep(self.batch_window_s)     # let the batch accumulate
            with self._pending_lock:
                batch, self._pending = self._pending, []
            groups: "OrderedDict[tuple, List[_Pending]]" = OrderedDict()
            for it in batch:
                groups.setdefault(it.gkey, []).append(it)
            for items in groups.values():
                try:
                    results = self.planner.plan_group(
                        [it.query for it in items])
                    for it, r in zip(items, results):
                        it.respond({"ok": True, **r.to_dict()})
                except Exception as e:
                    for it in items:
                        it.respond({"ok": False,
                                    "error": f"{type(e).__name__}: {e}"})


def query_server(payload: Dict, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, timeout_s: float = 600.0) -> Dict:
    """Send one JSON request line to a running planner and return the
    decoded response (the CLI's ``query`` verb)."""
    with socket.create_connection((host, port), timeout=timeout_s) as conn:
        conn.sendall(json.dumps(payload).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            got = conn.recv(65536)
            if not got:
                break
            buf += got
    if not buf:
        raise ConnectionError("planner closed the connection w/o replying")
    return json.loads(buf)
