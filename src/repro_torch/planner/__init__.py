"""repro_torch.planner: successive-halving quorum search and a persistent
search-and-serve planner (``repro.planner`` in PyTorch; DESIGN.md §11).

Three layers, importable separately:

  search    plain-data rung schedules + margin-dominance pruning +
            the ``successive_halving`` loop (numpy only)
  cache     ``EngineCache`` — the scorer routed through a per-geometry
            ledger of the kernels' launch plans, with a content-fingerprint
            result memo
  service   ``Planner`` (in-process, on one device), ``PlannerServer``
            (JSON lines over TCP, batched by geometry; the JAX package's
            wire format), ``query_server`` client

Searches run on the CUDA card unless ``device="cpu"`` is asked for.
CLI: ``python -m repro_torch.planner serve | query | plan``.
"""
from .cache import EngineCache, EngineKey, engine_key, trace_total
from .search import (Rung, RungReport, SearchResult, default_schedule,
                     prune_survivors, search, successive_halving)
from .service import (PlanQuery, PlanResult, Planner, PlannerServer,
                      query_server, resolve_workload)

__all__ = [
    "EngineCache", "EngineKey", "engine_key", "trace_total",
    "Rung", "RungReport", "SearchResult", "default_schedule",
    "prune_survivors", "search", "successive_halving",
    "PlanQuery", "PlanResult", "Planner", "PlannerServer",
    "query_server", "resolve_workload",
]
