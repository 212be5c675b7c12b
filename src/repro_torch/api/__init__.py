"""Declarative experiment layer over the three evaluation backends
(``repro.api`` in PyTorch).

One ``Experiment`` -- a batch of quorum systems, a workload, a fault set --
runs unmodified against:

  ``montecarlo``  the mask-table engine (``repro_torch.montecarlo``) on the
                  CUDA card (``device="cpu"``: the kernels' plain versions);
  ``des``         the discrete-event simulator running the protocol state
                  machines (``repro_torch.core.simulator``), on the host;
  ``modelcheck``  exhaustive safety checking for n <= 5
                  (``repro_torch.core.model_check``), on the host.

``Experiment(..., trials=10**6)`` streams the Monte-Carlo backend into a
fixed-size quantile sketch; ``Experiment.from_config`` loads the scenario
JSON (``examples/scenarios/*.json``).  ``frontier(...)`` scores a batch into
its Pareto frontier.  ``plan(...)`` / ``Experiment.plan()`` run the
successive-halving planner (``repro_torch.planner``) through the device's
process-wide planner: repeat same-geometry calls reuse its cached search.

``python -m repro_torch.api [--config FILE] [--backend ...] [--device cpu]
[--smoke]`` runs the quickstart experiment or a scenario JSON.
"""
from repro_torch.montecarlo.streaming import StreamSummary  # noqa: F401

from .experiment import (BACKENDS, Experiment, Results,  # noqa: F401
                         Workload, default_planner, frontier, plan, sweep,
                         system_from_config)
