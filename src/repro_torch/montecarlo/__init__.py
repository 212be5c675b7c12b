"""Monte-Carlo engine (``repro.montecarlo`` in the JAX package).

  ``latency``    delay models and their JSON registry
  ``traces``     ``EmpiricalDelay``: a measured trace as a quantile table
  ``rng``        counter-based keys, one ``torch.Generator`` per key
  ``engine``     the K-proposer race over mask tables
  ``streaming``  the chunk loop into mergeable ``StreamSummary`` sketches
  ``regimes``    Markov-modulated failure epochs (``RegimeStreamSummary``)
  ``scenarios``  named workloads bundling race geometry and a delay model

Importing the package completes the delay registry (``traces`` registers
the ``empirical`` kind).
"""
from . import engine, latency, regimes, scenarios  # noqa: F401
from . import streaming, traces  # noqa: F401
from .engine import (build_mask_table, classic_path,  # noqa: F401
                     fast_path, race, summarize)
from .latency import (CrashedDelay, LossyDelay, ParetoDelay,  # noqa: F401
                      ShiftedLognormalDelay, WanDelay, delay_from_config,
                      delay_kinds, delay_to_config)
from .regimes import MarkovRegimes, RegimeStreamSummary  # noqa: F401
from .scenarios import (RunSpec, Scenario, conflict_free,  # noqa: F401
                        grid_wan, k_way_race, lossy_acceptors,
                        mixed_workload, wan, weighted_acceptors)
from .streaming import (StreamSummary, classic_path_stream,  # noqa: F401
                        fast_path_stream, race_stream)
from .traces import EmpiricalDelay  # noqa: F401
