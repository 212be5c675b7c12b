"""Streamed quorum-space Pareto frontier (``repro.frontier`` in PyTorch).

  ``families``   FFP-valid systems per family as labeled ``Member``s
  ``score``      stream a batch through the fast and race passes and
                 extract the frontier axes
  ``pareto``     numpy dominance over mixed min/max axes at measurement
                 precision, and the ``FrontierResult`` record

``python -m repro_torch.frontier`` runs the n=11 sweep (``__main__``).
"""
from . import families, pareto, score  # noqa: F401
from .families import (Member, all_families, cardinality_family,  # noqa: F401
                       family, grid_family, relaxed_family, weighted_family)
from .pareto import (Axis, FrontierResult, dominates,  # noqa: F401
                     maximal_mask, pareto_mask, quantize)
from .score import default_axes, score_systems  # noqa: F401
