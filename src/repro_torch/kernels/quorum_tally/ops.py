"""Dispatch for the quorum-tally kernels: the tensor's device decides.

A CPU tensor gets the plain version in ``ref.py``; a CUDA tensor gets the
hand-written kernel in ``kernel.py``, or the exception the kernel wrapper
raises.  Nothing falls back from one to the other.  ``LAUNCHES`` counts the
kernel launches (one per launch, nowhere else); ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import torch

from . import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the quorum-tally kernels run on CUDA or, in their "
                     f"plain version, on the CPU; got a tensor on {t.device}")


def tally_decide(votes: torch.Tensor, n_values: int, q) -> tuple:
    """(counts, winner, max_count, reached) of (S, n) votes."""
    if _on_card(votes):
        return kernel.tally_decide(votes, n_values, q)
    return ref.tally_decide(votes, n_values, q)


def masked_tally(votes: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, G) lowest value id saturating each quorum row, else -1."""
    if _on_card(votes):
        return kernel.masked_tally(votes, weights, thresholds, n_values)
    return ref.masked_tally(votes, weights, thresholds, n_values)


def stream_tally_decide_hist(votes, val_arr, arrive, classic, w1, t1, w2c,
                             t2c, w2f, t2f, valid, *, n_values: int,
                             k_sat: tuple, precision: float, bins: int,
                             undecided_ms: float):
    """Fused masked tally + selection + decide + sketch over one chunk."""
    fn = (kernel.stream_tally_decide_hist if _on_card(votes)
          else ref.stream_tally_decide_hist)
    return fn(votes, val_arr, arrive, classic, w1, t1, w2c, t2c, w2f, t2f,
              valid, n_values=n_values, k_sat=tuple(int(k) for k in k_sat),
              precision=precision, bins=bins, undecided_ms=undecided_ms)
