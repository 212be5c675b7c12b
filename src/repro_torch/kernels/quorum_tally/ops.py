"""Dispatch for the quorum-tally kernels: the tensor's device decides.

A CPU tensor gets the plain version in ``ref.py``; a CUDA tensor gets the
hand-written kernel in ``kernel.py``, or the exception the kernel wrapper
raises.  Nothing falls back from one to the other.  ``LAUNCHES`` counts the
kernel launches (one per launch, nowhere else); ``reset_launches()`` zeroes it.
``launch_plans()`` counts what the card path builds once and keeps.
"""
from __future__ import annotations

import torch

from . import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches
SORTED_PREFIX_MAX_N = kernel.SORTED_PREFIX_MAX_N


def launch_plans() -> int:
    """What the kernels have built for reuse so far in this process: the
    loaded library (one) plus the launch plans kept per kind, device and
    shape (``masked_tally``'s, ``stream_tally_decide_hist``'s,
    ``race_card_hist``'s, ``masked_sat``'s and ``col_sketch``'s).  0
    where no kernel ran, as on the CPU."""
    return kernel.LIB.built()


def _on_card(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"the quorum-tally kernels run on CUDA or, in their "
                     f"plain version, on the CPU; got a tensor on {t.device}")


def tally_votes(votes: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, K) int32 count of each value's votes in (S, n) votes."""
    if _on_card(votes):
        return kernel.tally_votes(votes, n_values)
    return ref.tally_votes(votes, n_values)


def quorum_reached(votes: torch.Tensor, n_values: int, q: int
                   ) -> torch.Tensor:
    """(S,) bool: some value gathered >= q of the (S, n) votes."""
    return (tally_votes(votes, n_values) >= q).any(dim=-1)


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


def masked_sat(sorted_x: torch.Tensor, perm: torch.Tensor, w: torch.Tensor,
               t: torch.Tensor, *, big: float) -> torch.Tensor:
    """(M, S) f32 earliest instant some quorum row of each system saturates
    along presorted arrivals, ``big`` where none does (``ref.masked_sat``)."""
    if _on_card(sorted_x):
        return kernel.masked_sat(sorted_x, perm, w, t, big=big)
    ref.check_masked_sat(sorted_x, perm, w, t)
    return ref.masked_sat(sorted_x, perm, w, t, big=big)


def sorted_prefix(x: torch.Tensor, k: int, *, order: bool) -> tuple:
    """(..., k) f32 smallest values of each row, ascending, and with
    ``order`` their (..., k) int64 positions, else None
    (``ref.sorted_prefix``: torch.sort(stable=True)'s first k)."""
    if _on_card(x):
        return kernel.sorted_prefix(x, k, order=order)
    ref.check_sorted_prefix(x, k)
    return ref.sorted_prefix(x, k, order=order)


def col_sketch(cols: torch.Tensor, valid: torch.Tensor, *, precision: float,
               bins: int, undecided_ms: float) -> tuple:
    """Each of the (S, Kc) latency columns' histogram and undecided count
    (Kc, bins + 1), f32 sum and max over the decided valid trials, and the
    valid count (``ref.col_sketch``)."""
    fn = kernel.col_sketch if _on_card(cols) else ref.col_sketch
    return fn(cols, valid, precision=precision, bins=bins,
              undecided_ms=undecided_ms)


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


def race_card_hist(votes, arrive, classic, valid, pairs, *, n_values: int,
                   k_sat: tuple, precision: float, bins: int,
                   undecided_ms: float):
    """The cardinality race chunk's tally, decide and fcap-slot histograms,
    sums and maxima (``ref.race_card_hist``)."""
    fn = kernel.race_card_hist if _on_card(votes) else ref.race_card_hist
    return fn(votes, arrive, classic, valid, pairs, n_values=n_values,
              k_sat=tuple(int(k) for k in k_sat), precision=precision,
              bins=bins, undecided_ms=undecided_ms)
