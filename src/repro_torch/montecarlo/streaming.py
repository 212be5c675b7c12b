"""Streamed Monte-Carlo trials in fixed memory (``repro.montecarlo.streaming``).

The engine's materializing entry points hold an (M, S) array per output.
Here the same per-chunk computation becomes a reduction: a Python loop
draws, decides and reduces one chunk of trials at a time into a fixed-size
``StreamSummary`` -- counts, a running mean and max, and a DDSketch
log-bucket histogram whose quantiles carry a guaranteed relative error
(``precision``).  Counts and histograms are integers, so merges are exact.

Chunk c draws from the generator of ``rng.derive(key, CHUNK_DOMAIN, c)``;
the last chunk's overhang is masked out by a validity vector.  A stream of
``trials <= chunk`` runs the engine's materializing entry point on ``key``
itself and reduces its output.

Per chunk, the loop picks one lowering from what it can observe:

  cardinality table ("q") + k_max   sort-free shared-column reductions:
                                    ``_race_card_update`` (tally_decide
                                    kernel) / ``_cols_card_update``
  masked table, race, k_max         ``_race_fused_update``: the raw chunk
                                    goes through the fused
                                    stream_tally_decide_hist kernel
  k_max=None, or masked fast /      materialized (M, chunk) outcomes +
  classic paths                     ``StreamSummary.update``

Decide bits, counts, histograms and maxima are identical across lowerings;
only the f32 latency sum (hence the mean) accumulates in another order.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.quorum_tally import ops as qt_ops

from . import engine, rng
from .engine import UNDECIDED_MS
from .latency import default_delay

DEFAULT_CHUNK = 65536
DEFAULT_PRECISION = 0.01

# Sketch coverage: 10 us .. ~3 hours; values outside clamp to edge buckets.
SKETCH_MIN_MS = 1e-2
SKETCH_MAX_MS = 1e7


def sketch_gamma(precision: float) -> float:
    """DDSketch bucket growth factor for a target relative error."""
    return (1.0 + precision) / (1.0 - precision)


def sketch_bins(precision: float) -> int:
    """Bucket count covering [SKETCH_MIN_MS, SKETCH_MAX_MS] at ``precision``
    relative error, plus the clamp bucket 0."""
    if not 1e-4 <= precision <= 0.2:
        raise ValueError(f"precision (relative quantile error) must be in "
                         f"[1e-4, 0.2], got {precision}")
    g = sketch_gamma(precision)
    return int(math.ceil(math.log(SKETCH_MAX_MS / SKETCH_MIN_MS)
                         / math.log(g))) + 1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device: divisions by it are true f32
    divisions (a Python-scalar divisor may become a reciprocal multiply)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def bucket_index(x: torch.Tensor, precision: float) -> torch.Tensor:
    """Log-bucket index: bucket i > 0 covers (m0*g^(i-1), m0*g^i].  The same
    f32 expression as the fused kernel's:
    ``ceil(log(max(x, 1e-2) / 1e-2) / log_g)`` clipped to [0, bins-1]."""
    log_g = _f32(math.log(sketch_gamma(precision)), x)
    lo = _f32(SKETCH_MIN_MS, x)
    i = torch.ceil(torch.log(torch.maximum(x, lo) / lo) / log_g)
    return i.clamp(0, sketch_bins(precision) - 1).to(torch.int32)


def bucket_value(i: torch.Tensor, precision: float) -> torch.Tensor:
    """Representative value of bucket i: 2*m0*g^i/(g+1), the point whose
    relative distance to both bucket edges is exactly ``precision``."""
    g = sketch_gamma(precision)
    scale = SKETCH_MIN_MS * 2.0 * g / (g + 1.0)
    base = torch.full((), g, dtype=torch.float32, device=i.device)
    return scale * torch.pow(base, i.to(torch.float32) - 1.0)


# ---------------------------------------------------------------------------
# StreamSummary: the fixed-size online state.
# ---------------------------------------------------------------------------

_FIELDS = ("n_trials", "n_fast", "n_recovery", "n_undecided", "mean_ms",
           "max_ms", "hist")


@dataclass(frozen=True)
class StreamSummary:
    """Mergeable per-system summary of any number of streamed trials.

    Fields are per-system tensors (leading M axis); ``hist`` counts decided
    latencies per sketch bucket.  Undecided instances are excluded from the
    latency statistics and counted in ``n_undecided``."""

    n_trials: torch.Tensor       # (M,) int32
    n_fast: torch.Tensor         # (M,) int32
    n_recovery: torch.Tensor     # (M,) int32
    n_undecided: torch.Tensor    # (M,) int32
    mean_ms: torch.Tensor        # (M,) f32 running mean of decided latencies
    max_ms: torch.Tensor         # (M,) f32 running max (-inf before any)
    hist: torch.Tensor           # (M, B) int32
    precision: float = DEFAULT_PRECISION

    @classmethod
    def zeros(cls, m: int, precision: float = DEFAULT_PRECISION,
              device="cpu") -> "StreamSummary":
        z = torch.zeros((m,), dtype=torch.int32, device=device)
        return cls(z, z, z, z,
                   torch.zeros((m,), dtype=torch.float32, device=device),
                   torch.full((m,), -math.inf, dtype=torch.float32,
                              device=device),
                   torch.zeros((m, sketch_bins(precision)), dtype=torch.int32,
                               device=device),
                   precision)

    @classmethod
    def from_outcomes(cls, out: Dict[str, torch.Tensor],
                      precision: float = DEFAULT_PRECISION
                      ) -> "StreamSummary":
        """Reduce a materialized (M, S) outcome dict (the T <= chunk case)."""
        lat = out["latency_ms"]
        m, s = lat.shape
        valid = torch.ones((s,), dtype=torch.bool, device=lat.device)
        return cls.zeros(m, precision, lat.device).update(out, valid)

    @classmethod
    def from_numpy(cls, d: Dict, precision: float = DEFAULT_PRECISION,
                   device="cpu") -> "StreamSummary":
        """From ``{field: array}``, e.g. a JAX summary's leaves."""
        return cls(*(torch.from_numpy(np.array(d[f])).to(device)
                     for f in _FIELDS), precision=precision)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return {f: getattr(self, f).detach().cpu().numpy() for f in _FIELDS}

    @property
    def n_decided(self) -> torch.Tensor:
        return self.n_fast + self.n_recovery

    @property
    def bins(self) -> int:
        return self.hist.shape[-1]

    def update(self, out: Dict[str, torch.Tensor],
               valid: torch.Tensor) -> "StreamSummary":
        """Absorb one chunk: ``out`` an (M, C) outcome dict, ``valid`` a (C,)
        bool mask (False = padding trial, contributes nothing)."""
        lat = out["latency_ms"]
        v = valid[None, :]
        fast = out["reached_fast"] & v
        rec = out["recovery"] & v
        und = out["undecided"] & v
        decided = fast | rec
        idx = bucket_index(lat, self.precision).long()
        hist = torch.zeros_like(self.hist).scatter_add_(
            1, idx, decided.to(torch.int32))
        return self._absorb(
            n_trials=(fast | rec | und).sum(dim=-1).to(torch.int32),
            n_fast=fast.sum(dim=-1).to(torch.int32),
            n_recovery=rec.sum(dim=-1).to(torch.int32),
            n_undecided=und.sum(dim=-1).to(torch.int32),
            cnt=decided.sum(dim=-1).to(torch.float32),
            lat_sum=torch.where(decided, lat, 0.0).sum(dim=-1),
            lat_max=torch.where(decided, lat, -math.inf).amax(dim=-1),
            hist=hist)

    def _absorb(self, *, n_trials, n_fast, n_recovery, n_undecided, cnt,
                lat_sum, lat_max, hist) -> "StreamSummary":
        """Merge per-chunk aggregates."""
        n_old = self.n_decided.to(torch.float32)
        tot = n_old + cnt
        mean = torch.where(tot > 0, (self.mean_ms * n_old + lat_sum)
                           / tot.clamp(min=1.0), 0.0)
        return replace(self,
                       n_trials=self.n_trials + n_trials,
                       n_fast=self.n_fast + n_fast,
                       n_recovery=self.n_recovery + n_recovery,
                       n_undecided=self.n_undecided + n_undecided,
                       mean_ms=mean,
                       max_ms=torch.maximum(self.max_ms, lat_max),
                       hist=self.hist + hist)

    def merge(self, other: "StreamSummary") -> "StreamSummary":
        """Combine two summaries as if their trials had been one stream:
        integer sums for counts and histogram, count-weighted means."""
        if other.precision != self.precision:
            raise ValueError(
                f"cannot merge sketches of different precision "
                f"({self.precision} vs {other.precision})")
        return self._absorb(
            n_trials=other.n_trials, n_fast=other.n_fast,
            n_recovery=other.n_recovery, n_undecided=other.n_undecided,
            cnt=other.n_decided.to(torch.float32),
            lat_sum=other.mean_ms * other.n_decided.to(torch.float32),
            lat_max=other.max_ms, hist=other.hist)

    def quantile(self, q) -> torch.Tensor:
        """Sketch quantile estimate over decided trials, within
        ``precision`` relative error inside the sketch range.  Scalar ``q``
        -> (M,); a sequence of Q -> (Q, M).  NaN where nothing decided."""
        scalar = np.ndim(q) == 0
        qv = torch.as_tensor(np.atleast_1d(np.asarray(q, np.float32))).to(
            self.hist.device)
        n = self.n_decided
        cum = torch.cumsum(self.hist, dim=-1, dtype=torch.int32)
        rank = torch.ceil(qv[:, None] * n[None, :]).clamp(min=1.0)
        rank = torch.minimum(rank, n.clamp(min=1)[None, :].to(rank.dtype))
        idx = torch.argmax((cum[None, :, :] >= rank[:, :, None]).to(
            torch.int32), dim=-1)
        val = torch.where(n[None, :] > 0, bucket_value(idx, self.precision),
                          torch.nan)
        return val[0] if scalar else val

    def summary(self) -> Dict[str, torch.Tensor]:
        """``engine.summarize`` keys, plus p99.9 / p99.99."""
        n = self.n_trials.clamp(min=1).to(torch.float32)
        has = self.n_decided > 0
        qs = self.quantile([0.5, 0.95, 0.99, 0.999, 0.9999])
        return {
            "mean_ms": torch.where(has, self.mean_ms, torch.nan),
            "p50_ms": qs[0], "p95_ms": qs[1], "p99_ms": qs[2],
            "p999_ms": qs[3], "p9999_ms": qs[4],
            "max_ms": torch.where(has, self.max_ms, torch.nan),
            "fast_rate": self.n_fast / n,
            "recovery_rate": self.n_recovery / n,
            "undecided_rate": self.n_undecided / n,
        }


# ---------------------------------------------------------------------------
# Per-chunk lowerings.
# ---------------------------------------------------------------------------

def _lat_only_outcomes(lat: torch.Tensor, fast: bool) -> Dict:
    """Latency-array paths (fast_path / classic_path) as an outcome dict."""
    und = lat >= UNDECIDED_MS
    no = torch.zeros_like(und)
    return {"latency_ms": lat, "undecided": und,
            "reached_fast": ~und if fast else no,
            "recovery": no if fast else ~und}


def _chunk_outcomes(path: str, gen, table, offsets, delay, *, n, k_proposers,
                    chunk, k_sat=None, recovery="coordinated") -> Dict:
    if path == "race":
        return engine._race_outcomes(gen, table, offsets, delay, n=n,
                                     k_proposers=k_proposers, samples=chunk,
                                     k_sat=k_sat, recovery=recovery)
    if path == "fast_path":
        return _lat_only_outcomes(
            engine._fast_path_outcomes(gen, table, delay, n=n, samples=chunk,
                                       k_sat=k_sat), fast=True)
    return _lat_only_outcomes(
        engine._classic_path_outcomes(gen, table, delay, n=n, samples=chunk,
                                      k_sat=k_sat), fast=False)


def _count(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int32 occurrence counts of ``idx`` in [0, size) (atomics on CUDA,
    exact in any order; unlike ``torch.bincount`` it never syncs)."""
    idx = idx.reshape(-1).long()
    return torch.zeros((size,), dtype=torch.int32, device=idx.device
                       ).scatter_add_(0, idx, torch.ones_like(
                           idx, dtype=torch.int32))


def _suffix(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim=dim,
                                   dtype=x.dtype), (dim,))


def _card_layout(table, recovery: str = "coordinated") -> tuple:
    """Distinct (q1, q_rec) recovery pairs (P, 2) of a cardinality table and
    each system's pair id (M,); q_rec is q2c under coordinated recovery,
    q2f under uncoordinated.  Recovery latency depends on a system only
    through this pair."""
    q = table["q"].detach().cpu().numpy()
    cols = [0, 1] if recovery == "coordinated" else [0, 2]
    pairs, inv = np.unique(q[:, cols], axis=0, return_inverse=True)
    dev = table["q"].device
    return (torch.as_tensor(pairs, dtype=torch.long).to(dev),
            torch.as_tensor(inv.reshape(-1), dtype=torch.long).to(dev))


def _cols_card_update(state: StreamSummary, cols: torch.Tensor,
                      col_of_m: torch.Tensor, valid: torch.Tensor, *,
                      fast: bool) -> StreamSummary:
    """Absorb a chunk whose per-system latency is one of ``Kc`` shared
    columns, ``lat[m, c] = cols[c, col_of_m[m]]``: one (Kc, bins) histogram
    plus per-column sum / max, then a gather per system."""
    B = state.bins
    Kc = cols.shape[1]
    und = cols >= UNDECIDED_MS
    bkey = torch.where(und, B, bucket_index(cols, state.precision).long())
    bkey = torch.where(valid[:, None], bkey, B + 1)
    flat = torch.arange(Kc, device=cols.device)[None, :] * (B + 2) + bkey
    LH = _count(flat, Kc * (B + 2)).reshape(Kc, B + 2)
    col_of_m = col_of_m.long()
    rows = LH[col_of_m]
    hist = rows[:, :B]
    n_und = rows[:, B]
    n_dec = hist.sum(dim=-1, dtype=torch.int32)
    ok = valid[:, None] & ~und
    col_sum = torch.where(ok, cols, 0.0).sum(dim=0)
    col_max = torch.where(ok, cols, -math.inf).amax(dim=0)
    zero = torch.zeros_like(n_dec)
    n_valid = valid.sum().to(torch.int32).expand(col_of_m.shape)
    return state._absorb(
        n_trials=n_valid, n_fast=n_dec if fast else zero,
        n_recovery=zero if fast else n_dec, n_undecided=n_und,
        cnt=n_dec.to(torch.float32), lat_sum=col_sum[col_of_m],
        lat_max=col_max[col_of_m], hist=hist)


def _race_card_update(state: StreamSummary, gen, table, layout, offsets,
                      delay, valid, *, n, k_proposers, chunk, k_sat,
                      recovery="coordinated") -> StreamSummary:
    """Sort-free race chunk for cardinality tables.

    The per-trial fast capacity ``fcap = min(max_cnt, #finite winner 2bs)``
    decides the fast path for every system at once: system m commits fast
    exactly when ``fcap >= q2f_m``.  Recovery latency depends on m only
    through its (q1, q_rec) pair.  So the chunk reduces into winner-2b
    column histograms keyed by fcap slot (suffix sums over slots, gathered
    at (q2f-1, q2f)) and recovery-pair histograms keyed by fcap slot
    (prefix sums, gathered at (pair, q2f-1)), plus matching sums and
    maxima.  The vote counts come from the tally_decide kernel."""
    k2f = k_sat[2]
    draws = engine._sample_race(gen, offsets, delay, n=n,
                                k_proposers=k_proposers, samples=chunk,
                                card=True, k_sat=k_sat, recovery=recovery)
    pairs, pair_of_m = layout
    P_ = pairs.shape[0]
    q2f = table["q"][:, 2].long()
    B = state.bins
    prec = state.precision
    dev = valid.device
    win = engine._win_sorted(draws)                      # (C, k2f)
    C = win.shape[0]
    V = k2f + 1                                          # fcap slots 0..k2f

    nfin = (win < UNDECIDED_MS).sum(dim=-1)
    fcap = torch.minimum(draws["max_cnt"].long(), nfin)
    vkey = torch.where(valid, fcap, V)                   # V = padding slot
    oh = (vkey[:, None] == torch.arange(V, device=dev)[None, :]).to(
        torch.float32)                                   # (C, V)

    # fast side: winner-2b prefix columns.
    bwin = bucket_index(win, prec).long()
    fkey = (torch.arange(k2f, device=dev)[None, :] * (V + 1)
            + vkey[:, None]) * B + bwin
    FH = _count(fkey, k2f * (V + 1) * B).reshape(k2f, V + 1, B)[:, :V]
    hist_fast = _suffix(FH, 1)[q2f - 1, q2f]             # (M, B)
    sum_fast = _suffix(win.T @ oh, 1)[q2f - 1, q2f]      # (M,)
    Fmax = torch.full((V + 1, k2f), -math.inf, device=dev).scatter_reduce_(
        0, vkey[:, None].expand(C, k2f), win, "amax")[:V].T
    SFmax = torch.flip(torch.cummax(torch.flip(Fmax, (1,)), dim=1).values,
                       (1,))
    max_fast = SFmax[q2f - 1, q2f]
    n_fast = _suffix(_count(vkey, V + 1)[:V], 0)[q2f]

    # recovery side: (q1, q_rec) pair columns.
    t_rec = (draws["sorted_arrive"][:, pairs[:, 0] - 1]
             + draws["sorted_classic"][:, pairs[:, 1] - 1])   # (C, P)
    dec = t_rec < UNDECIDED_MS
    brec = torch.where(dec, bucket_index(t_rec, prec).long(), B)
    rkey = (torch.arange(P_, device=dev)[None, :] * (V + 1)
            + vkey[:, None]) * (B + 1) + brec
    RH = _count(rkey, P_ * (V + 1) * (B + 1)).reshape(P_, V + 1, B + 1)
    rec_rows = torch.cumsum(RH[:, :V], dim=1, dtype=torch.int32)[
        pair_of_m, q2f - 1]                              # (M, B + 1)
    hist_rec = rec_rows[:, :B]
    n_und = rec_rows[:, B]
    n_rec = hist_rec.sum(dim=-1, dtype=torch.int32)
    t_dec = torch.where(dec, t_rec, 0.0)
    sum_rec = torch.cumsum(t_dec.T @ oh, dim=1)[pair_of_m, q2f - 1]
    Rmax = torch.full((V + 1, P_), -math.inf, device=dev).scatter_reduce_(
        0, vkey[:, None].expand(C, P_),
        torch.where(dec, t_rec, -math.inf), "amax")[:V].T    # (P, V)
    max_rec = torch.cummax(Rmax, dim=1).values[pair_of_m, q2f - 1]

    n_valid = valid.sum().to(torch.int32).expand(q2f.shape)
    return state._absorb(
        n_trials=n_valid, n_fast=n_fast, n_recovery=n_rec,
        n_undecided=n_und, cnt=(n_fast + n_rec).to(torch.float32),
        lat_sum=sum_fast + sum_rec,
        lat_max=torch.maximum(max_fast, max_rec),
        hist=hist_fast + hist_rec)


def _race_fused_update(state: StreamSummary, gen, table, offsets, delay,
                       valid, *, n, k_proposers, chunk, k_sat,
                       recovery="coordinated") -> StreamSummary:
    """Masked-table race chunk through the fused stream_tally_decide_hist
    kernel: the raw (unsorted) draws go straight in; nothing sorted is ever
    materialized.  The kernel's recovery-commit operands are positional, so
    uncoordinated recovery feeds the phase-2f masks (and depth k2f) where
    coordinated feeds phase-2c."""
    raw = engine._draw_race(gen, offsets, delay, n=n,
                            k_proposers=k_proposers, samples=chunk,
                            recovery=recovery)
    if recovery == "uncoordinated":
        rec_w, rec_t = table["p2f_w"], table["p2f_t"]
        k_sat = (k_sat[0], k_sat[2], k_sat[2])
    else:
        rec_w, rec_t = table["p2c_w"], table["p2c_t"]
    hist, stats = qt_ops.stream_tally_decide_hist(
        raw["votes"], raw["val_arr"], raw["arrive"], raw["classic"],
        table["p1_w"], table["p1_t"], rec_w, rec_t,
        table["p2f_w"], table["p2f_t"], valid, n_values=k_proposers,
        k_sat=k_sat, precision=state.precision, bins=state.bins,
        undecided_ms=float(UNDECIDED_MS))
    return state._absorb(
        n_trials=stats["n_fast"] + stats["n_recovery"] + stats["n_undecided"],
        n_fast=stats["n_fast"], n_recovery=stats["n_recovery"],
        n_undecided=stats["n_undecided"],
        cnt=(stats["n_fast"] + stats["n_recovery"]).to(torch.float32),
        lat_sum=stats["sum_ms"], lat_max=stats["max_ms"], hist=hist)


# ---------------------------------------------------------------------------
# The chunk loop.
# ---------------------------------------------------------------------------

def _resolve_k_sat(table, k_max, n: int):
    """Normalize ``k_max`` to a ``(k1, k2c, k2f)`` tuple, or None (the
    full-sort reference path).  "auto" takes ``engine.saturation_depths``;
    an int caps all three phases; a 3-tuple must cover the depths and is
    clipped to [1, n]."""
    if k_max is None:
        return None
    if k_max == "auto":
        return engine.saturation_depths(table)
    if isinstance(k_max, int):
        k_max = (k_max, k_max, k_max)
    ks = tuple(int(k) for k in k_max)
    if len(ks) != 3:
        raise ValueError(f"k_max must be None, 'auto', an int or a "
                         f"(k1, k2c, k2f) triple, got {k_max!r}")
    depths = engine.saturation_depths(table)
    for req, need in zip(ks, depths):
        if req < need:
            raise ValueError(
                f"k_max={ks} below the table's saturation depths {depths}; "
                f"prefixes that short change results -- use 'auto'")
    return tuple(min(n, max(1, k)) for k in ks)


def _stream_entry(path: str, key: int, table, delay, offsets, *, n,
                  k_proposers, trials, chunk, precision, k_max="auto",
                  recovery="coordinated") -> StreamSummary:
    engine._check_mask_table(table, n)
    engine._check_recovery(recovery)
    if trials < 1:
        raise ValueError(f"trials must be >= 1, got {trials}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sketch_bins(precision)
    dev = engine._table_device(table)
    if trials <= chunk:
        # the materializing path is the T <= chunk case, on the same key.
        if path == "race":
            out = engine.race(key, table, offsets, delay, n=n,
                              k_proposers=k_proposers, samples=trials,
                              recovery=recovery)
        elif path == "fast_path":
            out = _lat_only_outcomes(
                engine.fast_path(key, table, delay, n=n, samples=trials),
                fast=True)
        else:
            out = _lat_only_outcomes(
                engine.classic_path(key, table, delay, n=n, samples=trials),
                fast=False)
        return StreamSummary.from_outcomes(out, precision)
    k_sat = _resolve_k_sat(table, k_max, n)
    card = "q" in table and k_sat is not None
    fused = path == "race" and "q" not in table and k_sat is not None
    layout = _card_layout(table, recovery) if card else None
    if delay is None:
        delay = default_delay()
    offsets = engine._offsets(offsets, dev)
    m = table["p1_w"].shape[0]
    state = StreamSummary.zeros(m, precision, dev)
    lanes = torch.arange(chunk, device=dev)
    for i in range(-(-trials // chunk)):
        gen = rng.generator(rng.derive(key, rng.CHUNK_DOMAIN, i), dev)
        valid = lanes < min(chunk, trials - i * chunk)
        if fused:
            state = _race_fused_update(state, gen, table, offsets, delay,
                                       valid, n=n, k_proposers=k_proposers,
                                       chunk=chunk, k_sat=k_sat,
                                       recovery=recovery)
        elif card and path == "race":
            state = _race_card_update(state, gen, table, layout, offsets,
                                      delay, valid, n=n,
                                      k_proposers=k_proposers, chunk=chunk,
                                      k_sat=k_sat, recovery=recovery)
        elif card and path == "fast_path":
            cols = engine._sorted_prefix(
                engine._fast_path_draws(gen, delay, n, chunk), k_sat[2])
            state = _cols_card_update(state, cols, table["q"][:, 2] - 1,
                                      valid, fast=True)
        elif card:                                     # classic_path
            d0, pathv = engine._classic_path_draws(gen, delay, n, chunk)
            cols = d0[:, None] + engine._sorted_prefix(pathv, k_sat[1])
            state = _cols_card_update(state, cols, table["q"][:, 1] - 1,
                                      valid, fast=False)
        else:
            out = _chunk_outcomes(path, gen, table, offsets, delay, n=n,
                                  k_proposers=k_proposers, chunk=chunk,
                                  k_sat=k_sat, recovery=recovery)
            state = state.update(out, valid)
    return state


def race_stream(key: int, table, offsets, delay=None, *, n: int,
                k_proposers: int, trials: int, chunk: int = DEFAULT_CHUNK,
                precision: float = DEFAULT_PRECISION, k_max="auto",
                recovery: str = "coordinated") -> StreamSummary:
    """``engine.race`` at any trial count in fixed memory, reduced into a
    ``StreamSummary`` on the table's device.  ``k_max`` ("auto" by default)
    selects the sort-free lowerings; ``None`` keeps the full-sort reference
    path.  Integer outputs are identical across settings."""
    return _stream_entry("race", key, table, delay, offsets, n=n,
                         k_proposers=k_proposers, trials=trials, chunk=chunk,
                         precision=precision, k_max=k_max, recovery=recovery)


def fast_path_stream(key: int, table, delay=None, *, n: int, trials: int,
                     chunk: int = DEFAULT_CHUNK,
                     precision: float = DEFAULT_PRECISION,
                     k_max="auto") -> StreamSummary:
    """Streamed conflict-free fast path: decided instances count as fast
    commits, lost ones as undecided."""
    return _stream_entry("fast_path", key, table, delay, None, n=n,
                         k_proposers=1, trials=trials, chunk=chunk,
                         precision=precision, k_max=k_max)


def classic_path_stream(key: int, table, delay=None, *, n: int, trials: int,
                        chunk: int = DEFAULT_CHUNK,
                        precision: float = DEFAULT_PRECISION,
                        k_max="auto") -> StreamSummary:
    """Streamed leader-relayed classic path: decided instances count as
    recoveries."""
    return _stream_entry("classic_path", key, table, delay, None, n=n,
                         k_proposers=1, trials=trials, chunk=chunk,
                         precision=precision, k_max=k_max)
