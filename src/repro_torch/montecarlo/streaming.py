"""Streamed Monte-Carlo trials in fixed memory (``repro.montecarlo.streaming``).

The engine's materializing entry points hold an (M, S) array per output.
Here the same per-chunk computation becomes a reduction: a Python loop
draws, decides and reduces one chunk of trials at a time into a fixed-size
``StreamSummary`` -- counts, a running mean and max, and a DDSketch
log-bucket histogram (format: ``repro_torch.sketch``) whose quantiles carry
a guaranteed relative error (``precision``).  Counts and histograms are
integers, so merges are exact.

Chunk c draws from the generator of ``rng.derive(key, CHUNK_DOMAIN, c)``;
the last chunk's overhang is masked out by a validity vector.  A stream of
``trials <= chunk`` runs the engine's materializing entry point on ``key``
itself and reduces its output.

Per chunk, the loop picks one lowering from what it can observe:

  cardinality table ("q") + k_max   sort-free shared-column reductions:
                                    ``_race_card_update`` (race_card_hist
                                    kernel) / ``_cols_card_update``
  masked table, race, k_max         ``_race_fused_update``: the raw chunk
                                    goes through the fused
                                    stream_tally_decide_hist kernel
  k_max=None, or masked fast /      materialized (M, chunk) outcomes +
  classic paths                     ``StreamSummary.update``

Decide bits, counts, histograms and maxima are identical across lowerings;
only the f32 latency sum (hence the mean) accumulates in another order.

``shard=`` splits the trials over a trial mesh (``parallel.sharding``),
as JAX's per-device body does: domain d of D streams ``T // D + (d < T %
D)`` trials under key ``rng.derive(key, DEVICE_FOLD_DOMAIN, d)`` (never
the materializing shortcut; an empty domain launches nothing), and the
domains merge as JAX's ``axis_merge`` does (``_mesh_merge``), across
processes over gloo.  Everything derives from the global domain index, so
any process layout of the same D gives the same summary, bit for bit.

``regimes=`` (a ``regimes.MarkovRegimes`` or its config) Markov-modulates
a stream through failure epochs and returns a ``RegimeStreamSummary``.
Such a run mixes environments within a chunk, which the card and fused
lowerings cannot take (they assume one environment a chunk), so it always
decides through the materialized outcomes (``engine._race_outcomes``: the
tally_decide or masked_tally kernel on the card) and reduces them into R
per-regime slices at once.  Trial t's regime is ``zs[t // epoch_trials]``
in trial-index space, so occupancy does not depend on ``chunk``; even
``trials <= chunk`` runs the chunk loop.

Run under ``torch.profiler``, a streamed request marks its stages as
``repro_torch.tracing`` spans: ``stream`` (the call), ``prepare`` (up to
the first chunk, its ``host_read`` spans inside), and a chunk's ``draws``,
``decide`` and ``sketch``; ``StreamSummary.quantile`` is a ``readout``.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, replace
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels.quorum_tally import ops as qt_ops
from repro_torch.parallel import sharding as psharding
# The sketch's format; its names stay reachable here, as in
# repro.montecarlo.streaming.
from repro_torch.sketch import (DEFAULT_PRECISION, SKETCH_MAX_MS,  # noqa: F401
                                SKETCH_MIN_MS, bucket_index, bucket_value,
                                occurrences, sketch_bins, sketch_gamma)

from . import engine, rng
from . import latency as lat_mod
from .engine import UNDECIDED_MS
from .latency import default_delay
from .regimes import MarkovRegimes, RegimeStreamSummary

DEFAULT_CHUNK = 65536


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
        bool mask (False = padding trial, contributes nothing).  A summary
        stacked over R regimes takes an (R, C) ``valid``, one row a
        regime."""
        with tracing.span(tracing.SKETCH):
            lat = out["latency_ms"]
            v = valid[..., None, :]
            fast = out["reached_fast"] & v
            rec = out["recovery"] & v
            und = out["undecided"] & v
            decided = fast | rec
            idx = bucket_index(lat, self.precision).long().expand(
                decided.shape)
            hist = torch.zeros_like(self.hist).scatter_add_(
                -1, idx, decided.to(torch.int32))
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
        with tracing.span(tracing.READOUT):
            scalar = np.ndim(q) == 0
            qv = torch.as_tensor(np.atleast_1d(np.asarray(q, np.float32))
                                 ).to(self.hist.device)
            n = self.n_decided
            cum = torch.cumsum(self.hist, dim=-1, dtype=torch.int32)
            rank = torch.ceil(qv[:, None] * n[None, :]).clamp(min=1.0)
            rank = torch.minimum(rank, n.clamp(min=1)[None, :].to(rank.dtype))
            idx = torch.argmax((cum[None, :, :] >= rank[:, :, None]).to(
                torch.int32), dim=-1)
            val = torch.where(n[None, :] > 0,
                              bucket_value(idx, self.precision), torch.nan)
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
    """(M, chunk) outcomes of the materialized lowering: one ``decide``
    span, the chunk's ``draws`` inside it."""
    with tracing.span(tracing.DECIDE):
        if path == "race":
            return engine._race_outcomes(gen, table, offsets, delay, n=n,
                                         k_proposers=k_proposers,
                                         samples=chunk, k_sat=k_sat,
                                         recovery=recovery)
        if path == "fast_path":
            return _lat_only_outcomes(
                engine._fast_path_outcomes(gen, table, delay, n=n,
                                           samples=chunk, k_sat=k_sat),
                fast=True)
        return _lat_only_outcomes(
            engine._classic_path_outcomes(gen, table, delay, n=n,
                                          samples=chunk, k_sat=k_sat),
            fast=False)


def _suffix(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim=dim,
                                   dtype=x.dtype), (dim,))


def _card_layout(table, recovery: str = "coordinated") -> tuple:
    """Distinct (q1, q_rec) recovery pairs (P, 2) int32 of a cardinality
    table and each system's pair id (M,); q_rec is q2c under coordinated
    recovery, q2f under uncoordinated.  Recovery latency depends on a system
    only through this pair."""
    q = engine._to_host(table["q"])
    cols = [0, 1] if recovery == "coordinated" else [0, 2]
    pairs, inv = np.unique(q[:, cols], axis=0, return_inverse=True)
    dev = table["q"].device
    return (torch.as_tensor(pairs, dtype=torch.int32).to(dev),
            torch.as_tensor(inv.reshape(-1), dtype=torch.long).to(dev))


def _cols_card_update(state: StreamSummary, cols: torch.Tensor,
                      col_of_m: torch.Tensor, valid: torch.Tensor, *,
                      fast: bool) -> StreamSummary:
    """Absorb a chunk whose per-system latency is one of ``Kc`` shared
    columns, ``lat[m, c] = cols[c, col_of_m[m]]``: one (Kc, bins) histogram
    plus per-column sum / max, then a gather per system."""
    with tracing.span(tracing.SKETCH):
        B = state.bins
        Kc = cols.shape[1]
        und = cols >= UNDECIDED_MS
        bkey = torch.where(und, B, bucket_index(cols, state.precision).long())
        bkey = torch.where(valid[:, None], bkey, B + 1)
        flat = torch.arange(Kc, device=cols.device)[None, :] * (B + 2) + bkey
        LH = occurrences(flat, Kc * (B + 2)).reshape(Kc, B + 2)
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
    maxima.  The raw draws go through the race_card_hist kernel, which
    tallies, decides and reduces the chunk into those per-slot tensors;
    the gathers here are the same on the CPU and the card."""
    raw = engine._draw_race(gen, offsets, delay, n=n,
                            k_proposers=k_proposers, samples=chunk,
                            recovery=recovery)
    if recovery == "uncoordinated":
        k_sat = (k_sat[0], k_sat[2], k_sat[2])
    pairs, pair_of_m = layout
    B = state.bins
    with tracing.span(tracing.DECIDE):
        FH, Fsum, Fmax, cnt, RH, Rsum, Rmax = qt_ops.race_card_hist(
            raw["votes"], raw["arrive"], raw["classic"], valid, pairs,
            n_values=k_proposers, k_sat=k_sat, precision=state.precision,
            bins=B, undecided_ms=float(UNDECIDED_MS))

    with tracing.span(tracing.SKETCH):
        q2f = table["q"][:, 2].long()
        # fast side: winner-2b prefix columns.
        hist_fast = _suffix(FH, 1)[q2f - 1, q2f]             # (M, B)
        sum_fast = _suffix(Fsum, 1)[q2f - 1, q2f]            # (M,)
        SFmax = torch.flip(torch.cummax(torch.flip(Fmax, (1,)),
                                        dim=1).values, (1,))
        max_fast = SFmax[q2f - 1, q2f]
        n_fast = _suffix(cnt, 0)[q2f]

        # recovery side: (q1, q_rec) pair columns.
        rec_rows = torch.cumsum(RH, dim=1, dtype=torch.int32)[
            pair_of_m, q2f - 1]                              # (M, B + 1)
        hist_rec = rec_rows[:, :B]
        n_und = rec_rows[:, B]
        n_rec = hist_rec.sum(dim=-1, dtype=torch.int32)
        sum_rec = torch.cumsum(Rsum, dim=1)[pair_of_m, q2f - 1]
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
    with tracing.span(tracing.DECIDE):
        hist, stats = qt_ops.stream_tally_decide_hist(
            raw["votes"], engine._val_arr(raw, k_proposers), raw["arrive"],
            raw["classic"], table["p1_w"], table["p1_t"], rec_w, rec_t,
            table["p2f_w"], table["p2f_t"], valid, n_values=k_proposers,
            k_sat=k_sat, precision=state.precision, bins=state.bins,
            undecided_ms=float(UNDECIDED_MS))
    with tracing.span(tracing.SKETCH):
        return state._absorb(
            n_trials=(stats["n_fast"] + stats["n_recovery"]
                      + stats["n_undecided"]),
            n_fast=stats["n_fast"], n_recovery=stats["n_recovery"],
            n_undecided=stats["n_undecided"],
            cnt=(stats["n_fast"] + stats["n_recovery"]).to(torch.float32),
            lat_sum=stats["sum_ms"], lat_max=stats["max_ms"], hist=hist)


# ---------------------------------------------------------------------------
# Markov-modulated regimes: the chunk loop through failure epochs.
# ---------------------------------------------------------------------------

def _regime_zeros(regimes: MarkovRegimes, m: int, precision: float,
                  device) -> RegimeStreamSummary:
    """The merge identity: zero occupancy, R zero summaries stacked."""
    r = regimes.n_regimes
    z = StreamSummary.zeros(m, precision, device)
    return RegimeStreamSummary(
        names=regimes.names,
        occupancy=torch.zeros((r,), dtype=torch.int32, device=device),
        by_regime=replace(z, **{f: torch.stack([getattr(z, f)] * r)
                                for f in _FIELDS}))


def _regime_stream(path: str, key: int, table, offsets,
                   regimes: MarkovRegimes, *, n, k_proposers, trials, chunk,
                   precision, k_sat, recovery) -> RegimeStreamSummary:
    """The chunk loop under a Markov regime chain, its delays already on
    the table's device.

    The chain ``zs`` covers the loop's trial capacity, computed on the host
    once and moved to the device once; chunk c keeps the i.i.d. stream's
    generator, samples every hop under the mixed environment, decides
    once and reduces into the R slices by the regime-selected validity
    rows."""
    dev = engine._table_device(table)
    m = table["p1_w"].shape[0]
    r, ep = regimes.n_regimes, regimes.epoch_trials
    n_chunks = -(-trials // chunk)
    n_epochs = -(-(n_chunks * chunk) // ep)
    zs = regimes.sequence(key, n_epochs).to(dev)
    state = _regime_zeros(regimes, m, precision, dev)
    occ, by = state.occupancy, state.by_regime
    lanes = torch.arange(chunk, device=dev)
    regs = torch.arange(r, device=dev)[:, None]
    for i in range(n_chunks):
        gen = rng.generator(rng.derive(key, rng.CHUNK_DOMAIN, i), dev)
        tidx = i * chunk + lanes
        rid = zs[torch.div(tidx, ep, rounding_mode="floor")]
        out = _chunk_outcomes(path, gen, table, offsets,
                              regimes.mixed_delay(rid), n=n,
                              k_proposers=k_proposers, chunk=chunk,
                              k_sat=k_sat, recovery=recovery)
        sel = (tidx < trials)[None, :] & (rid[None, :] == regs)   # (R, C)
        by = by.update(out, sel)
        occ = occ + sel.sum(dim=1, dtype=torch.int32)
    return RegimeStreamSummary(names=regimes.names, occupancy=occ,
                               by_regime=by)


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


def _resolve_mesh(shard, device) -> Optional[psharding.TrialMesh]:
    """``shard=True`` -> the global trial mesh on ``device`` when it has
    more than one domain, else unsharded with a ``UserWarning`` (so a
    launch script that forgot ``distributed.initialize()`` or the domain
    count fails loudly rather than quietly running on one); ``False`` /
    ``None`` -> unsharded, silently; an explicit ``TrialMesh`` is honored
    as it is, 1-domain included."""
    if shard is False or shard is None:
        return None
    if shard is True:
        mesh = psharding.trial_mesh(device)
        if mesh.size > 1:
            return mesh
        warnings.warn(
            f"shard=True but only {mesh.size} device is visible - running "
            f"unsharded. For a multi-process grid call "
            f"repro_torch.parallel.distributed.initialize() before any CUDA "
            f"work; for several domains a process set "
            f"{psharding.ENV_DOMAINS_PER_PROCESS}; pass shard=False to "
            f"silence.", UserWarning, stacklevel=4)
        return None
    if isinstance(shard, psharding.TrialMesh):
        return shard
    raise TypeError(f"shard must be a bool, None or a TrialMesh, got "
                    f"{type(shard).__name__}")


def _mesh_merge(parts, mesh: psharding.TrialMesh, device) -> StreamSummary:
    """The cross-domain merge of JAX's ``axis_merge``: counts and the
    histogram by SUM, ``max_ms`` by MAX, the mean as the SUM of
    ``mean * n`` over the SUM of ``n`` (0 where nothing decided).
    ``parts`` are this process's domain summaries in global order; the
    per-domain products are summed in global domain order on every
    process, so any process layout of the same D merges to the same
    bits."""
    parts = [replace(p, **{f: getattr(p, f).to(device) for f in _FIELDS})
             for p in parts]
    out = {f: psharding.all_reduce(
        torch.stack([getattr(p, f) for p in parts]).sum(0, dtype=torch.int32),
        mesh, "sum")
        for f in ("n_trials", "n_fast", "n_recovery", "n_undecided", "hist")}
    out["max_ms"] = psharding.all_reduce(
        torch.stack([p.max_ms for p in parts]).amax(0), mesh, "max")
    rows = torch.zeros((2, mesh.size) + tuple(parts[0].mean_ms.shape),
                       dtype=torch.float32, device=device)
    for (g, _), p in zip(mesh.domains, parts):
        n_dec = p.n_decided.to(torch.float32)
        rows[0, g] = p.mean_ms * n_dec
        rows[1, g] = n_dec
    rows = psharding.all_reduce(rows, mesh, "sum")   # one term a row: exact
    wsum, tot = rows[0, 0], rows[1, 0]
    for g in range(1, mesh.size):
        wsum, tot = wsum + rows[0, g], tot + rows[1, g]
    out["mean_ms"] = torch.where(tot > 0, wsum / tot.clamp(min=1.0), 0.0)
    return replace(parts[0], **out)


def _stream_entry(path: str, key: int, table, delay, offsets, *, n,
                  k_proposers, trials, chunk, precision, shard=True,
                  k_max="auto", regimes=None, recovery="coordinated"):
    with tracing.span(tracing.STREAM):
        with tracing.span(tracing.PREPARE):
            engine._check_mask_table(table, n)
            engine._check_recovery(recovery)
            if trials < 1:
                raise ValueError(f"trials must be >= 1, got {trials}")
            if chunk < 1:
                raise ValueError(f"chunk must be >= 1, got {chunk}")
            sketch_bins(precision)
            dev = engine._table_device(table)
            if regimes is not None:
                if isinstance(regimes, dict):
                    regimes = MarkovRegimes.from_config(regimes, n)
                regimes = regimes.validate().bound(
                    delay if delay is not None else default_delay())
            mesh = _resolve_mesh(shard, dev)
            kw = dict(n=n, k_proposers=k_proposers, chunk=chunk,
                      precision=precision, k_max=k_max, regimes=regimes,
                      recovery=recovery)
            if mesh is None:
                run = _domain_plan(path, key, table, delay, offsets,
                                   trials=trials, materialize=True, **kw)
        if mesh is None:
            return run()
        # JAX's per-device body: domain d of D streams its own share of the
        # trials under its own key; an empty domain is the merge identity
        # and launches nothing.
        m = table["p1_w"].shape[0]
        parts = []
        for g, ddev in mesh.domains:
            t_d = trials // mesh.size + (1 if g < trials % mesh.size else 0)
            if t_d == 0:
                parts.append(StreamSummary.zeros(m, precision, dev)
                             if regimes is None
                             else _regime_zeros(regimes, m, precision, dev))
                continue
            parts.append(_domain_plan(
                path, rng.derive(key, rng.DEVICE_FOLD_DOMAIN, g),
                {k: v.to(ddev) for k, v in table.items()}, delay, offsets,
                trials=t_d, materialize=False, **kw)())
        if regimes is None:
            return _mesh_merge(parts, mesh, dev)
        occ = psharding.all_reduce(
            torch.stack([p.occupancy.to(dev) for p in parts]).sum(
                0, dtype=torch.int32), mesh, "sum")
        return RegimeStreamSummary(
            names=regimes.names, occupancy=occ,
            by_regime=_mesh_merge([p.by_regime for p in parts], mesh, dev))


def _domain_plan(path: str, key: int, table, delay, offsets, *, n,
                 k_proposers, trials, chunk, precision, k_max, regimes,
                 recovery, materialize: bool):
    """Does what one domain's stream does before its first chunk -- the
    saturation depths, the card layout, placing the delay and the offsets,
    the zero summary -- and returns the call that streams the chunks.
    ``materialize`` (unsharded runs only, as in JAX) lets ``trials <=
    chunk`` take the engine's materializing entry point."""
    dev = engine._table_device(table)
    if regimes is not None:
        with tracing.span(tracing.PLACE):
            regimes = replace(regimes, delays=tuple(
                lat_mod.to_device(d, dev) for d in regimes.delays))
        offsets = engine._offsets(offsets, dev)
        k_sat = _resolve_k_sat(table, k_max, n)
        return lambda: _regime_stream(
            path, key, table, offsets, regimes, n=n, k_proposers=k_proposers,
            trials=trials, chunk=chunk, precision=precision, k_sat=k_sat,
            recovery=recovery)
    if materialize and trials <= chunk:
        return lambda: _materialized(path, key, table, delay, offsets, n=n,
                                     k_proposers=k_proposers, trials=trials,
                                     precision=precision, recovery=recovery)
    k_sat = _resolve_k_sat(table, k_max, n)
    card = "q" in table and k_sat is not None
    fused = path == "race" and "q" not in table and k_sat is not None
    layout = _card_layout(table, recovery) if card else None
    with tracing.span(tracing.PLACE):
        delay = lat_mod.to_device(
            default_delay() if delay is None else delay, dev)
    offsets = engine._offsets(offsets, dev)
    zero = StreamSummary.zeros(table["p1_w"].shape[0], precision, dev)
    lanes = torch.arange(chunk, device=dev)

    def chunks() -> StreamSummary:
        state = zero
        for i in range(-(-trials // chunk)):
            gen = rng.generator(rng.derive(key, rng.CHUNK_DOMAIN, i), dev)
            valid = lanes < min(chunk, trials - i * chunk)
            if fused:
                state = _race_fused_update(
                    state, gen, table, offsets, delay, valid, n=n,
                    k_proposers=k_proposers, chunk=chunk, k_sat=k_sat,
                    recovery=recovery)
            elif card and path == "race":
                state = _race_card_update(
                    state, gen, table, layout, offsets, delay, valid, n=n,
                    k_proposers=k_proposers, chunk=chunk, k_sat=k_sat,
                    recovery=recovery)
            elif card and path == "fast_path":
                draws = engine._fast_path_draws(gen, delay, n, chunk)
                with tracing.span(tracing.DECIDE):
                    cols = engine._sorted_prefix(draws, k_sat[2])
                state = _cols_card_update(state, cols, table["q"][:, 2] - 1,
                                          valid, fast=True)
            elif card:                                     # classic_path
                d0, pathv = engine._classic_path_draws(gen, delay, n, chunk)
                with tracing.span(tracing.DECIDE):
                    cols = d0[:, None] + engine._sorted_prefix(pathv,
                                                               k_sat[1])
                state = _cols_card_update(state, cols, table["q"][:, 1] - 1,
                                          valid, fast=False)
            else:
                out = _chunk_outcomes(path, gen, table, offsets, delay, n=n,
                                      k_proposers=k_proposers, chunk=chunk,
                                      k_sat=k_sat, recovery=recovery)
                state = state.update(out, valid)
        return state
    return chunks


def _materialized(path: str, key: int, table, delay, offsets, *, n,
                  k_proposers, trials, precision, recovery) -> StreamSummary:
    """The T <= chunk case: the engine's materializing entry point on the
    same key, reduced."""
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


def race_stream(key: int, table, offsets, delay=None, *, n: int,
                k_proposers: int, trials: int, chunk: int = DEFAULT_CHUNK,
                precision: float = DEFAULT_PRECISION, shard=True,
                k_max="auto", regimes=None, recovery: str = "coordinated"):
    """``engine.race`` at any trial count in fixed memory, reduced into a
    ``StreamSummary`` on the table's device.  ``shard`` splits the trials
    over the trial mesh's domains (``True``: the global mesh, unsharded
    with a warning when it has one domain; ``False`` / ``None``:
    unsharded; or an explicit ``parallel.sharding.TrialMesh``).  ``k_max``
    ("auto" by default) selects the sort-free lowerings; ``None`` keeps the
    full-sort reference path.  Integer outputs are identical across
    settings.  ``regimes`` (a ``MarkovRegimes`` or its config) returns a
    ``RegimeStreamSummary``."""
    return _stream_entry("race", key, table, delay, offsets, n=n,
                         k_proposers=k_proposers, trials=trials, chunk=chunk,
                         precision=precision, shard=shard, k_max=k_max,
                         regimes=regimes, recovery=recovery)


def fast_path_stream(key: int, table, delay=None, *, n: int, trials: int,
                     chunk: int = DEFAULT_CHUNK,
                     precision: float = DEFAULT_PRECISION,
                     shard=True, k_max="auto", regimes=None):
    """Streamed conflict-free fast path: decided instances count as fast
    commits, lost ones as undecided.  ``shard`` and ``regimes`` as in
    ``race_stream``."""
    return _stream_entry("fast_path", key, table, delay, None, n=n,
                         k_proposers=1, trials=trials, chunk=chunk,
                         precision=precision, shard=shard, k_max=k_max,
                         regimes=regimes)


def classic_path_stream(key: int, table, delay=None, *, n: int, trials: int,
                        chunk: int = DEFAULT_CHUNK,
                        precision: float = DEFAULT_PRECISION,
                        shard=True, k_max="auto", regimes=None):
    """Streamed leader-relayed classic path: decided instances count as
    recoveries.  ``shard`` and ``regimes`` as in ``race_stream``."""
    return _stream_entry("classic_path", key, table, delay, None, n=n,
                         k_proposers=1, trials=trials, chunk=chunk,
                         precision=precision, shard=shard, k_max=k_max,
                         regimes=regimes)
