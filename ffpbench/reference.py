"""The plain reference: one request worked out again from its key.

Given the configuration file and the traffic mix, ``Reference.request(key)``
recomputes what a request of the program answers -- the per-system counts,
the DDSketch histogram and its quantile readout -- in plain PyTorch, one
chunk at a time, without importing anything of the program:

- draws: chunk c of a stream on ``key`` draws from a ``torch.Generator``
  seeded with ``keys.chunk_key(key, c)``, in the order the traffic's pass
  (``passes/<pass>.py``) sends its messages, with the configuration's
  delay model (``delays/<kind>.py``);
- decision: by the pass's rule (``passes/<pass>.py``), from the instants
  at which quorum rows saturate.  A row saturates at the earliest arrival
  by which the weight of the members arrived reaches its threshold (for an
  all-ones row: the q-th order statistic);
- sketch: each decided latency lands in the log bucket
  ``ceil(log(max(x, 1e-2) / 1e-2) / log(g))``, g = (1 + p) / (1 - p), and
  a quantile q reads the bucket where the cumulative count first reaches
  ``ceil(q * n)`` (float32, as the sketch states), at its centre
  ``2 * 1e-2 * g^i / (g + 1)``.

``dtype`` is the precision the delays are carried in after they are drawn:
float32 is the configuration's; bfloat16 is the control, which has to come
out not correct.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ffpbench import find, keys, systems

LOST_MS = 1e9
UNDECIDED_MS = LOST_MS / 2
SKETCH_MIN_MS = 1e-2
SKETCH_MAX_MS = 1e7
QUANTILES = (0.5, 0.99, 0.999)
COUNTS = ("n_trials", "n_fast", "n_recovery", "n_undecided")
BLOCK = 1 << 18             # trials decided at once


def sketch_gamma(precision: float) -> float:
    return (1.0 + precision) / (1.0 - precision)


def sketch_bins(precision: float) -> int:
    return int(math.ceil(math.log(SKETCH_MAX_MS / SKETCH_MIN_MS)
                         / math.log(sketch_gamma(precision)))) + 1


def bucket_of(x: torch.Tensor, precision: float, bins: int) -> torch.Tensor:
    """float32 bucket index of float32 latencies (true f32 divisions)."""
    lo = torch.full((), SKETCH_MIN_MS, dtype=torch.float32, device=x.device)
    lg = torch.full((), math.log(sketch_gamma(precision)),
                    dtype=torch.float32, device=x.device)
    i = torch.ceil(torch.log(torch.maximum(x, lo) / lo) / lg)
    return i.clamp(0, bins - 1).long()


def readout(hist: np.ndarray, precision: float) -> np.ndarray:
    """(len(QUANTILES), M) float64 quantiles of (M, B) bucket counts; NaN
    where nothing was decided."""
    g = sketch_gamma(precision)
    n = hist.sum(axis=1)
    cum = np.cumsum(hist, axis=1)
    out = np.full((len(QUANTILES), hist.shape[0]), np.nan)
    for a, q in enumerate(QUANTILES):
        for m in range(hist.shape[0]):
            if n[m] == 0:
                continue
            rank = np.ceil(np.float32(q) * np.float32(n[m]))
            rank = min(max(float(rank), 1.0), float(n[m]))
            i = int(np.argmax(cum[m] >= rank))
            out[a, m] = SKETCH_MIN_MS * 2.0 * g / (g + 1.0) * g ** (i - 1)
    return out


def _kth(sorted_x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(S, M) q-th smallest (1-indexed) of presorted (S, n) rows."""
    return sorted_x[:, q - 1]


class Reference:
    """The configuration's systems under the traffic's requests, in plain
    PyTorch on ``device``."""

    def __init__(self, config: dict, traffic: dict, device,
                 dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.n = int(config["n"])
        self.delay_cfg = config["delay"]
        self.delay = find.piece("delays", config["delay"]["kind"])
        self.traffic = traffic
        self.pass_ = find.piece("passes", traffic["pass"])
        self.K = int(traffic["k_proposers"])
        self.recovery = traffic["recovery"]
        self.chunk = int(traffic["chunk"])
        self.trials = int(traffic["trials_per_request"])
        self.precision = float(traffic["precision"])
        self.bins = sketch_bins(self.precision)
        recs = systems.reference_systems(config)
        self.labels: List[str] = [r["label"] for r in recs]
        self.card = [i for i, r in enumerate(recs) if r["card"] is not None]
        self.rows = [i for i, r in enumerate(recs) if r["card"] is None]
        dev = self.device
        q = np.array([recs[i]["card"] for i in self.card], np.int64)
        self.q = torch.as_tensor(q.reshape(-1, 3), device=dev)
        # every row system's quorum rows of a phase side by side: (n, R)
        # weights, (R,) thresholds, and each system's span of columns
        self.masks = {}
        for ph in ("p1", "p2c", "p2f"):
            ws = [recs[i][ph][0] for i in self.rows]
            ts = [recs[i][ph][1] for i in self.rows]
            ends = np.cumsum([len(t) for t in ts]).tolist()
            self.masks[ph] = (
                torch.as_tensor(np.concatenate(ws).T if ws else
                                np.zeros((self.n, 0)), device=dev),
                torch.as_tensor(np.concatenate(ts) if ts else np.zeros(0),
                                device=dev),
                list(zip([0] + ends[:-1], ends)))

    # -- helpers of the pass modules --------------------------------------
    def hop(self, gen, shape, hop: str) -> torch.Tensor:
        """One message leg's delays, carried in ``dtype``."""
        return self.delay.sample(gen, shape, hop, self.delay_cfg).to(
            self.dtype)

    @staticmethod
    def lost(x: torch.Tensor) -> torch.Tensor:
        return torch.where(x < UNDECIDED_MS, x, torch.full_like(x, LOST_MS))

    def sat(self, x: torch.Tensor, phase: str, col: int) -> torch.Tensor:
        """(S, M) instants at which each system's earliest quorum row of
        ``phase`` saturates in arrivals x (S, n); LOST_MS where none does.
        A row saturates at the earliest arrival x_j by which the weight of
        the members arrived (x_i <= x_j) reaches its threshold."""
        S = x.shape[0]
        out = torch.empty((S, len(self.labels)), dtype=x.dtype,
                          device=self.device)
        if self.card:
            srt = torch.sort(x, dim=-1).values
            out[:, self.card] = _kth(srt, self.q[:, col])
        if self.rows:
            w, t, spans = self.masks[phase]
            arrived = (x[:, None, :] <= x[:, :, None]).to(torch.float64)
            wsum = arrived @ w                               # (S, n, R)
            cand = torch.where(wsum >= t, x[:, :, None],
                               torch.full_like(x[:, :, None], LOST_MS))
            row_t = cand.amin(dim=1)                         # (S, R)
            for i, (a, b) in zip(self.rows, spans):
                out[:, i] = row_t[:, a:b].amin(dim=1)
        return out

    # -- one chunk, one request (the pass's module) -------------------------
    def draws(self, gen) -> Dict[str, torch.Tensor]:
        return self.pass_.draws(self, gen)

    def decide(self, draws: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """(S, M) latency and fast / recovery / undecided bits of a block
        of trials' draws."""
        return self.pass_.decide(self, draws)

    def request(self, key: int) -> Dict[str, np.ndarray]:
        """The request's answer: ``counts`` (4, M) int64 in ``COUNTS``
        order, ``hist`` (M, B) int64 and ``quantiles`` (3, M).  Each chunk
        is drawn whole, as the program draws it, and decided in blocks of
        ``BLOCK`` trials, so that the (trials, systems) arrays fit."""
        M, B = len(self.labels), self.bins
        hist = torch.zeros(M * B, dtype=torch.int64, device=self.device)
        counts = torch.zeros((4, M), dtype=torch.int64, device=self.device)
        offset = torch.arange(M, device=self.device)[None, :] * B
        for c in range(-(-self.trials // self.chunk)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(keys.chunk_key(key, c))
            d = self.draws(gen)
            live = min(self.chunk, self.trials - c * self.chunk)
            for a in range(0, live, BLOCK):
                out = self.decide({k: v[a:min(a + BLOCK, live)]
                                   for k, v in d.items()})
                fast, rec, und = (out["fast"], out["recovery"],
                                  out["undecided"])
                dec = fast | rec
                for i, bits in enumerate((dec | und, fast, rec, und)):
                    counts[i] += bits.sum(dim=0)
                b = bucket_of(out["latency"].to(torch.float32),
                              self.precision, B)
                hist += torch.bincount((b + offset)[dec], minlength=M * B)
        h = hist.reshape(M, B).cpu().numpy()
        return {"counts": counts.cpu().numpy(), "hist": h,
                "quantiles": readout(h, self.precision)}
