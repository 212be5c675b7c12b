"""The system under test: the program's entry, as a user calls it.

Set-up builds the configuration's systems with the program's own family
constructors and their mask table once (``engine.build_mask_table``).  A
request is one streamed pass over every system of the table -- the
traffic's pass (``passes/<pass>.py``: ``streaming.race_stream`` or
``streaming.fast_path_stream``) with ``shard=False`` -- and its readout on
the host: the quantiles 0.5, 0.99 and 0.999 (``StreamSummary.quantile``)
and the four counts.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from ffpbench import find, systems
from ffpbench.reference import QUANTILES


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        t = time.perf_counter()
        from repro_torch.montecarlo import engine, latency, streaming
        self.timings = {"program_import_s": time.perf_counter() - t}
        t = time.perf_counter()
        self.device = torch.device(device)
        self.n = int(config["n"])
        members = systems.port_members(config)
        self.labels = [m.label for m in members]
        self.table = engine.build_mask_table(
            [m.masks(self.n) for m in members], device=self.device)
        delay = latency.delay_from_config(config["delay"], self.n)
        # the entry the window drives: stream(key) is one pass, a
        # StreamSummary on the card (its work may still be in flight)
        self.stream = find.piece("passes", traffic["pass"]).program(
            streaming, self.table, delay, traffic, self.device, n=self.n,
            trials=int(traffic["trials_per_request"]),
            chunk=int(traffic["chunk"]),
            precision=float(traffic["precision"]), shard=False)
        self.timings["table_s"] = time.perf_counter() - t

    @staticmethod
    def readout(s) -> Tuple[np.ndarray, np.ndarray]:
        """The answer on the host: (3, M) quantiles and (4, M) counts."""
        q = s.quantile(list(QUANTILES)).cpu().numpy()
        c = torch.stack([s.n_trials, s.n_fast, s.n_recovery,
                         s.n_undecided]).cpu().numpy()
        return q, c

    @staticmethod
    def hist(s) -> np.ndarray:
        return s.hist.cpu().numpy()

    def close(self) -> None:
        self.table = self.stream = None
