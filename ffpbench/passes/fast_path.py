"""The conflict-free fast path: one proposal to every acceptor and its 2b
on to the learner; a request commits at the instant the earliest fast
quorum row of the arrivals saturates, and is undecided where none does.
Program entry: ``streaming.fast_path_stream``."""
import torch

from ffpbench.reference import UNDECIDED_MS


def program(streaming, table, delay, traffic: dict, device, **kw):
    return lambda key: streaming.fast_path_stream(key, table, delay, **kw)


def draws(ref, gen) -> dict:
    S, n = ref.chunk, ref.n
    d1 = ref.hop(gen, (S, n, 1), "proposal")[..., 0]
    d2 = ref.hop(gen, (S, n), "to_learner")
    return {"path": ref.lost(d1 + d2)}


def decide(ref, d: dict) -> dict:
    lat = ref.sat(d["path"], "p2f", 2)
    fast = lat < UNDECIDED_MS
    return {"latency": lat, "fast": fast,
            "recovery": torch.zeros_like(fast), "undecided": ~fast}
