"""The race: K proposers, offset by ``delta_ms`` each, send to every
acceptor; each votes for the first proposal to arrive (the lower proposer
on a tie).  A value commits fast at the earliest instant some fast quorum
row of its voters' 2b arrivals saturates; otherwise the request recovers
(``recovery``: coordinated through a phase-1 quorum and a classic phase-2
quorum of the coordinator's round trip, uncoordinated through a phase-1
and a fast quorum of the acceptors' direct sends).  Program entry:
``streaming.race_stream``."""
import torch

from ffpbench.reference import LOST_MS, UNDECIDED_MS

RECOVERY = ("coordinated", "uncoordinated")


def _offsets(traffic: dict, device) -> torch.Tensor:
    return float(traffic["delta_ms"]) * torch.arange(
        int(traffic["k_proposers"]), dtype=torch.float32, device=device)


def program(streaming, table, delay, traffic: dict, device, **kw):
    if traffic["recovery"] not in RECOVERY:
        raise ValueError(f"unknown recovery rule {traffic['recovery']!r}")
    offsets = _offsets(traffic, device)
    kw = dict(kw, k_proposers=int(traffic["k_proposers"]),
              recovery=traffic["recovery"])
    return lambda key: streaming.race_stream(key, table, offsets, delay, **kw)


def draws(ref, gen) -> dict:
    S, n, K = ref.chunk, ref.n, ref.K
    if ref.recovery not in RECOVERY:
        raise ValueError(f"unknown recovery rule {ref.recovery!r}")
    arrival = _offsets(ref.traffic, ref.device).to(ref.dtype) + ref.hop(
        gen, (S, n, K), "proposal")
    vote = torch.zeros((S, n), dtype=torch.long, device=ref.device)
    first = arrival[..., 0]
    for k in range(1, K):
        earlier = arrival[..., k] < first
        vote = torch.where(earlier, k, vote)
        first = torch.where(earlier, arrival[..., k], first)
    voted = first < UNDECIDED_MS
    d_ret = ref.hop(gen, (S, n), "to_learner")
    arrive = ref.lost(torch.where(voted, first + d_ret,
                                  torch.full_like(d_ret, LOST_MS)))
    d_2a = ref.hop(gen, (S, n), "from_coordinator")
    d_2b = ref.hop(gen, (S, n), "to_coordinator")
    classic = ref.lost(d_2b if ref.recovery == "uncoordinated"
                       else d_2a + d_2b)
    return {"vote": torch.where(voted, vote, -1), "arrive": arrive,
            "classic": classic}


def decide(ref, d: dict) -> dict:
    t_fast = None
    for v in range(ref.K):
        xv = torch.where(d["vote"] == v, d["arrive"],
                         torch.full_like(d["arrive"], LOST_MS))
        tv = ref.sat(xv, "p2f", 2)
        t_fast = tv if t_fast is None else torch.minimum(t_fast, tv)
    rec_phase, rec_col = (("p2c", 1) if ref.recovery == "coordinated"
                          else ("p2f", 2))
    t_rec = (ref.sat(d["arrive"], "p1", 0)
             + ref.sat(d["classic"], rec_phase, rec_col))
    fast = t_fast < UNDECIDED_MS
    lat = torch.where(fast, t_fast, t_rec)
    und = lat >= UNDECIDED_MS
    return {"latency": lat, "fast": fast, "recovery": ~fast & ~und,
            "undecided": und}
