"""Crashed acceptors: the ``inner`` delay model's draws, with every hop to
or from an acceptor whose ``crashed`` entry is non-zero lost (``LOST_MS``):
a crashed acceptor never votes and its messages never arrive.  The hop
from a client to the leader touches no acceptor and keeps its draw.  Draws
nothing of its own."""
import torch

from ffpbench import find
from ffpbench.reference import LOST_MS

ACCEPTOR_HOPS = ("to_learner", "from_coordinator", "to_coordinator")


def sample(gen: torch.Generator, shape, hop: str, cfg: dict) -> torch.Tensor:
    inner = cfg["inner"]
    d = find.piece("delays", inner["kind"]).sample(gen, shape, hop, inner)
    down = torch.tensor([bool(c) for c in cfg["crashed"]], device=d.device)
    if hop == "proposal":
        mask = down[None, :, None]
    elif hop in ACCEPTOR_HOPS:
        mask = down[None, :]
    else:
        return d
    return torch.where(mask, torch.full_like(d, LOST_MS), d)
