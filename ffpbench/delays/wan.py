"""A WAN placement: one-way = base + exp(mu + sigma * z) ms, z standard
normal, drawn float32 with ``torch.randn`` from the hop's generator.  The
base is the table ``oneway_ms[from region][to region]`` gathered for the
hop's endpoints: proposer k (in region ``proposer_region[k mod len]``) to
acceptor a (in ``acceptor_region[a]``) for a proposal, (1, n, K); acceptor
to the learner's region (``learner_region``, the coordinator's too) for
``to_learner`` and ``to_coordinator``, (1, n); the learner's region to the
acceptor for ``from_coordinator``, (1, n); the first proposer's region to
the learner's for ``client_to_leader``, ()."""
import torch


def base(shape, hop: str, cfg: dict, device) -> torch.Tensor:
    """The hop's float32 base delays, broadcastable to ``shape``."""
    ow = torch.tensor(cfg["oneway_ms"], dtype=torch.float32, device=device)
    acc = torch.tensor(cfg["acceptor_region"], dtype=torch.long,
                       device=device)
    prop = torch.tensor(cfg["proposer_region"], dtype=torch.long,
                        device=device)
    lr = int(cfg["learner_region"])
    if hop == "proposal":
        k = torch.arange(int(shape[-1]), device=device) % prop.shape[0]
        return ow[prop[k][None, :], acc[:, None]][None]
    if hop in ("to_learner", "to_coordinator"):
        return ow[acc, lr][None]
    if hop == "from_coordinator":
        return ow[lr, acc][None]
    if hop == "client_to_leader":
        return ow[prop[0], lr]
    raise ValueError(f"unknown hop {hop!r}")


def sample(gen: torch.Generator, shape, hop: str, cfg: dict) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    b = base(shape, hop, cfg, gen.device)
    z = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return b + torch.exp(float(cfg["jitter_mu"])
                         + float(cfg["jitter_sigma"]) * z)
