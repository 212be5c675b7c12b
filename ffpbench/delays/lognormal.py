"""one-way = base_ms + exp(mu + sigma * z) ms, z standard normal, drawn
float32 with ``torch.randn`` from the hop's generator."""
import torch


def sample(gen: torch.Generator, shape, hop: str, cfg: dict) -> torch.Tensor:
    z = torch.randn(tuple(int(s) for s in shape), generator=gen,
                    device=gen.device, dtype=torch.float32)
    return float(cfg["base_ms"]) + torch.exp(float(cfg["mu"])
                                             + float(cfg["sigma"]) * z)
