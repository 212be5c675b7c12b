"""Named cardinality systems at n acceptors, labelled ``card.<name>``:

paper_headline  q1 = n - max(1, floor(n/4)) (9 at n = 11, the paper's
                example), then the least q2c and q2f that Eqs. 13/14 allow
fast_paxos      Fast Paxos' three-quarter quorums: q1 = q2c = floor(n/2) + 1,
                q2f = ceil(3n/4)
majority_fast   majority fast quorums q2f = floor(n/2) + 1, which force
                q1 = 2n - 2 q2f + 1, and the least q2c
"""
from ffpbench.systems import card_record


def _triple(name: str, n: int) -> tuple:
    if name == "paper_headline":
        q1 = 9 if n == 11 else n - max(1, n // 4)
        return q1, n - q1 + 1, (2 * n - q1) // 2 + 1
    if name == "fast_paxos":
        return n // 2 + 1, n // 2 + 1, -(-3 * n // 4)
    if name == "majority_fast":
        q2f = n // 2 + 1
        q1 = 2 * n - 2 * q2f + 1
        return q1, n - q1 + 1, q2f
    raise ValueError(f"unknown landmark {name!r}")


def port(entry: dict, n: int) -> list:
    from repro_torch.core.quorum import QuorumSpec
    from repro_torch.frontier.families import Member
    return [Member(f"card.{name}", getattr(QuorumSpec, name)(n))
            for name in entry["names"]]


def reference(entry: dict, n: int) -> list:
    return [card_record(f"card.{name}", n, *_triple(name, n))
            for name in entry["names"]]
