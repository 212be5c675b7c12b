"""Every cardinality triple (q1, q2c, q2f) that Fast Flexible Paxos admits
at n acceptors: q1 + q2c > n (Eq. 13) and q1 + 2 q2f > 2n (Eq. 14)."""
from ffpbench.systems import card_record


def port(entry: dict, n: int) -> list:
    from repro_torch.frontier import families
    return families.cardinality_family(n)


def reference(entry: dict, n: int) -> list:
    return [card_record(f"card[{q1},{q2c},{q2f}]", n, q1, q2c, q2f)
            for q1 in range(1, n + 1)
            for q2c in range(1, n + 1)
            for q2f in range(1, n + 1)
            if q1 + q2c > n and q1 + 2 * q2f > 2 * n]
