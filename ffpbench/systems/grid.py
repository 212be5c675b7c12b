"""Every 3 x C grid with 3C <= n (the paper's Sec. 6 grid quorums), labelled
``grid.3x<C>``.  Acceptor r*C + c sits in row r, column c; the rest join no
quorum.  Phase 1: a full row and a full column; classic phase 2: a column;
fast phase 2: two full rows."""
from ffpbench.systems import rows_record


def port(entry: dict, n: int) -> list:
    from repro_torch.frontier import families
    return families.grid_family(n)


def _quorum(members, size: int) -> tuple:
    w = [0.0] * size
    for a in members:
        w[a] = 1.0
    return w, float(len(set(members)))


def reference(entry: dict, n: int) -> list:
    out = []
    for cols in range(1, n // 3 + 1):
        size = 3 * cols
        row = [[r * cols + c for c in range(cols)] for r in range(3)]
        col = [[r * cols + c for r in range(3)] for c in range(cols)]
        out.append(rows_record(f"grid.3x{cols}", n, {
            "p1": [_quorum(set(row[r]) | set(col[c]), size)
                   for r in range(3) for c in range(cols)],
            "p2c": [_quorum(col[c], size) for c in range(cols)],
            "p2f": [_quorum(set(row[a]) | set(row[b]), size)
                    for a in range(3) for b in range(3) if a < b]}))
    return out
