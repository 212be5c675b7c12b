"""Gifford-style weighted voting, labelled ``weighted.<h>x<w>.<level>``:
h heavy acceptors of weight w (``heavy_weight``), the rest weight 1, total
W.  Two phase-1 levels, ``p34`` t1 = ceil(3W/4) and ``p23`` t1 = floor(2W/3)
+ 1, each with the least t2c = W - t1 + 1 and t2f = floor((2W - t1)/2) + 1;
a repeated (weights, thresholds) is listed once."""
from ffpbench.systems import rows_record


def _params(entry: dict, n: int):
    hw = int(entry["heavy_weight"])
    seen = set()
    for h in entry["heavy_counts"]:
        if not 1 <= h < n:
            continue
        weights = [float(hw)] * h + [1.0] * (n - h)
        total = int(sum(weights))
        for tag, t1 in (("p34", -(-3 * total // 4)),
                        ("p23", (2 * total) // 3 + 1)):
            t2c = total - t1 + 1
            t2f = (2 * total - t1) // 2 + 1
            if not (1 <= t2c <= total and 1 <= t2f <= total):
                continue
            if (h, t1, t2c, t2f) in seen:
                continue
            seen.add((h, t1, t2c, t2f))
            yield f"weighted.{h}x{hw}.{tag}", weights, t1, t2c, t2f


def port(entry: dict, n: int) -> list:
    from repro_torch.frontier import families
    return families.weighted_family(n, tuple(entry["heavy_counts"]),
                                    int(entry["heavy_weight"]))


def reference(entry: dict, n: int) -> list:
    return [rows_record(label, n, {"p1": [(w, t1)], "p2c": [(w, t2c)],
                                   "p2f": [(w, t2f)]})
            for label, w, t1, t2c, t2f in _params(entry, n)]
