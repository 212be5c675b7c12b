"""The geo-replicated deployment ``geo15_eu_down``: 15 acceptors over five
WAN regions with one region down.  The reference's systems and delay
models against the program's, and what a tiny request of the cell
decides: every outcome occurs, and the grid whose columns are the regions
never decides."""
import json

import numpy as np
import pytest
import torch

from _ffpbench_cells import ROOT, SEED, tiny_cell
from ffpbench import keys, run, systems
from ffpbench.delays import crashed as ref_crashed
from ffpbench.delays import wan as ref_wan
from ffpbench.sut import Program

CELL = "geo15_eu_down.race_1m"
CONFIG = json.loads(
    (ROOT / "ffpbench" / "configs" / "geo15_eu_down.json").read_text())
HOPS = ("proposal", "to_learner", "from_coordinator", "to_coordinator")


def _rows(w, t):
    return sorted((tuple(np.asarray(wr, float)), float(tr))
                  for wr, tr in zip(w, t))


def test_reference_systems_are_the_programs():
    n = CONFIG["n"]
    ref = [(r["label"], r) for r in systems.reference_systems(CONFIG)]
    port = [(m.label, m.masks(n)) for m in systems.port_members(CONFIG)]
    assert [lab for lab, _ in ref] == [lab for lab, _ in port]
    assert len(ref) == CONFIG["n_systems"] == 663
    for (label, r), (_, m) in zip(ref, port):
        for ph in ("p1", "p2c", "p2f"):
            assert _rows(*r[ph]) == _rows(getattr(m, ph + "_w"),
                                          getattr(m, ph + "_t")), (label, ph)
        assert (r["card"] is None) == (m.cardinality_q() is None), label


def _program_delay(cfg):
    from repro_torch.montecarlo import latency
    return latency.delay_from_config(cfg, CONFIG["n"])


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("kind", ["wan", "crashed"])
def test_reference_delays_draw_the_programs_bits(kind, hop, K):
    cfg = CONFIG["delay"] if kind == "crashed" else CONFIG["delay"]["inner"]
    mod = ref_crashed if kind == "crashed" else ref_wan
    shape = (257, CONFIG["n"], K) if hop == "proposal" else (257,
                                                            CONFIG["n"])
    g_ref = torch.Generator().manual_seed(SEED + K)
    g_prog = torch.Generator().manual_seed(SEED + K)
    want = _program_delay(cfg).sample_hops(g_prog, shape, hop)
    got = mod.sample(g_ref, shape, hop, cfg)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    # the generators were left in the same state
    assert torch.equal(torch.rand(4, generator=g_ref),
                       torch.rand(4, generator=g_prog))
    if kind == "crashed":
        down = torch.tensor(cfg["crashed"], dtype=torch.bool)
        lost = got[:, down] if hop != "proposal" else got[:, down, :]
        assert bool((lost >= 1e9).all())
        assert bool((got[:, ~down] < 1e3).all())


@pytest.fixture(scope="module")
def tiny_answer():
    cell = tiny_cell(CELL)
    prog = Program(cell["config"], cell["traffic"], "cpu")
    q, c = prog.readout(prog.stream(keys.request_key(SEED, 0)))
    labels = list(prog.labels)
    prog.close()
    return labels, c


def test_every_outcome_occurs(tiny_answer):
    _, c = tiny_answer
    n_trials, n_fast, n_rec, n_und = c.sum(axis=1)
    assert n_trials == 2048 * 663
    assert n_fast > 0 and n_rec > 0 and n_und > 0
    assert n_fast + n_rec + n_und == n_trials


def test_the_region_grid_never_decides(tiny_answer):
    """grid.3x5's columns are the regions: every row holds an EU acceptor,
    so no fast quorum and no phase-1 quorum is ever full."""
    labels, c = tiny_answer
    g = labels.index("grid.3x5")
    assert c[0, g] == c[3, g] == 2048
    assert c[1, g] == c[2, g] == 0


def test_a_traced_run_reads_the_placement():
    """Through the harness on the CPU, where the delay is already on the
    table's device: a placement a request, and no copy."""
    r = run.run_cell(tiny_cell(CELL), SEED, 0.0, True, "cpu")
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    assert 0 < got["place_ms"] < 1e4
    assert got["host_writes_per_request"] == 0.0
