"""The plain reference against the program on the CPU, at a tiny size, and
the comparison that decides ``correct`` failing its control and the faults
a cell can have."""
import numpy as np
import pytest
import torch

from _ffpbench_cells import CELLS, SEED, tiny_cell
from ffpbench import compare, run, systems
from ffpbench.control import Control


def _rows(w, t):
    return sorted((tuple(np.asarray(wr, float)), float(tr))
                  for wr, tr in zip(w, t))


@pytest.mark.parametrize("config", ["ffp_n11", "mixed_n12"])
def test_reference_builds_the_programs_systems(config):
    cell = run.load_cell(next(c for c in CELLS if c.startswith(config)))
    cfg = cell["config"]
    ref = {r["label"]: r for r in systems.reference_systems(cfg)}
    port = {m.label: m.masks(cfg["n"]) for m in systems.port_members(cfg)}
    assert set(ref) == set(port) and len(ref) == cfg["n_systems"]
    for label, m in port.items():
        for ph in ("p1", "p2c", "p2f"):
            assert _rows(*ref[label][ph]) == _rows(
                getattr(m, ph + "_w"), getattr(m, ph + "_t")), (label, ph)
        card = m.cardinality_q()
        assert (ref[label]["card"] is None) == (card is None)


@pytest.mark.parametrize("name", CELLS)
def test_program_matches_reference(name):
    r = run.run_cell(tiny_cell(name), SEED, 0.0, False, "cpu")
    assert r["correct"], r["checks"]
    v = {k: c["value"] for k, c in r["checks"].items()}
    assert v["count_gap"] == v["hist_gap"] == v["systems_missing"] == 0
    assert v["quantile_gap"] < 1e-4
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"trials_per_s", "request_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_in_the_programs_place_is_not_correct(name):
    r = run.run_cell(tiny_cell(name), SEED, 0.0, False, "cpu",
                     make_program=Control)
    assert not r["correct"]
    v = {k: c["value"] for k, c in r["checks"].items()}
    assert v["hist_gap"] > 0.01 and v["quantile_gap"] > 0.01


def _fault(kind, monkeypatch):
    """Break the program underneath the harness."""
    from repro_torch.montecarlo import streaming
    summ = streaming.StreamSummary
    absorb = summ._absorb

    if kind == "state_unchanged":          # a chunk step keeps its state
        monkeypatch.setattr(summ, "_absorb", lambda self, **kw: self)
    elif kind == "half_batch":             # half the trials left out
        def halve(fn):
            def call(*args, **kw):
                valid = args[-1]
                keep = torch.arange(valid.shape[-1]) < valid.shape[-1] // 2
                return fn(*args[:-1], valid & keep, **kw)
            return call
        for f in ("_race_card_update", "_race_fused_update",
                  "_cols_card_update"):
            monkeypatch.setattr(streaming, f, halve(getattr(streaming, f)))
        monkeypatch.setattr(summ, "update", halve(summ.update))
    elif kind == "answer_altered":         # one trial one bucket off
        def moved(self, **kw):
            h = kw["hist"].clone()
            b = int(h[0].argmax())
            h[0, b] -= 1
            h[0, b + 1] += 1
            return absorb(self, **dict(kw, hist=h))
        monkeypatch.setattr(summ, "_absorb", moved)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_faults_come_out_not_correct(name, kind, monkeypatch):
    _fault(kind, monkeypatch)
    r = run.run_cell(tiny_cell(name), SEED, 0.0, False, "cpu")
    assert not r["correct"], (kind, r["checks"])
    assert r["failed"] >= 1


def test_gaps_match_by_label_and_see_missing_systems():
    ans = {"counts": np.array([[4, 4], [3, 1], [1, 3], [0, 0]]),
           "hist": np.array([[0, 4, 0], [0, 1, 3]]),
           "quantiles": np.array([[1.0, 2.0]] * 3)}
    flip = {k: v[..., ::-1] if k != "hist" else v[::-1]
            for k, v in ans.items()}
    assert compare.gaps(["a", "b"], ans, ["b", "a"], flip) == {
        "systems_missing": 0.0, "count_gap": 0.0, "hist_gap": 0.0,
        "quantile_gap": 0.0}
    g = compare.gaps(["a", "c"], ans, ["a", "b"], ans)
    assert g["systems_missing"] == 2.0
    assert not compare.verdict(g)[0]
