"""One short run of every cell on the card, traced, through the harness's
whole path: the answers checked, the per-layer metrics read.  Skips without
a card; on the card: python -m pytest -q ffpbench/tests -m card"""
import pytest

from _ffpbench_cells import CELLS, SEED
from ffpbench import run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    cell = run.load_cell(name)
    r = run.run_cell(cell, SEED, 1.0, True, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == set(cell["per_layer"])
    for name, m in r["metrics"].items():
        if name.startswith("roofline."):
            assert 0 < m["value"] <= 100
