"""What a run loads and refuses: no JAX and no JAX package in a run's
process (checked in a subprocess, since the test workers import JAX from
other files), and no result without a card."""
import json
import os
import subprocess
import sys

from _ffpbench_cells import ROOT
from ffpbench import run

ONE_REQUEST = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from ffpbench import run
cell = run.load_cell("mixed_n12.race_2m")
cell["traffic"] = dict(cell["traffic"], chunk=512, trials_per_request=1024)
r = run.run_cell(cell, 7, 0.0, False, "cpu")
assert r["correct"], r
print(json.dumps(sorted(k for k in sys.modules)))
"""


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **kw)
    return env


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ONE_REQUEST.format(root=str(ROOT), src=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.montecarlo.streaming" in names
    assert run.loaded_forbidden(names) == []


def test_forbidden_names_are_compared_whole():
    assert run.loaded_forbidden(["repro_torch.frontier", "reproducible",
                                 "jaxtyping", "benchmarks_x"]) == []
    assert run.loaded_forbidden(["repro.core.quorum", "jax", "jaxlib.xla",
                                 "flax", "benchmarks.run"]) == [
        "benchmarks", "flax", "jax", "jaxlib", "repro"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "ffpbench/run.py", "--workload", "ffp_n11.race_4m",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "No result" in out.stderr
    assert not out.stdout.strip()
