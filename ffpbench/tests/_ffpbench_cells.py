"""Shared helpers of the benchmark's CPU tests: every cell of
``BENCHMARK.json`` cut to a tiny request (2 chunks of 1024 trials), which a
CPU test run can hold."""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:      # the program's sources
    sys.path.insert(0, str(ROOT / "src"))

from ffpbench import run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2 ** 31 + 12345


def tiny_cell(name: str, chunk: int = 1024, chunks: int = 2) -> dict:
    cell = run.load_cell(name)
    cell["traffic"] = dict(cell["traffic"], chunk=chunk,
                           trials_per_request=chunk * chunks)
    return cell
