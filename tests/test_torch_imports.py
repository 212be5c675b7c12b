"""The port stands alone: every module of repro_torch, and chip_smoke,
imports without JAX and without the JAX package; the kernel layer imports
nothing of the port above it; entry points refuse to run on the CPU unless
asked; chip_smoke refuses to run without CUDA or without the repository
around it."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _run(code: str, cwd: str = ROOT, **env):
    e = dict(os.environ, PYTHONPATH=SRC, **env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    sys.path.insert(0, SRC)
    try:
        import repro_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch."))
    finally:
        sys.path.remove(SRC)
    assert "repro_torch.frontier.__main__" in names
    assert "repro_torch.kernels.quorum_tally.kernel" in names
    for name in ("repro_torch.launch.serve", "repro_torch.models.model",
                 "repro_torch.models.ssm", "repro_torch.models.layers",
                 "repro_torch.models.moe",
                 "repro_torch.models.convert",
                 "repro_torch.kernels.ssd_scan.kernel",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.rmsnorm.kernel",
                 "repro_torch.kernels.rmsnorm.ops",
                 "repro_torch.kernels.rmsnorm.ref",
                 "repro_torch.kernels._build",
                 "repro_torch.api", "repro_torch.api.experiment",
                 "repro_torch.api.__main__",
                 "repro_torch.core.protocol", "repro_torch.core.simulator",
                 "repro_torch.core.model_check",
                 "repro_torch.montecarlo.traces",
                 "repro_torch.montecarlo.regimes",
                 "repro_torch.montecarlo.scenarios",
                 "repro_torch.planner", "repro_torch.planner.search",
                 "repro_torch.planner.cache", "repro_torch.planner.service",
                 "repro_torch.planner.__main__", "repro_torch.cluster",
                 "repro_torch.cluster.coordinator",
                 "repro_torch.cluster.membership",
                 "repro_torch.cluster.failure",
                 "repro_torch.parallel", "repro_torch.parallel.sharding",
                 "repro_torch.parallel.distributed",
                 "repro_torch.training", "repro_torch.training.optimizer",
                 "repro_torch.training.trainer", "repro_torch.training.data",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.compress",
                 "repro_torch.launch.train", "repro_torch.launch.mesh",
                 "repro_torch.launch.abstract",
                 "repro_torch.launch.dryrun"):
        assert name in names
    code = f"""
import importlib, sys
sys.path.insert(0, {ROOT!r})
for name in {names!r} + ["chip_smoke"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("pkg", ["flash_attention", "quorum_tally",
                                 "rmsnorm", "ssd_scan"])
def test_kernel_package_imports_nothing_above_it(pkg):
    """A kernel package's ops, ref and kernel load no module of the port's
    upper layers: only ``repro_torch.kernels`` and ``repro_torch.sketch``."""
    code = f"""
import sys
for mod in ("ops", "ref", "kernel"):
    __import__("repro_torch.kernels.{pkg}." + mod)
above = ("montecarlo", "models", "frontier", "api", "planner", "training",
         "launch", "parallel")
loaded = sorted(m for m in sys.modules if m.startswith("repro_torch."))
print("ABOVE", [m for m in loaded if m.split(".")[1] in above])
print("OTHER", [m for m in loaded
                if m.split(".")[1] not in ("kernels", "sketch")])
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "ABOVE []" in proc.stdout and "OTHER []" in proc.stdout, \
        proc.stdout


def test_kernel_sketch_floor_is_the_sketch_modules():
    """``sketch_bucket`` in quorum_tally.cu hard-codes the sketch's floor;
    it must be ``repro_torch.sketch.SKETCH_MIN_MS``."""
    sys.path.insert(0, SRC)
    try:
        from repro_torch.sketch import SKETCH_MIN_MS
    finally:
        sys.path.remove(SRC)
    with open(os.path.join(SRC, "repro_torch", "kernels", "quorum_tally",
                           "csrc", "quorum_tally.cu")) as fh:
        src = fh.read()
    body = re.search(r"int sketch_bucket\(.*?\n}", src, re.S).group(0)
    floors = re.findall(r"fmaxf\(x, ([0-9.e+-]+)f\) / ([0-9.e+-]+)f", body)
    assert len(floors) == 1
    assert [float(v) for v in floors[0]] == [SKETCH_MIN_MS] * 2


def test_entry_points_without_device_raise_instead_of_running_on_cpu():
    code = """
import torch
assert not torch.cuda.is_available()
from repro_torch.core.quorum import QuorumSpec
from repro_torch.frontier import score_systems, cardinality_family
from repro_torch.frontier.__main__ import run_sweep
from repro_torch.montecarlo import engine
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch import serve
from repro_torch.models.model import DecoderLM
from repro_torch.api import Experiment, Workload, frontier, plan
from repro_torch.api import default_planner
from repro_torch.api.__main__ import main as api_main
from repro_torch.planner import Planner, PlannerServer
from repro_torch.planner.__main__ import main as planner_main
from repro_torch.parallel import distributed, sharding
from repro_torch.launch import train as launch_train
cfg = reduced_config(get_config("mamba2_130m"))
exp = Experiment(systems=[QuorumSpec(3, 2, 2, 3)],
                 workload=Workload.race(k=2))
for fn in (lambda: score_systems(cardinality_family(3), trials=10),
           lambda: exp.run("montecarlo"),
           lambda: Experiment.from_config(
               "examples/scenarios/trace_replay.json").run("montecarlo"),
           lambda: exp.frontier(trials=10),
           lambda: frontier([QuorumSpec(3, 2, 2, 3)], trials=10),
           lambda: exp.plan(trials=10),
           lambda: plan(n=3, trials=10),
           lambda: default_planner(),
           lambda: Planner(),
           lambda: PlannerServer(port=0),
           lambda: planner_main(["plan", "--n", "3", "--trials", "10"]),
           lambda: api_main(["--smoke"]),
           lambda: run_sweep(quick=True),
           lambda: sharding.trial_mesh(),
           lambda: distributed.selftest(),
           lambda: engine.build_mask_table([QuorumSpec(3, 2, 2, 3)]),
           lambda: serve.main(["--arch", "mamba2_130m", "--smoke"]),
           lambda: serve.main(["--arch", "zamba2_2_7b", "--smoke"]),
           lambda: DecoderLM(cfg),
           lambda: launch_train.main(["--arch", "olmo_1b", "--smoke"])):
    try:
        fn()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("ran without a device")
print("OK")
"""
    proc = _run(code, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr


def test_train_launcher_without_device_refuses_to_run_on_cpu():
    """``python -m repro_torch.launch.train`` without ``--device cpu``
    trains on the card or not at all."""
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "olmo_1b", "--smoke", "--steps", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "[train]" not in proc.stdout
    assert "device='cpu'" in proc.stderr


def test_chip_smoke_fails_without_cuda_and_prints_no_result():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA is not available" in proc.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
