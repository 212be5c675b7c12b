"""The port stands alone: every module of repro_torch, and chip_smoke,
imports without JAX and without the JAX package; entry points refuse to run
on the CPU unless asked; chip_smoke refuses to run without CUDA or without
the repository around it."""
import os
import pkgutil
import shutil
import subprocess
import sys

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


def test_entry_points_without_device_raise_instead_of_running_on_cpu():
    code = """
import torch
assert not torch.cuda.is_available()
from repro_torch.core.quorum import QuorumSpec
from repro_torch.frontier import score_systems, cardinality_family
from repro_torch.frontier.__main__ import run_sweep
from repro_torch.montecarlo import engine
for fn in (lambda: score_systems(cardinality_family(3), trials=10),
           lambda: run_sweep(quick=True),
           lambda: engine.build_mask_table([QuorumSpec(3, 2, 2, 3)])):
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
