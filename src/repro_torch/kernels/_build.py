"""Build a kernel's CUDA source into a shared library with ``nvcc``.

Each kernel package keeps its source under ``csrc/`` and calls ``build``
on first use.  The library goes into ``build/`` beside the package's
``kernel.py`` (git-ignored), named by a hash of the source, the shared
headers in ``include/`` (passed with ``-I``) and the flags, so an edited
source, header or flag builds anew and an unchanged one is reused.  There
is no fallback: without ``nvcc``, or when it fails, ``build`` raises.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
INCLUDE = Path(__file__).resolve().parent / "include"


def nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "their csrc/ sources on a machine with the CUDA "
                           "toolkit")
    return cand


def build(source: Path, name: str) -> Tuple[Path, str]:
    """Compile ``source`` into ``build/lib<name>_<hash>.so`` beside it,
    unless that library exists.  Returns (library path, compiler log; empty
    when nothing was built)."""
    src = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(INCLUDE.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    build_dir = source.parent.parent / "build"
    out = build_dir / f"lib{name}_{digest[:16]}.so"
    if out.exists():
        return out, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o",
                           str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
