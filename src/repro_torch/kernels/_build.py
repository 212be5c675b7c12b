"""Build a kernel's CUDA source into a shared library with ``nvcc``, and
bind it with ``ctypes``.

Each kernel package keeps its source under ``csrc/`` and builds it on first
use.  The library goes into ``build/`` beside the package's ``kernel.py``
(git-ignored), named by a hash of the source, the shared headers in
``include/`` (passed with ``-I``) and the flags, so an edited source, header
or flag builds anew and an unchanged one is reused.  There is no fallback:
without ``nvcc``, or when it fails, ``build`` raises.

Each package's ``kernel.py`` holds one ``Library``: its C entry points'
signatures, its launch counters, its launch plans and the one way its
wrappers call the card (``Library.launch``).  Nothing is built or loaded at
import: the packages import on a machine without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import pkgutil
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

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


def libraries() -> list:
    """The ``Library`` of every kernel package here (each ``kernel.LIB``),
    in name order."""
    return [importlib.import_module(f"{__package__}.{m.name}.kernel").LIB
            for m in pkgutil.iter_modules([str(Path(__file__).parent)])
            if m.ispkg]


def check(t: torch.Tensor, name: str, dtype, shape, device,
          rows: bool = False) -> None:
    """Raise ValueError unless ``t`` lies on ``device``, has ``dtype`` (or,
    given a tuple, one of its dtypes) and ``shape``, and is contiguous or,
    with ``rows``, contiguous along its last axis."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if isinstance(dtype, tuple):
        if t.dtype not in dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                             f"{dtype}")
    elif t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if rows:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along its last "
                             f"axis, has strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class Library:
    """One kernel package's CUDA library: built from ``source`` as
    ``name`` on first use, its C entry points bound from ``signatures``
    (``{entry point: (argument types, result type)}``), and ``LAUNCHES``
    counting its launches under ``launches``' names.

    A launch plan is what a plan entry point writes, for one shape, into
    the array its last argument type declares (``ctypes.c_longlong * 5``,
    say); ``plan`` asks for it once per kind, device and shape and keeps
    it.  ``built()`` counts the loaded library and the kept plans.
    """

    def __init__(self, source: Path, name: str, signatures: Dict[str, tuple],
                 launches: Iterable[str]):
        self.source, self.name, self.signatures = source, name, signatures
        self.LAUNCHES: Dict[str, int] = dict.fromkeys(launches, 0)
        self.lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self._plans: Dict[tuple, tuple] = {}

    def build(self) -> Tuple[Path, str]:
        """Compile the source unless an up-to-date library exists.  Returns
        (library path, compiler log; empty when nothing was built)."""
        return build(self.source, self.name)

    def bind(self, path) -> ctypes.CDLL:
        """The library at ``path`` (any build of the source) with its entry
        points' argument and result types."""
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in self.signatures.items():
            f = getattr(lib, fn)
            f.argtypes, f.restype = argtypes, restype
        return lib

    def load(self) -> ctypes.CDLL:
        """The bound library, built and loaded by the first caller; later
        calls read it without taking the lock."""
        lib = self.lib
        if lib is None:
            with self._lock:
                if self.lib is None:
                    self.lib = self.bind(self.build()[0])
                lib = self.lib
        return lib

    def use(self, lib: ctypes.CDLL) -> None:
        """Launch through ``lib`` (``bind`` of another build of the source)
        from now on, and drop the plans made with the library before."""
        self.lib = lib
        self._plans.clear()

    def reset_launches(self) -> None:
        for k in self.LAUNCHES:
            self.LAUNCHES[k] = 0

    def built(self) -> int:
        """What the library has built for reuse in this process: the loaded
        library (one) plus the kept launch plans; 0 where nothing ran."""
        return int(self.lib is not None) + len(self._plans)

    def launch(self, name: str, fn: str, dev, *args) -> None:
        """Call entry point ``fn`` on ``dev`` with ``args`` and ``dev``'s
        current stream; raise if it returned a CUDA error, else count one
        launch of ``name``.  The device is switched only when ``dev`` is not
        the current one."""
        lib = self.lib if self.lib is not None else self.load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dev.index is None or dev.index == torch.cuda.current_device():
            err = getattr(lib, fn)(*args, stream)
        else:
            with torch.cuda.device(dev):
                err = getattr(lib, fn)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed with CUDA error {err}")
        self.LAUNCHES[name] += 1

    def plan(self, name: str, fn: str, dev, shape: tuple,
             refused: Optional[str] = None) -> tuple:
        """Kernel ``name``'s launch plan for ``shape`` on ``dev``, from
        entry point ``fn(*shape, out)`` the first time.  Where ``fn``
        returns -1 the card cannot take the shape: ValueError with
        ``refused.format(*shape)``."""
        key = (name, dev.index, shape)
        plan = self._plans.get(key)
        if plan is None:
            f = getattr(self.load(), fn)
            out = f.argtypes[-1]()
            with torch.cuda.device(dev):
                err = f(*shape, out)
            if err == -1 and refused is not None:
                raise ValueError(refused.format(*shape))
            if err != 0:
                raise RuntimeError(f"{name} plan launch failed with CUDA "
                                   f"error {err}")
            plan = self._plans[key] = tuple(out)
        return plan
