"""The fused RMSNorm kernel for Hopper, bound with ctypes.

``csrc/rmsnorm.cu`` holds the CUDA C++ kernel for ``sm_90a``; its header
says which TPU kernel it replaces, what bounds it on the card and what its
design does about that.  ``build()`` compiles it with ``nvcc`` on first use
into ``build/`` beside this file (git-ignored, ``kernels/_build.py``), and
``ctypes`` loads it.  Nothing is compiled or loaded at import: this module
imports on a machine without CUDA.

``rmsnorm`` refuses inputs that autograd would record through (the kernel has
no backward), checks device, dtypes, shapes and strides, allocates the
output, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES["rmsnorm"]`` when it
launches.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

LAUNCHES: Dict[str, int] = {"rmsnorm": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Tuple[Path, str]:
    """Compile ``csrc/rmsnorm.cu`` unless an up-to-date library exists.
    Returns (library path, compiler log; empty when nothing was built)."""
    return _build.build(SOURCE, "rmsnorm")


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rmsnorm_forward.argtypes = [I, P, L, P, P, I, I,
                                            ctypes.c_float, P]
            lib.rmsnorm_forward.restype = I
            _lib = lib
    return _lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) f32/bf16, rows contiguous along D and evenly strided;
    scale (D,) f32 contiguous -> (..., D) contiguous, in x's dtype.

    Decode calls this with a few rows, where the kernel takes about two
    microseconds: the checks and the launch are kept to plain attribute
    reads, and the device is switched only when x is not on the current
    one."""
    refuse_grad("RMSNorm", x, scale)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the RMSNorm kernel takes CUDA tensors, got one on "
                         f"{dev}; ops.py routes CPU tensors to ref.py")
    dt = x.dtype
    if dt != torch.float32 and dt != torch.bfloat16:
        raise ValueError(f"x has dtype {dt}, expected float32 or bfloat16")
    shape = x.shape
    if not shape or shape[-1] < 1:
        raise ValueError(f"x must have a last axis of D >= 1, got shape "
                         f"{tuple(shape)}")
    D = shape[-1]
    if scale.device != dev or scale.dtype != torch.float32 \
            or scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"scale must be a contiguous float32 ({D},) tensor "
                         f"on {dev}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    rows = x.reshape(-1, D)            # a view wherever the rows allow one
    if rows.stride(-1) != 1:
        raise ValueError(f"x must be contiguous along its last axis, has "
                         f"strides {x.stride()}")
    R = rows.shape[0]
    if R >= 2 ** 31:
        raise ValueError(f"the RMSNorm kernel takes fewer than 2^31 rows, "
                         f"got {R}")
    y = torch.empty(shape, dtype=dt, device=dev)
    if R == 0:
        return y
    lib = _lib if _lib is not None else _load()
    args = (int(dt == torch.bfloat16), rows.data_ptr(), rows.stride(0),
            scale.data_ptr(), y.data_ptr(), R, D, float(eps),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index is None or dev.index == torch.cuda.current_device():
        err = lib.rmsnorm_forward(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.rmsnorm_forward(*args)
    if err != 0:
        raise RuntimeError(f"rmsnorm launch failed with CUDA error {err}")
    LAUNCHES["rmsnorm"] += 1
    return y
