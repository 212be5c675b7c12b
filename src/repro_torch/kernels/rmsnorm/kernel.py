"""The fused RMSNorm kernel for Hopper, bound with ctypes.

``csrc/rmsnorm.cu`` holds the CUDA C++ kernel for ``sm_90a``; its header
says which TPU kernel it replaces, what bounds it on the card and what its
design does about that.  ``LIB`` (``kernels/_build.py``) compiles it with
``nvcc`` on first use into ``build/`` beside this file (git-ignored) and
loads it.  Nothing is compiled or loaded at import: this module imports on a
machine without CUDA.

``rmsnorm`` refuses inputs that autograd would record through (the kernel has
no backward), checks device, dtypes, shapes and strides, allocates the
output, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES["rmsnorm"]`` when it
launches.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LIB = _build.Library(SOURCE, "rmsnorm", {
    "rmsnorm_forward": ([_I, _P, _L, _P, _P, _I, _I, ctypes.c_float, _P],
                        _I)}, ("rmsnorm",))
LAUNCHES = LIB.LAUNCHES
reset_launches = LIB.reset_launches
build = LIB.build


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
    LIB.launch("rmsnorm", "rmsnorm_forward", dev, int(dt == torch.bfloat16),
               rows.data_ptr(), rows.stride(0), scale.data_ptr(),
               y.data_ptr(), R, D, float(eps))
    return y
