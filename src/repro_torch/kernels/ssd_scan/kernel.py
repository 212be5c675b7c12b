"""The Mamba2 SSD chunked-scan kernel for Hopper, bound with ctypes.

``csrc/ssd_scan.cu`` holds the CUDA C++ kernel for ``sm_90a`` in two
instances: with xw, B and C in bf16 the tensor-core instance (two
launches: chunk states with state passing, then C.B with the chunk
outputs; every product on the tensor cores, the f32 factors split into
hi + lo bf16 halves), with any of them in f32 the f32-FMA instance; its
header says which TPU kernel it replaces, what bounds it on the card and
what its design does about that.
``LIB`` (``kernels/_build.py``) compiles it with ``nvcc`` on first use into
``build/`` beside this file (git-ignored) and loads it.  Nothing is compiled
or loaded at import: this module imports on a machine without CUDA.

``ssd`` refuses inputs that autograd would record through (the kernel has no
backward), checks device, dtypes, shapes, strides and sizes, allocates the
outputs (and the tensor-core instance's f32 scratch), launches on
``torch.cuda.current_stream()``, raises if a launch returned a CUDA error,
and adds one to ``LAUNCHES["ssd"]`` when it launches, and one to
``LAUNCHES["ssd_tc"]`` when that is the tensor-core instance.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"

MAX_HD = 128       # head dim: y accumulators held in registers (MAX_HD)
MAX_DS = 128       # state dim: so hd * ds <= 16384 (64 KiB of f32 state)
MAX_CHUNK = 2048   # the chunk's cumsum lives in shared memory

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LIB = _build.Library(SOURCE, "ssd_scan", {
    "ssd_smem": ([_I, _I, _I], ctypes.c_size_t),
    "ssd_forward": ([_I, _I, _P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L,
                     _L, _P, _P, _P] + [_I] * 6 + [_P], _I),
    "ssd_tc_smem": ([_I, _I, _I], ctypes.c_size_t),
    "ssd_tc_forward": ([_P, _L, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _L,
                        _P, _P, _P, _P, _P, _P] + [_I] * 7 + [_P], _I),
}, ("ssd", "ssd_tc"))
LAUNCHES = LIB.LAUNCHES
reset_launches = LIB.reset_launches
build = LIB.build

_TYPES = (torch.float32, torch.bfloat16)


def ssd(xw: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int,
        init_state: Optional[torch.Tensor] = None):
    """xw (B,S,nh,hd) f32/bf16, da (B,S,nh) f32, Bm/Cm (B,S,ds) f32/bf16
    (one dtype for both), init_state (B,nh,hd,ds) f32 contiguous or None ->
    (y (B,S,nh,hd) in xw's dtype, final state (B,nh,hd,ds) f32).  Every
    input but ``init_state`` may be strided on all axes but the last."""
    refuse_grad("SSD", xw, da, Bm, Cm, init_state)
    if not xw.is_cuda:
        raise ValueError(f"the SSD kernel takes CUDA tensors, got one on "
                         f"{xw.device}; ops.py routes CPU tensors to the "
                         f"plain version")
    if xw.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"xw (B,S,nh,hd) and Bm (B,S,ds) expected, got "
                         f"{tuple(xw.shape)} / {tuple(Bm.shape)}")
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    dev = xw.device
    _build.check(xw, "xw", _TYPES, (B, S, nh, hd), dev, True)
    _build.check(da, "da", (torch.float32,), (B, S, nh), dev, True)
    _build.check(Bm, "Bm", _TYPES, (B, S, ds), dev, True)
    _build.check(Cm, "Cm", (Bm.dtype,), (B, S, ds), dev, True)
    if not (1 <= hd <= MAX_HD and 1 <= ds <= MAX_DS):
        raise ValueError(f"the SSD kernel takes hd <= {MAX_HD} and ds <= "
                         f"{MAX_DS} (hd*ds <= {MAX_HD * MAX_DS}), got "
                         f"hd={hd}, ds={ds}")
    if not (1 <= chunk <= MAX_CHUNK and S % chunk == 0):
        raise ValueError(f"the SSD kernel takes 1 <= chunk <= {MAX_CHUNK} "
                         f"dividing S={S}, got chunk={chunk}")
    if init_state is not None:
        _build.check(init_state, "init_state", (torch.float32,),
                     (B, nh, hd, ds), dev, True)
        if not init_state.is_contiguous():
            raise ValueError("init_state must be contiguous")
    y = torch.empty((B, S, nh, hd), dtype=xw.dtype, device=dev)
    fin = torch.empty((B, nh, hd, ds), dtype=torch.float32, device=dev)
    if B * nh == 0:
        return y, fin
    tc = xw.dtype == torch.bfloat16 and Bm.dtype == torch.bfloat16
    s0 = None if init_state is None else init_state.data_ptr()
    if tc:
        # scratch: the in-chunk cumsums in f32, the state before each chunk
        # as its hi and lo bf16 halves
        nc = S // chunk
        cum = torch.empty((B, nc, nh, chunk), dtype=torch.float32,
                          device=dev)
        st = torch.empty((2, B, nc, nh, hd, ds), dtype=torch.bfloat16,
                         device=dev)
        vec = hd % 8 == 0 and ds % 8 == 0 and all(
            t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in t.stride()[:-1])
            for t in (xw, Bm, Cm))
        LIB.launch("ssd", "ssd_tc_forward", dev,
                   xw.data_ptr(), xw.stride(0), xw.stride(1), xw.stride(2),
                   da.data_ptr(), da.stride(0), da.stride(1),
                   Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
                   Cm.data_ptr(), Cm.stride(0), Cm.stride(1), s0,
                   y.data_ptr(), fin.data_ptr(), cum.data_ptr(),
                   st[0].data_ptr(), st[1].data_ptr(), B, S, nh, hd, ds,
                   chunk, int(vec))
        LAUNCHES["ssd_tc"] += 1
        return y, fin
    LIB.launch("ssd", "ssd_forward", dev, int(xw.dtype == torch.bfloat16),
               int(Bm.dtype == torch.bfloat16),
               xw.data_ptr(), xw.stride(0), xw.stride(1), xw.stride(2),
               da.data_ptr(), da.stride(0), da.stride(1),
               Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
               Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
               s0, y.data_ptr(), fin.data_ptr(), B, S, nh, hd, ds, chunk)
    return y, fin
