"""The flash-attention kernel for Hopper, bound with ctypes.

``csrc/flash_attention.cu`` holds the CUDA C++ kernel for ``sm_90a`` in two
instances: bf16 inputs run the tensor-core instance (``mma.sync`` bf16
products, P rounded to bf16 in registers), f32 inputs the f32-FMA instance;
its header says which TPU kernel it replaces, what bounds it on the card and
what its design does about that.  ``LIB`` (``kernels/_build.py``) compiles
it with ``nvcc`` on first use into ``build/`` beside this file (git-ignored)
and loads it.  Nothing is compiled or loaded at import: this module imports
on a machine without CUDA.

``attention`` refuses inputs that autograd would record through (the kernel
has no backward), checks device, dtypes, shapes, strides and sizes, allocates
the output, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES["flash_attention"]`` when
it launches, and one to ``LAUNCHES["flash_attention_tc"]`` when that launch
is the tensor-core instance's.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

MAX_HD = 256          # the output accumulators are sized for hd <= 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

LIB = _build.Library(SOURCE, "flash_attention", {
    "flash_smem": ([_I, _I], ctypes.c_size_t),
    "flash_forward": ([_I] + [_P, _L, _L, _L] * 4 + [_I] * 8
                      + [ctypes.c_float, _I, _P], _I),
}, ("flash_attention", "flash_attention_tc"))
LAUNCHES = LIB.LAUNCHES
reset_launches = LIB.reset_launches
build = LIB.build


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """q (B,H,S,hd), k/v (B,KV,T,hd), f32 or bf16 (one dtype for all) ->
    o (B,H,S,hd) in q's dtype, laid out in memory as q is (a (B,S,H,hd)
    tensor viewed as (B,H,S,hd) gives one viewed the same way).  Every input
    may be strided on all axes but the last."""
    refuse_grad("flash-attention", q, k, v)
    if not q.is_cuda:
        raise ValueError(f"the flash-attention kernel takes CUDA tensors, "
                         f"got one on {q.device}; ops.py routes CPU tensors "
                         f"to ref.py")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q (B,H,S,hd) and k/v (B,KV,T,hd) expected, got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q has dtype {q.dtype}, expected float32 or "
                         f"bfloat16")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    dev = q.device
    _build.check(q, "q", q.dtype, (B, H, S, hd), dev, True)
    _build.check(k, "k", q.dtype, (B, KV, T, hd), dev, True)
    _build.check(v, "v", q.dtype, (B, KV, T, hd), dev, True)
    if not (1 <= hd <= MAX_HD):
        raise ValueError(f"the flash-attention kernel takes 1 <= hd <= "
                         f"{MAX_HD}, got {hd}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if causal and S > T:
        raise ValueError(f"causal attention takes the queries as the last S "
                         f"of T positions, so S <= T; got S={S}, T={T}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if B * H > 65535 or max(S, T) >= 2 ** 31:
        raise ValueError(f"the flash-attention kernel takes B*H <= 65535 and "
                         f"S, T < 2^31; got B*H={B * H}, S={S}, T={T}")
    o = torch.empty_like(q)            # q's layout: strided like q
    if B * H * S == 0:
        return o
    args = []
    for t in (q, k, v, o):
        args += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    tc = q.dtype == torch.bfloat16
    # 16-byte copies need every row of q, k and v to start 16-byte aligned
    vec = hd % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(x % 8 == 0 for x in t.stride()[:3])
        for t in (q, k, v))
    LIB.launch("flash_attention", "flash_forward", dev, int(tc), *args, B, H,
               KV, S, T, hd, int(causal), 0 if window is None else int(window),
               1.0 / math.sqrt(hd), int(vec))
    LAUNCHES["flash_attention_tc"] += int(tc)
    return o
