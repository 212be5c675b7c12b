"""Hopper kernels for the quorum tally, bound with ctypes.

``csrc/quorum_tally.cu`` holds three CUDA C++ kernels for ``sm_90a``; its
header says which TPU kernel each replaces, what bounds it on the card and
what its design does about that.  ``build()`` compiles the source with
``nvcc`` on first use into ``build/`` beside this file (git-ignored), named
by a hash of the source and flags, and ``ctypes`` loads it.  Nothing is
compiled or loaded at import: this module imports on a machine without CUDA.

Every wrapper checks device, dtype, shape and contiguity, allocates the
outputs, launches on ``torch.cuda.current_stream()``, raises if the launch
returned a CUDA error, and adds one to ``LAUNCHES[name]`` when it launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "quorum_tally.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_N = 128          # acceptors a trial may have (MAX_N in the source)
MAX_K = 8            # values a race may have (MAX_K in the source)
MAX_SMEM = 232_448   # shared memory one block may use on Hopper

LAUNCHES: Dict[str, int] = {"tally_decide": 0, "masked_tally": 0,
                            "stream_tally_decide_hist": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the quorum-tally kernels are "
                           "built from csrc/ on a machine with the CUDA "
                           "toolkit")
    return cand


def build() -> Tuple[Path, str]:
    """Compile ``csrc/quorum_tally.cu`` unless an up-to-date library exists.
    Returns (library path, compiler log; empty when nothing was built)."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libquorum_tally_{digest[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.qt_tally_decide.argtypes = [P, I, I, I, I, P, P, P, P, P]
            lib.qt_tally_decide.restype = I
            lib.qt_masked_tally.argtypes = [P, P, P, I, I, I, I, P, P]
            lib.qt_masked_tally.restype = I
            lib.qt_stream_block.argtypes = []
            lib.qt_stream_block.restype = I
            lib.qt_stream_smem.argtypes = [I, I, I, I, I]
            lib.qt_stream_smem.restype = ctypes.c_size_t
            lib.qt_stream_tally_decide_hist.argtypes = (
                [P] * 11 + [I] * 10 + [F, I, F] + [P] * 5)
            lib.qt_stream_tally_decide_hist.restype = I
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _require_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"the CUDA kernels take CUDA tensors, got one on "
                         f"{t.device}; ops.py routes CPU tensors to ref.py")


def _check_sizes(n: int, n_values: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"the quorum-tally kernels take 1 <= n <= {MAX_N} "
                         f"acceptors, got n={n}")
    if not 1 <= n_values <= MAX_K:
        raise ValueError(f"the quorum-tally kernels take 1 <= K <= {MAX_K} "
                         f"values, got K={n_values}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def tally_decide(votes: torch.Tensor, n_values: int, q) -> tuple:
    """(S, n) int32 votes (< 0 = no vote), int threshold q ->
    (counts (S, K) int32, winner (S,) int32, max_count (S,) int32,
    reached (S,) bool)."""
    if votes.dim() != 2:
        raise ValueError(f"votes must be (S, n), got {tuple(votes.shape)}")
    S, n = votes.shape
    _require_cuda(votes)
    _check_sizes(n, n_values)
    dev = votes.device
    _check(votes, "votes", torch.int32, (S, n), dev)
    counts = torch.empty((S, n_values), dtype=torch.int32, device=dev)
    winner = torch.empty((S,), dtype=torch.int32, device=dev)
    max_count = torch.empty((S,), dtype=torch.int32, device=dev)
    reached = torch.empty((S,), dtype=torch.bool, device=dev)
    if S:
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.qt_tally_decide(
                votes.data_ptr(), S, n, n_values, int(q), counts.data_ptr(),
                winner.data_ptr(), max_count.data_ptr(), reached.data_ptr(),
                _stream(dev))
        _raise_on(err, "tally_decide")
        LAUNCHES["tally_decide"] += 1
    return counts, winner, max_count, reached


def masked_tally(votes: torch.Tensor, weights: torch.Tensor,
                 thresholds: torch.Tensor, n_values: int) -> torch.Tensor:
    """(S, n) int32 votes x (G, n) f32 weights, (G,) f32 thresholds ->
    (S, G) int32 lowest satisfying value id, else -1."""
    if votes.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"votes (S, n) and weights (G, n) expected, got "
                         f"{tuple(votes.shape)} / {tuple(weights.shape)}")
    S, n = votes.shape
    G = weights.shape[0]
    _require_cuda(votes)
    _check_sizes(n, n_values)
    dev = votes.device
    _check(votes, "votes", torch.int32, (S, n), dev)
    _check(weights, "weights", torch.float32, (G, n), dev)
    _check(thresholds, "thresholds", torch.float32, (G,), dev)
    out = torch.empty((S, G), dtype=torch.int32, device=dev)
    if S and G:
        if -(-G // 32) > 65535:
            raise ValueError(f"masked_tally takes at most {65535 * 32} rows")
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.qt_masked_tally(
                votes.data_ptr(), weights.data_ptr(), thresholds.data_ptr(),
                S, n, G, n_values, out.data_ptr(), _stream(dev))
        _raise_on(err, "masked_tally")
        LAUNCHES["masked_tally"] += 1
    return out


def stream_tally_decide_hist(votes: torch.Tensor, val_arr: torch.Tensor,
                             arrive: torch.Tensor, classic: torch.Tensor,
                             w1: torch.Tensor, t1: torch.Tensor,
                             w2c: torch.Tensor, t2c: torch.Tensor,
                             w2f: torch.Tensor, t2f: torch.Tensor,
                             valid: torch.Tensor, *, n_values: int,
                             k_sat: tuple, precision: float, bins: int,
                             undecided_ms: float):
    """Fused masked tally + selection + decide + sketch over one raw chunk
    (shapes and semantics of ``ref.stream_tally_decide_hist``).  Counts and
    histogram are exact; ``sum_ms`` reduces per-block partials in a fixed
    order, so it is reproducible run to run."""
    from repro_torch.montecarlo.streaming import sketch_gamma
    if votes.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"votes (S, n) and masks (M, G, n) expected, got "
                         f"{tuple(votes.shape)} / {tuple(w1.shape)}")
    S, n = votes.shape
    K = n_values
    M, G1 = w1.shape[:2]
    G2c, G2f = w2c.shape[1], w2f.shape[1]
    _require_cuda(votes)
    _check_sizes(n, K)
    dev = votes.device
    f32 = torch.float32
    _check(votes, "votes", torch.int32, (S, n), dev)
    _check(val_arr, "val_arr", f32, (S, K, n), dev)
    _check(arrive, "arrive", f32, (S, n), dev)
    _check(classic, "classic", f32, (S, n), dev)
    _check(w1, "w1", f32, (M, G1, n), dev)
    _check(t1, "t1", f32, (M, G1), dev)
    _check(w2c, "w2c", f32, (M, G2c, n), dev)
    _check(t2c, "t2c", f32, (M, G2c), dev)
    _check(w2f, "w2f", f32, (M, G2f, n), dev)
    _check(t2f, "t2f", f32, (M, G2f), dev)
    _check(valid, "valid", torch.bool, (S,), dev)
    ks = tuple(int(k) for k in k_sat)
    if len(ks) != 3 or not all(1 <= k <= n for k in ks):
        raise ValueError(f"k_sat {k_sat} out of range for n={n}")
    if not 1 <= M <= 65535:
        raise ValueError(f"stream kernel takes 1 <= M <= 65535 systems, "
                         f"got {M}")
    lib = _load()
    smem = lib.qt_stream_smem(n, G1, G2c, G2f, bins)
    if smem > MAX_SMEM:
        raise ValueError(f"system masks need {smem} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a block may use")
    nblk = -(-S // lib.qt_stream_block())
    hist = torch.zeros((M, bins), dtype=torch.int32, device=dev)
    counts = torch.zeros((M, 3), dtype=torch.int32, device=dev)
    part_sum = torch.zeros((M, max(nblk, 1)), dtype=f32, device=dev)
    part_max = torch.full((M, max(nblk, 1)), -math.inf, dtype=f32, device=dev)
    if S:
        log_g = math.log(sketch_gamma(precision))
        with torch.cuda.device(dev):
            err = lib.qt_stream_tally_decide_hist(
                votes.data_ptr(), val_arr.data_ptr(), arrive.data_ptr(),
                classic.data_ptr(), w1.data_ptr(), t1.data_ptr(),
                w2c.data_ptr(), t2c.data_ptr(), w2f.data_ptr(),
                t2f.data_ptr(), valid.data_ptr(), S, n, K, M, G1, G2c, G2f,
                ks[0], ks[1], ks[2], log_g, bins, float(undecided_ms),
                hist.data_ptr(), counts.data_ptr(), part_sum.data_ptr(),
                part_max.data_ptr(), _stream(dev))
        _raise_on(err, "stream_tally_decide_hist")
        LAUNCHES["stream_tally_decide_hist"] += 1
    return hist, {"n_fast": counts[:, 0], "n_recovery": counts[:, 1],
                  "n_undecided": counts[:, 2],
                  "sum_ms": part_sum.sum(dim=1),
                  "max_ms": part_max.amax(dim=1)}
