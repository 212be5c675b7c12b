"""The port's SSD scan against the JAX package's, on the CPU.

The same inputs, drawn with numpy from a seed, go through JAX's Pallas
kernel (``ssd_scan.kernel.ssd`` in interpret mode) and the port's
``ops.ssd``, which on the CPU runs its plain chunked version.  Both run the
same chunked algorithm, so f32 agrees to 1e-4 (summation order only); with
bf16 ``xw`` the output is rounded to bf16 (half an ulp is 2^-9 relative),
so bf16 agrees to JAX's own 3e-2.  The recurrences (``ref.ssd``) agree to
1e-5 in f32.

The plain versions of the tensor-core instance's four steps
(``ref.ssd_decomposed``) are held to the JAX kernel and recurrence at the
same tolerances, and its emulation (``split=True``: bf16 xw, B and C, every
f32 factor split into hi + lo bf16 halves) at JAX's bf16 ones: y to 3e-2
times max(1, |y|) (y is rounded to bf16, half an ulp is 2^-9 relative), the
f32 state to 1e-3.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as jax_kernel
from repro.models.ssm import ssd_reference as jax_ssd_reference
from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel, ops, ref

# JAX's SSD_CASES (tests/test_kernels.py), a single ragged 13-token chunk,
# and a four-chunk sequence.
CASES = [
    (2, 128, 4, 16, 32, 32, "f32"),
    (1, 256, 8, 64, 128, 64, "f32"),
    (2, 64, 24, 64, 128, 64, "f32"),
    (1, 128, 4, 32, 64, 32, "bf16"),
    (2, 13, 4, 16, 32, 256, "f32"),
    (2, 13, 4, 16, 32, 256, "bf16"),
    (1, 512, 4, 32, 64, 128, "f32"),
]


def _inputs(seed, B, S, nh, hd, ds):
    r = np.random.default_rng(seed)
    f = np.float32
    return ((r.standard_normal((B, S, nh, hd)) * 0.5).astype(f),
            (-np.abs(r.standard_normal((B, S, nh))) * 0.3).astype(f),
            (r.standard_normal((B, S, ds)) * 0.5).astype(f),
            (r.standard_normal((B, S, ds)) * 0.5).astype(f),
            (r.standard_normal((B, nh, hd, ds)) * 0.1).astype(f))


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,dtype", CASES)
def test_ssd_matches_jax_kernel(B, S, nh, hd, ds, chunk, dtype):
    xw, da, Bm, Cm, s0 = _inputs(S * 31 + nh, B, S, nh, hd, ds)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    yj, fj = jax_kernel.ssd(jnp.asarray(xw).astype(jd), jnp.asarray(da),
                            jnp.asarray(Bm), jnp.asarray(Cm), chunk=chunk,
                            init_state=jnp.asarray(s0), interpret=True)
    t = torch.from_numpy
    yt, ft = ops.ssd(t(xw).to(td), t(da), t(Bm), t(Cm), chunk=chunk,
                     init_state=t(s0))
    assert yt.dtype == td and ft.dtype == torch.float32
    assert tuple(yt.shape) == (B, S, nh, hd) and tuple(ft.shape) == \
        (B, nh, hd, ds)
    tol = 1e-4 if dtype == "f32" else 3e-2
    yj = np.asarray(yj.astype(jnp.float32))
    assert np.abs(yt.float().numpy() - yj).max() < tol
    assert np.abs(ft.numpy() - np.asarray(fj)).max() < tol


@pytest.mark.parametrize("B,S,nh,hd,ds", [(2, 64, 4, 16, 32),
                                          (1, 13, 3, 8, 16)])
def test_ref_matches_jax_reference(B, S, nh, hd, ds):
    xw, da, Bm, Cm, s0 = _inputs(S + 7, B, S, nh, hd, ds)
    yj, fj = jax_ssd_reference(jnp.asarray(xw), jnp.asarray(da),
                               jnp.asarray(Bm), jnp.asarray(Cm),
                               jnp.asarray(s0))
    t = torch.from_numpy
    yt, ft = ref.ssd(t(xw), t(da), t(Bm), t(Cm), init_state=t(s0))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-5
    assert np.abs(ft.numpy() - np.asarray(fj)).max() < 1e-5


def test_ssd_chunk_invariance_and_zero_init():
    xw, da, Bm, Cm, _ = (torch.from_numpy(a) for a in
                         _inputs(5, 1, 128, 2, 16, 16))
    outs = [ops.ssd(xw, da, Bm, Cm, chunk=c) for c in (16, 32, 64, 128)]
    y_ref, f_ref = ref.ssd(xw, da, Bm, Cm)
    for y, f in outs:
        assert (y - y_ref).abs().max() < 1e-4
        assert (f - f_ref).abs().max() < 1e-4


def test_ssd_takes_strided_b_and_c_on_cpu():
    xw, da, Bm, Cm, s0 = (torch.from_numpy(a) for a in
                          _inputs(9, 2, 64, 4, 16, 32))
    u = torch.cat([torch.zeros(2, 64, 5), Bm, Cm], dim=-1)
    y1, f1 = ops.ssd(xw, da, u[..., 5:37], u[..., 37:], 32, s0)
    y2, f2 = ops.ssd(xw, da, Bm, Cm, 32, s0)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


def test_ssd_chunk_rule():
    xw, da, Bm, Cm, _ = (torch.from_numpy(a) for a in
                         _inputs(1, 1, 96, 2, 8, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(xw, da, Bm, Cm, chunk=64)
    ops.ssd(xw, da, Bm, Cm, chunk=256)          # one chunk of 96
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.ssd(xw, da, Bm, Cm, 32)


def _fake_nvcc(tmp_path):
    """An ``nvcc`` that writes its ``-o`` target and logs each call."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    exe = bin_dir / "nvcc"
    exe.write_text("#!/bin/sh\n"
                   f"echo called >> {tmp_path / 'calls'}\n"
                   "while [ \"$1\" != -o ]; do shift; done\n"
                   "echo lib > \"$2\"\n"
                   "echo 'ptxas info: Used 40 registers'\n")
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return bin_dir


def test_build_names_libraries_by_content_and_reuses_them(tmp_path,
                                                          monkeypatch):
    src_dir = tmp_path / "pkg" / "csrc"
    src_dir.mkdir(parents=True)
    src = src_dir / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setenv("PATH", str(_fake_nvcc(tmp_path)) + os.pathsep
                       + os.environ["PATH"])
    lib1, log1 = _build.build(src, "k")
    assert lib1.parent == tmp_path / "pkg" / "build"
    assert lib1.name.startswith("libk_") and lib1.exists()
    assert "registers" in log1
    assert _build.build(src, "k") == (lib1, "")      # reused, not rebuilt
    src.write_text("// two\n")
    lib2, _ = _build.build(src, "k")
    assert lib2 != lib1 and lib2.exists()
    assert (tmp_path / "calls").read_text().count("called") == 2


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    src_dir = tmp_path / "csrc"
    src_dir.mkdir()
    (src_dir / "k.cu").write_text("//\n")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(src_dir / "k.cu", "k")


# ---------------------------------------------------------------------------
# The tensor-core instance's decomposition and its emulation
# ---------------------------------------------------------------------------

def _bf(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,dtype", CASES)
def test_decomposition_matches_jax(B, S, nh, hd, ds, chunk, dtype):
    """C.B, chunk states, state passing and chunk outputs, composed."""
    xw, da, Bm, Cm, s0 = _inputs(S * 17 + hd, B, S, nh, hd, ds)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    c = min(chunk, S)
    yj, fj = jax_kernel.ssd(jnp.asarray(xw).astype(jd), jnp.asarray(da),
                            jnp.asarray(Bm), jnp.asarray(Cm), chunk=c,
                            init_state=jnp.asarray(s0), interpret=True)
    t = torch.from_numpy
    yt, ft = ref.ssd_decomposed(t(xw).to(td), t(da), t(Bm), t(Cm), c,
                                t(s0))
    assert yt.dtype == td and ft.dtype == torch.float32
    tol = 1e-4 if dtype == "f32" else 3e-2
    assert np.abs(yt.float().numpy() - np.asarray(
        yj.astype(jnp.float32))).max() < tol
    assert np.abs(ft.numpy() - np.asarray(fj)).max() < tol
    yr, fr = jax_ssd_reference(jnp.asarray(xw).astype(jd), jnp.asarray(da),
                               jnp.asarray(Bm), jnp.asarray(Cm),
                               jnp.asarray(s0))
    assert np.abs(yt.float().numpy() - np.asarray(
        yr.astype(jnp.float32))).max() < tol
    assert np.abs(ft.numpy() - np.asarray(fr)).max() < tol


@pytest.mark.parametrize("B,S,nh,hd,ds,chunk,dtype", CASES)
def test_tensor_core_emulation_matches_jax(B, S, nh, hd, ds, chunk, dtype):
    """The serving path's dtypes (bf16 xw, B and C) through the JAX kernel
    and through the emulation of the tensor-core instance."""
    xw, da, Bm, Cm, s0 = _inputs(S * 19 + ds, B, S, nh, hd, ds)
    c = min(chunk, S)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    yj, fj = jax_kernel.ssd(bf(xw), jnp.asarray(da), bf(Bm), bf(Cm),
                            chunk=c, init_state=jnp.asarray(s0),
                            interpret=True)
    t = torch.from_numpy
    yt, ft = ref.ssd_decomposed(_bf(xw), t(da), _bf(Bm), _bf(Cm), c, t(s0),
                                split=True)
    assert yt.dtype == torch.bfloat16
    yj = np.asarray(yj.astype(jnp.float32))
    assert (np.abs(yt.float().numpy() - yj)
            <= 3e-2 * np.maximum(1.0, np.abs(yj))).all()
    assert np.abs(ft.numpy() - np.asarray(fj)).max() < 1e-3


def test_hi_lo_split_keeps_the_state_within_its_bound():
    """Why the f32 factors are split: rounded once to bf16 they would move
    the f32 state by more than its 1e-3 bound at the serving path's scale;
    split into hi + lo halves they keep it to about 1e-5."""
    xw, da, Bm, Cm, s0 = _inputs(23, 2, 512, 8, 64, 64)
    args = (_bf(xw), torch.from_numpy(da), _bf(Bm), _bf(Cm), 128,
            torch.from_numpy(s0))
    _, exact = ref.ssd_decomposed(*args)
    _, split = ref.ssd_decomposed(*args, split=True)
    assert (split - exact).abs().max() < 1e-4
    once = lambda x: x.to(torch.bfloat16).float()
    orig = ref.split_bf16
    ref.split_bf16 = once
    try:
        _, rounded = ref.ssd_decomposed(*args, split=True)
    finally:
        ref.split_bf16 = orig
    assert (rounded - exact).abs().max() > 1e-3


def test_steps_match_the_chunked_scan():
    """Each step's output against the quantity ``ssd_chunked`` forms."""
    xw, da, Bm, Cm, s0 = (torch.from_numpy(a) for a in
                          _inputs(29, 2, 96, 3, 8, 16))
    chunk = 32
    cbm = ref.cb(Bm, Cm, chunk)
    assert tuple(cbm.shape) == (2, 3, 32, 32)
    assert torch.allclose(cbm[1, 2], Cm[1, 64:] @ Bm[1, 64:].T, atol=1e-5)
    cum, own = ref.chunk_states(xw, da, Bm, chunk)
    assert torch.allclose(cum[0, 1, 2], torch.cumsum(da[0, 32:64, 2], 0))
    before, fin = ref.pass_states(own, cum, s0)
    assert torch.equal(before[:, 0], s0)
    _, fin_c = ops.ssd(xw, da, Bm, Cm, chunk, s0)
    assert (fin - fin_c).abs().max() < 1e-5
    y, _ = ref.ssd_decomposed(xw, da, Bm, Cm, chunk, s0)
    y_c, _ = ops.ssd(xw, da, Bm, Cm, chunk, s0)
    assert (y - y_c).abs().max() < 1e-5
