"""The one ctypes binding of the four kernel libraries (``kernels/_build.py``
``Library``), on the CPU: the counters each package keeps, the plan cache
and its count, the swap hook, the launch's error and count, and the shared
argument check.  The card's side (a real library, real plans) is in
``tests/test_torch_cuda.py``."""
import contextlib
import ctypes
import importlib
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import _build

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

LAUNCH_KEYS = {
    "quorum_tally": ("tally_votes", "tally_decide", "masked_tally",
                     "stream_tally_decide_hist", "race_card_hist",
                     "masked_sat", "sorted_prefix", "col_sketch"),
    "ssd_scan": ("ssd", "ssd_tc"),
    "flash_attention": ("flash_attention", "flash_attention_tc"),
    "rmsnorm": ("rmsnorm",),
}


def modules(pkg):
    return (importlib.import_module(f"repro_torch.kernels.{pkg}.kernel"),
            importlib.import_module(f"repro_torch.kernels.{pkg}.ops"))


@pytest.mark.parametrize("pkg", sorted(LAUNCH_KEYS))
def test_launch_counters_keep_their_keys(pkg):
    kernel, ops = modules(pkg)
    assert kernel.LAUNCHES is ops.LAUNCHES is kernel.LIB.LAUNCHES
    assert tuple(ops.LAUNCHES) == LAUNCH_KEYS[pkg]
    assert kernel.LIB.name == pkg
    assert kernel.LIB.source == kernel.SOURCE and kernel.SOURCE.exists()


@pytest.mark.parametrize("pkg", sorted(LAUNCH_KEYS))
def test_reset_launches_zeroes_the_counters(pkg):
    kernel, ops = modules(pkg)
    counters = ops.LAUNCHES
    for i, k in enumerate(counters):
        counters[k] = i + 3
    ops.reset_launches()
    assert ops.LAUNCHES is counters
    assert counters == dict.fromkeys(LAUNCH_KEYS[pkg], 0)


def test_libraries_are_the_four_packages():
    libs = _build.libraries()
    assert [lib.name for lib in libs] == sorted(LAUNCH_KEYS)
    assert all(lib is modules(lib.name)[0].LIB for lib in libs)


def test_launch_plans_is_zero_where_no_kernel_ran():
    """In a fresh process, the CPU path builds and keeps nothing."""
    code = """
import torch
from repro_torch.kernels import _build
from repro_torch.kernels.quorum_tally import ops
votes = torch.zeros((8, 5), dtype=torch.int32)
ops.tally_decide(votes, 2, 3)
ops.masked_tally(votes, torch.ones((2, 5)), torch.ones(2), 2)
print("BUILT", ops.launch_plans(),
      [lib.built() for lib in _build.libraries()])
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr
    assert "BUILT 0 [0, 0, 0, 0]" in proc.stdout, proc.stdout


class FakeEntry:
    """A C entry point stand-in: records its calls, returns ``err``, and
    as a plan writes 10 + i into slot i of its output array."""

    def __init__(self, argtypes, err=0):
        self.argtypes, self.err, self.calls = argtypes, err, []

    def __call__(self, *args):
        self.calls.append(args)
        if isinstance(args[-1], ctypes.Array):
            for i in range(len(args[-1])):
                args[-1][i] = 10 + i
        return self.err


class FakeLib:
    def __init__(self, err=0):
        self.x_plan = FakeEntry([ctypes.c_int] * 2 + [ctypes.c_longlong * 3],
                                err)
        self.x_launch = FakeEntry([ctypes.c_int, ctypes.c_void_p], err)


@pytest.fixture
def no_card(monkeypatch):
    """torch.cuda's device switch and stream read, without a card: the
    current device 0, stream 77."""
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 77}))


def library(lib):
    out = _build.Library(_build.INCLUDE / "none.cu", "x", {}, ("x", "y"))
    out.use(lib)
    return out


def test_plan_is_asked_once_per_kind_device_and_shape(no_card):
    fake = FakeLib()
    lib = library(fake)
    dev = torch.device("cuda", 0)
    assert lib.built() == 1                     # the library, no plan yet
    assert lib.plan("x", "x_plan", dev, (4, 5)) == (10, 11, 12)
    assert lib.plan("x", "x_plan", dev, (4, 5)) == (10, 11, 12)
    assert fake.x_plan.calls[0][:2] == (4, 5) and len(fake.x_plan.calls) == 1
    lib.plan("x", "x_plan", dev, (4, 6))
    lib.plan("x", "x_plan", torch.device("cuda", 1), (4, 5))
    assert len(fake.x_plan.calls) == 3
    assert lib.built() == 4


def test_use_binds_another_library_and_drops_the_plans(no_card):
    first, second = FakeLib(), FakeLib()
    lib = library(first)
    dev = torch.device("cuda", 0)
    lib.plan("x", "x_plan", dev, (4, 5))
    assert lib.built() == 2
    lib.use(second)
    assert lib.lib is second and lib.built() == 1
    lib.plan("x", "x_plan", dev, (4, 5))
    assert len(first.x_plan.calls) == len(second.x_plan.calls) == 1


def test_plan_refusal_and_errors(no_card):
    dev = torch.device("cuda", 0)
    lib = library(FakeLib(err=-1))
    with pytest.raises(ValueError, match="^n=4 and K=5 refused$"):
        lib.plan("x", "x_plan", dev, (4, 5), "n={0} and K={1} refused")
    with pytest.raises(RuntimeError,
                       match="^x plan launch failed with CUDA error -1$"):
        lib.plan("x", "x_plan", dev, (4, 5))
    lib = library(FakeLib(err=700))
    with pytest.raises(RuntimeError,
                       match="^x plan launch failed with CUDA error 700$"):
        lib.plan("x", "x_plan", dev, (4, 5), "refused")
    assert lib.built() == 1


def test_launch_passes_the_stream_last_and_counts(no_card):
    fake = FakeLib()
    lib = library(fake)
    lib.launch("x", "x_launch", torch.device("cuda", 0), 3)
    lib.launch("x", "x_launch", torch.device("cuda"), 4)
    assert fake.x_launch.calls == [(3, 77), (4, 77)]
    assert lib.LAUNCHES == {"x": 2, "y": 0}
    bad = library(FakeLib(err=2))
    with pytest.raises(RuntimeError,
                       match="^x launch failed with CUDA error 2$"):
        bad.launch("x", "x_launch", torch.device("cuda", 0), 3)
    assert bad.LAUNCHES == {"x": 0, "y": 0}


def test_launch_on_another_device_switches_to_it(no_card, monkeypatch):
    entered = []

    @contextlib.contextmanager
    def device(dev):
        entered.append(dev)
        yield

    monkeypatch.setattr(torch.cuda, "device", device)
    lib = library(FakeLib())
    lib.launch("x", "x_launch", torch.device("cuda", 0), 3)
    assert entered == []
    lib.launch("x", "x_launch", torch.device("cuda", 1), 3)
    assert entered == [torch.device("cuda", 1)]


@pytest.mark.parametrize("t,dtype,shape,rows,message", [
    (torch.zeros(3, 4), torch.int32, (3, 4), False,
     "x has dtype torch.float32, expected torch.int32"),
    (torch.zeros(3, 4), (torch.bfloat16,), (3, 4), True,
     r"x has dtype torch.float32, expected one of \(torch.bfloat16,\)"),
    (torch.zeros(3, 4), torch.float32, (4, 3), False,
     r"x has shape \(3, 4\), expected \(4, 3\)"),
    (torch.zeros(4, 3).T, torch.float32, (3, 4), False,
     "x must be contiguous$"),
    (torch.zeros(4, 3).T, torch.float32, (3, 4), True,
     r"x must be contiguous along its last axis, has strides \(1, 3\)"),
    (torch.zeros(3, 8)[:, ::2], (torch.float32,), (3, 4), True,
     r"along its last axis, has strides \(8, 2\)"),
])
def test_check_refuses_with_the_wrappers_messages(t, dtype, shape, rows,
                                                  message):
    with pytest.raises(ValueError, match=message):
        _build.check(t, "x", dtype, shape, t.device, rows)


def test_check_takes_what_fits():
    x = torch.zeros(6, 4)[::2]                  # rows strided, last axis not
    _build.check(x, "x", (torch.float32, torch.bfloat16), (3, 4), x.device,
                 True)
    _build.check(x.contiguous(), "x", torch.float32, (3, 4), x.device)
    with pytest.raises(ValueError, match="lies on cpu, expected meta"):
        _build.check(x, "x", torch.float32, (3, 4), torch.device("meta"))
