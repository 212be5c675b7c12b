"""``sorted_prefix``: the k smallest values of each row and their positions,
the order statistics of the decide layer.

The CPU cases hold the plain version to numpy's stable argsort (ties to the
lower position, -0 tying +0) and check the dispatch: ``ops`` launches
nothing on the CPU, and ``engine._topk_ascending`` takes rows of up to 32
through ``sorted_prefix`` and longer ones through torch.sort.  The card
cases hold the kernel to the plain version, ``torch.sort(stable=True)``'s
prefix on the card, bit for bit, values and ids; they skip without a card
and import no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sorted_prefix.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quorum_tally import kernel, ops, ref
from repro_torch.montecarlo import engine

BIG = 1e9


def rows(seed, shape, specials=True):
    """f32 rows with ties (quarters), BIG sentinels, -0.0 beside +0.0,
    negatives and +-inf."""
    r = np.random.default_rng(seed)
    x = np.floor(r.random(shape) * 16.0) / 4.0
    if specials:
        kind = r.integers(0, 10, shape)
        x = np.where(kind == 0, BIG, x)
        x = np.where(kind == 1, -0.0, x)
        x = np.where(kind == 2, 0.0, x)
        x = np.where(kind == 3, -x, x)
        x = np.where(kind == 4, np.inf, x)
        x = np.where((kind == 5) & (r.random(shape) < 0.2), -np.inf, x)
    return x.astype(np.float32)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).cpu().numpy()


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

CPU_CASES = [("ties", (300, 11), 11, False), ("big", (257, 12), 6, False),
             ("signed_zeros", (200, 9), 9, True), ("k1", (128, 11), 1, True),
             ("k_half", (129, 11), 6, True), ("k_n", (64, 32), 32, True),
             ("3d", (50, 2, 12), 12, True), ("3d_prefix", (7, 3, 15), 4, True),
             ("n1", (40, 1), 1, True)]


@pytest.mark.parametrize("case", CPU_CASES, ids=lambda c: c[0])
def test_ref_is_the_stable_sorts_prefix(case):
    """Values and positions of numpy's stable argsort, cut to k."""
    name, shape, k, order = case
    x = rows(len(name) * 31 + shape[0], shape, specials=name != "ties")
    if name == "signed_zeros":
        x[:, ::2] = -0.0
        x[:, 1::2] = 0.0
    if name == "big":
        x[:, 3:] = BIG
    vals, ids = ref.sorted_prefix(torch.as_tensor(x), k, order=order)
    perm = np.argsort(x, axis=-1, kind="stable")[..., :k]
    want = np.take_along_axis(x, perm, axis=-1)
    assert vals.shape == shape[:-1] + (k,) and vals.dtype == torch.float32
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  want.view(np.int32))
    if order:
        assert ids.dtype == torch.int64
        np.testing.assert_array_equal(ids.numpy(), perm)
    else:
        assert ids is None


@pytest.mark.parametrize("order", [False, True])
def test_ops_on_cpu_is_the_plain_version_and_launches_nothing(order):
    x = torch.as_tensor(rows(3, (500, 11)))
    ops.reset_launches()
    got = ops.sorted_prefix(x, 7, order=order)
    want = ref.sorted_prefix(x, 7, order=order)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) if not order else torch.equal(got[1], want[1])
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("bad,match", [
    (lambda x: (x.double(), 3), "f32"), (lambda x: (x, 0), "1 <= k"),
    (lambda x: (x, 12), "1 <= k")], ids=["dtype", "k=0", "k>n"])
def test_ops_refuses_on_cpu(bad, match):
    x = torch.as_tensor(rows(4, (16, 11)))
    with pytest.raises(ValueError, match=match):
        ops.sorted_prefix(*bad(x), order=True)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.sorted_prefix(torch.zeros((8, 5)), 3, order=True)


@pytest.mark.parametrize("n", [1, 11, 12, 32, 33, 64])
@pytest.mark.parametrize("order", [False, True])
def test_topk_ascending_routes_by_row_length(monkeypatch, n, order):
    """Rows of up to 32 go through ``ops.sorted_prefix``, longer ones
    through torch.sort; both give the stable sort's prefix."""
    calls = []

    def spy(x, k, *, order):
        calls.append((tuple(x.shape), k, order))
        return ref.sorted_prefix(x, k, order=order)

    monkeypatch.setattr(ops, "sorted_prefix", spy)
    x = torch.as_tensor(rows(n, (100, n)))
    k = max(1, n - 2)
    vals, perm = engine._topk_ascending(x, k, order)
    assert calls == ([((100, n), k, order)] if n <= 32 else [])
    want_v, want_p = torch.sort(x, dim=-1, stable=True)
    assert torch.equal(vals, want_v[:, :k])
    assert (perm is None) if not order else torch.equal(perm, want_p[:, :k])
    assert torch.equal(engine._sorted_prefix(x, None), want_v)


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def same(got, want):
    """Kernel against plain version: values' bits and ids equal."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gv.dtype == torch.float32
    assert gv.is_contiguous()
    bad = int((bits(gv) != bits(wv)).sum())
    assert bad == 0, f"{bad} values differ"
    if wi is None:
        assert gi is None
    else:
        assert gi.dtype == torch.int64 and gi.is_contiguous()
        assert torch.equal(gi, wi)


@pytest.mark.parametrize("order", [False, True])
@pytest.mark.parametrize("n", range(1, 33))
def test_kernel_equals_the_stable_sort(cuda, n, order):
    """n = 1..32 at k = 1, ceil(n / 2) and n; 1000 rows, not a multiple of
    a block's 128."""
    x = torch.as_tensor(rows(n, (1000, n))).to(cuda)
    for k in sorted({1, -(-n // 2), n}):
        same(kernel.sorted_prefix(x, k, order=order),
             ref.sorted_prefix(x, k, order=order))


@pytest.mark.parametrize("n", [1, 4, 11, 12, 16, 31, 32])
@pytest.mark.parametrize("S", [0, 1, 127, 128, 4099])
def test_kernel_row_counts(cuda, S, n):
    x = torch.as_tensor(rows(S + n, (S, n))).to(cuda)
    for k, order in ((n, True), (max(1, n - 3), False)):
        kernel.reset_launches()
        same(kernel.sorted_prefix(x, k, order=order),
             ref.sorted_prefix(x, k, order=order))
        assert kernel.LAUNCHES["sorted_prefix"] == int(S > 0)


@pytest.mark.parametrize("shape", [(300, 2, 12), (64, 3, 11), (5, 7, 2, 9)])
def test_kernel_takes_leading_axes(cuda, shape):
    """(S, K, n) as the race's per-value arrivals, and more axes."""
    x = torch.as_tensor(rows(sum(shape), shape)).to(cuda)
    for k in (shape[-1], 3):
        for order in (False, True):
            same(kernel.sorted_prefix(x, k, order=order),
                 ref.sorted_prefix(x, k, order=order))


@pytest.mark.parametrize("n", [3, 11, 12, 32])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_unaligned_base(cuda, n, offset):
    """A base 4, 8 or 12 bytes past a 16-byte boundary: scalar loads."""
    S = 1001
    buf = torch.as_tensor(rows(n * offset, (S * n + 4,))).to(cuda)
    x = buf[offset:offset + S * n].view(S, n)
    assert x.data_ptr() % 16 != 0
    same(kernel.sorted_prefix(x, n, order=True),
         ref.sorted_prefix(x, n, order=True))


def test_kernel_places_nan_where_torch_sort_does(cuda):
    """NaNs of either sign and several payloads, beside +-inf and +-0:
    the card's torch.sort's placement."""
    specials = np.array([0x7fc00000, 0xffc00000, 0x7fffffff, 0x7f800001,
                         0xff800001, 0x7f800000, 0xff800000, 0x80000000,
                         0x00000000, 0x3f800000, 0xbf800000, 0x00000001],
                        dtype=np.uint32).view(np.float32)
    r = np.random.default_rng(11)
    for n in (2, 11, 12, 32):
        x = r.choice(specials, (2000, n)).astype(np.float32)
        xt = torch.as_tensor(x).to(cuda)
        for k in (1, n):
            same(kernel.sorted_prefix(xt, k, order=True),
                 ref.sorted_prefix(xt, k, order=True))


def test_kernel_wrapper_refuses(cuda):
    x = torch.as_tensor(rows(5, (64, 11))).to(cuda)
    with pytest.raises(ValueError, match="f32"):
        kernel.sorted_prefix(x.double(), 3, order=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.sorted_prefix(x.cpu(), 3, order=True)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.sorted_prefix(x.T.contiguous().T, 3, order=True)
    for k in (0, 12):
        with pytest.raises(ValueError, match="1 <= k"):
            kernel.sorted_prefix(x, k, order=True)
    with pytest.raises(ValueError, match="at most 32"):
        kernel.sorted_prefix(torch.zeros((4, 33), device=cuda), 3,
                             order=False)


def test_topk_ascending_on_the_card_calls_no_torch_sort(cuda, monkeypatch):
    """Rows of 32 or fewer never reach torch.sort on the card."""
    def no_sort(*a, **kw):
        raise AssertionError("torch.sort called")

    x = torch.as_tensor(rows(9, (4096, 2, 12))).to(cuda)
    want = ref.sorted_prefix(x, 7, order=True)
    monkeypatch.setattr(torch, "sort", no_sort)
    kernel.reset_launches()
    same(engine._topk_ascending(x, 7), want)
    assert kernel.LAUNCHES["sorted_prefix"] == 1
