"""`vo.ba.observation_orders`, the orders of the BA's three slot sums built
in one sort, against `solve.precision.SegmentSum` built sum by sum: `order`
and `starts` bit for bit, on random inputs with masked rows, with slots
that have no rows, with and without `compensated`; and the PyTorch
operations a call takes, counted at the dispatcher: six that compute (four
with `compensated`), the rest views. CPU only."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from evo_tpu_torch.solve.precision import SegmentSum
from evo_tpu_torch.vo import ba


def _segment_sums(of, ol, F, L, compensated, mask):
    """The three `SegmentSum`s as the BA defines them, one at a time."""
    pair = ol * F + of
    key, keep = (None, None) if compensated else (pair, mask)
    return [SegmentSum(i, n, key=key, keep=keep) for i, n in ((of, F), (ol, L), (pair, L * F))]


def _inputs(seed, F, L, O, masked):
    rng = np.random.default_rng(seed)
    # frames and landmarks drawn from part of their range: some slots have no row
    of = torch.tensor(rng.integers(0, max(1, F - 1), O))
    ol = torch.tensor(rng.integers(0, max(1, L // 2), O))
    mask = torch.tensor(rng.random(O) >= masked)
    return of, ol, mask


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("seed, F, L, O, masked", [
    (0, 6, 64, 256, 0.3), (1, 21, 128, 2048, 0.1), (2, 3, 5, 40, 0.0), (3, 39, 256, 4096, 0.5),
    (4, 2, 1, 7, 1.0)])
def test_orders_equal_segment_sums(seed, F, L, O, masked, compensated):
    of, ol, mask = _inputs(seed, F, L, O, masked)
    got = ba.observation_orders(of, ol, F, L, compensated, mask)
    want = _segment_sums(of, ol, F, L, compensated, mask)
    for g, w in zip(got, want):
        assert g.n_out == w.n_out
        assert g.order.dtype == w.order.dtype and torch.equal(g.order, w.order)
        assert g.starts.dtype == w.starts.dtype and torch.equal(g.starts, w.starts)
        assert g.order.is_contiguous() and g.starts.is_contiguous()
    # and they sum as SegmentSum does
    vals = torch.tensor(np.random.default_rng(seed).standard_normal((O, 6, 3)), dtype=torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g(vals), w(vals))


def test_orders_of_the_front_ends_padding():
    """The front end's layout: rows by (landmark, frame) pair, then padding
    rows at frame 0, landmark 0, masked."""
    F, L, O, n = 21, 128, 2048, 1900
    rng = np.random.default_rng(7)
    pairs = np.sort(rng.choice(L * F, n, replace=False))
    of = torch.zeros(O, dtype=torch.int64)
    ol = torch.zeros(O, dtype=torch.int64)
    of[:n], ol[:n] = torch.tensor(pairs % F), torch.tensor(pairs // F)
    mask = torch.arange(O) < n
    for compensated in (False, True):
        for g, w in zip(ba.observation_orders(of, ol, F, L, compensated, mask),
                        _segment_sums(of, ol, F, L, compensated, mask)):
            assert torch.equal(g.order, w.order) and torch.equal(g.starts, w.starts)


class _Ops(TorchDispatchMode):
    """The operations a call reaches the dispatcher with, as (name, is a view)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((str(func), func.is_view))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("compensated, computing", [(False, 6), (True, 4)])
def test_orders_take_six_operations(compensated, computing):
    """After the first call of a shape (which makes its constants), a call
    takes `computing` operations that compute (the keys, one sort, one
    searchsorted) and views of their results; none reads the host."""
    of, ol, mask = _inputs(0, 21, 128, 2048, 0.1)
    ba.observation_orders(of, ol, 21, 128, compensated, mask)
    with _Ops() as seen:
        ba.observation_orders(of, ol, 21, 128, compensated, mask)
    work = [name for name, view in seen.ops if not view]
    assert len(work) == computing <= 6, seen.ops
    assert sum(1 for name in work if "sort" in name) == 2  # one sort, one searchsorted
    assert not any(name.startswith(("aten._local_scalar_dense", "aten.item")) for name, _ in seen.ops)
    assert {name for name, view in seen.ops if view} <= {"aten.unbind.int", "aten.slice.Tensor"}
