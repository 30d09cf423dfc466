"""Compensated (two-float) accumulation for float32 normal equations —
counterpart of `evo_tpu/solve/precision.py`.

Error-free transforms (Knuth two-sum) carry a compensation term through
chunked reductions, and the result is folded to the correctly rounded
float32 of the true sum, so the accumulation error of a long reduction does
not grow with its depth. Used by `vo.ba.ba_solve(compensated=True)` and
`solve.epipolar.eight_point(refine_null=True)`.

`SegmentSum` is the port's own: the plain float32 scatter-add of the BA's
normal equations in one order, fixed by the rows' keys, on every device.
"""

from __future__ import annotations

import torch


def two_sum(a, b):
    """Error-free transform: s = fl(a + b), err exact (Knuth 2Sum)."""
    s = a + b
    bp = s - a
    err = (a - (s - bp)) + (b - bp)
    return s, err


def compensated_reduce(parts, axis: int = 0):
    """Compensated sum over `axis`: (hi, lo) with hi the running float32 sum
    and lo the accumulated rounding error."""
    parts = parts.movedim(axis, 0)
    hi = torch.zeros_like(parts[0])
    lo = torch.zeros_like(parts[0])
    for x in parts:
        hi, err = two_sum(hi, x)
        lo = lo + err
    return hi, lo


def fold(hi, lo):
    """Collapse a two-float value to the correctly rounded float32 sum."""
    return two_sum(hi, lo)[0]


def _chunk(o: int, n_chunks: int) -> int:
    return -(-o // n_chunks)  # ceil


class SegmentSum:
    """`index_add_` of rows [O, ...] into `n_out` slots by `idx` [O], summed
    in an order that the rows' (slot, `key`) pairs alone fix.

    `index_add_` on the card adds with atomics in the order its threads
    arrive, so a float32 slot sum changes in its last bits from run to run.
    Here the rows are sorted once, by slot and within a slot by `key` (two
    stable sorts), and every call sums each slot's contiguous segment with
    `torch.segment_reduce`, which adds a segment's rows one after another,
    in the sorted order, on the CPU and on the card. Neither the threads nor
    the order the rows come in can change that order, as long as no two rows
    of one slot with different values share a key. Rows that already come
    sorted so sum as `index_add_` sums them on the CPU, bit for bit.

    Rows whose `keep` is False are left out of every sum (the BA's masked
    observations, whose weight is 0: padding that would otherwise make one
    slot's segment, and so one thread of the card's reduction, as long as
    the padding): they are sorted into one more slot, past the last, whose
    sum is dropped, so that nothing is read back to the host.

    `order` [O] and `starts` [n_out + 2] (slot s is order[starts[s]:
    starts[s + 1]]) are the sums' order, which `kernels.ba_solve` sums in
    too. Build it once per index array, outside a solver's loop; call it
    once per value array. Float32 in, float32 sums out, as `index_add_`."""

    def __init__(self, idx, n_out: int, key=None, keep=None):
        idx = idx.long()
        if keep is not None:
            idx = torch.where(keep.bool(), idx, n_out)
        order = torch.arange(len(idx), device=idx.device)
        if key is not None:
            order = torch.argsort(key, stable=True)
        order = order[torch.argsort(idx[order], stable=True)]
        self.order, self.n_out = order, n_out
        # segment starts from the sorted slots (no atomics, no host read)
        edges = torch.arange(n_out + 2, device=idx.device)
        self.starts = torch.searchsorted(idx[order], edges)

    @classmethod
    def from_order(cls, order, starts, n_out: int) -> "SegmentSum":
        """The sum of an `order` [O] and `starts` [n_out + 2] built elsewhere
        (`vo.ba.observation_orders` builds three in one sort)."""
        seg = cls.__new__(cls)
        seg.order, seg.starts, seg.n_out = order, starts, n_out
        return seg

    def __call__(self, vals):
        return torch.segment_reduce(vals[self.order], "sum", lengths=torch.diff(self.starts),
                                    axis=0, unsafe=True, initial=0.0)[:self.n_out]


def compensated_scatter_add(idx, vals, n_out: int, n_chunks: int = 32):
    """Scatter-add `vals` [O, ...] into [n_out, ...] by `idx` [O] with an
    accumulation error bounded by the chunk length, not by O: each of
    `n_chunks` chunks of observations is scattered into its own partial
    accumulator, and the partials are combined by a compensated sum.

    The chunks are scattered by one `SegmentSum`, which adds the entries of
    one partial in their order of appearance on every device, so the result
    is the same from run to run. (`index_put_(accumulate=True)` is not: on
    the CPU its threads add [O, 6, 6] blocks in no fixed order.)"""
    o = vals.shape[0]
    c = _chunk(o, n_chunks)
    chunk_of = torch.arange(o, device=vals.device) // c
    parts = SegmentSum(chunk_of * n_out + idx.long(), n_chunks * n_out)(vals)
    parts = parts.reshape((n_chunks, n_out) + vals.shape[1:])
    return fold(*compensated_reduce(parts, axis=0))


def compensated_gram(A, n_chunks: int = 16):
    """G = AᵀA for A [N, K] as a two-float pair (G_hi, G_lo): plain float32
    products per chunk of rows, a compensated sum across chunks."""
    n, k = A.shape
    c = _chunk(n, n_chunks)
    pad = c * n_chunks - n
    if pad:
        A = torch.cat([A, A.new_zeros(pad, k)])
    Ac = A.reshape(n_chunks, c, k)
    return compensated_reduce(Ac.transpose(1, 2) @ Ac, axis=0)


def refined_null_vector(A, iters: int = 2, n_chunks: int = 16):
    """Unit vector e minimizing ‖A e‖ beyond the float32 SVD's floor: the SVD
    null vector, then `iters` steps of deflated eigen-refinement on G = AᵀA
    whose residual G e − λ e is evaluated with the compensated Gram."""
    e = torch.linalg.svd(A, full_matrices=True).Vh[-1]
    G_hi, G_lo = compensated_gram(A, n_chunks)
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        g = G_hi @ e + G_lo @ e
        lam = e @ g
        r = g - lam * e
        # deflate along e so that the shifted system is well conditioned at
        # the smallest eigenvalue
        M = G_hi - lam * eye + torch.outer(e, e)
        d, info = torch.linalg.solve_ex(M, -r)
        d = d - (e @ d) * e
        e2 = e + d
        e2 = e2 / torch.linalg.norm(e2).clamp_min(1e-30)
        ok = torch.isfinite(e2).all() & (info == 0)
        e = torch.where(ok, e2, e)
    return e
