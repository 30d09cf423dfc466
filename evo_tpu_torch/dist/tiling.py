"""Sharded event splat, patch solve and contrast-max tile solve —
counterpart of `evo_tpu/dist/tiling.py`.

- `sharded_splat`: the event stream is split over the ``batch`` axis; each
  rank splats its block into a full-sensor image (the CUDA kernel on the
  card) and one `all_reduce` over ``batch`` sums them. A splat is a sum over
  events, so this is exact up to summation order.
- `sharded_patch_solve`: the patch table's rows are split over ``batch``;
  each rank solves its rows and the results are gathered. Patch solves are
  independent.
- `sharded_tile_solve_data`: the tile grid's columns are split over
  ``space``; each rank runs the per-tile work (warp, splat, edge loss and
  Jacobian: kernel A, `kernels.comp_tile`, on the card) for its columns
  only, the TV edges across a shard boundary read the right neighbour's
  first column through `halo.exchange_halo`, and one `all_gather` ships the
  compressed system pieces (per-tile 2x2 blocks and gradient terms,
  per-owned-edge (w², d)). The first rank of the ``space`` group assembles
  and factorises the 2T x 2T system (kernel B's solve entry,
  `kernels.comp_step.solve`, on the card) and broadcasts the update; each
  rank takes its own columns of it. The costs are all-reduced, so every
  rank stops at the same iteration. The update is the exact one of the
  one-device solve, up to summation order; on one ``space`` rank on the
  card, bit for bit (the edges in the one-device order, the costs summed
  in kernel B's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.dist.mesh import (BATCH_AXIS, SPACE_AXIS, all_gather_cat, axis_index,
                                     axis_size, block)
from evo_tpu_torch.kernels.splat import splat_image


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()


def sharded_splat(mesh, x, y, weight, height: int, width: int, *,
                  mode: str = "bilinear", device=None):
    """Data-parallel splat: x, y, weight [N] (N divisible by the batch axis;
    pad with weight 0) are the global events on every rank. Returns the
    replicated [H, W] on `device` (None: the card when there is one)."""
    dev = resolve(device)
    rows = block(mesh, BATCH_AXIS, len(x))
    local = splat_image(_f32(x[rows], dev), _f32(y[rows], dev), _f32(weight[rows], dev),
                        height, width, mode=mode)
    dist.all_reduce(local, group=mesh.get_group(BATCH_AXIS))
    return local


def sharded_patch_solve(mesh, solve_fn, table_batch, grads):
    """Patch-parallel alignment: each rank runs `solve_fn(rows, grads)` on its
    block of the rows of `table_batch` (a dataclass of tensors with one
    leading axis, the patch table) and the per-row results (one tensor) are
    gathered over ``batch`` into the replicated result."""
    fields = dataclasses.fields(table_batch)
    rows = block(mesh, BATCH_AXIS, getattr(table_batch, fields[0].name).shape[0])
    local = dataclasses.replace(
        table_batch, **{f.name: getattr(table_batch, f.name)[rows] for f in fields})
    return all_gather_cat(solve_fn(local, grads), mesh.get_group(BATCH_AXIS))


def space_shard_tiles(mesh, tile_field):
    """This rank's block of a [TY, TX, ...] per-tile field: its columns of
    TX along ``space``."""
    return tile_field[:, block(mesh, SPACE_AXIS, tile_field.shape[1])]


def _owned_edges(ty: int, tx: int, n_space: int):
    """Global (p, q) tile ids of every rank's owned TV edges, [n_space, E_l]
    each, in the order each rank lists them: the horizontal ones inside its
    columns, vertical (i, j)-(i+1, j), then its boundary edges to the right
    neighbour's first column (clipped on the last rank, where they are
    masked out). On one rank that is `compensate._edges`'s order, then the
    masked edges, so the root assembles the one-device solve's system."""
    txl, T = tx // n_space, ty * tx
    ps, qs = [], []
    for r in range(n_space):
        g = np.arange(ty)[:, None] * tx + r * txl + np.arange(txl)[None, :]
        ps.append(np.concatenate([g[:, :-1].ravel(), g[:-1].ravel(), g[:, -1]]))
        qs.append(np.concatenate([g[:, 1:].ravel(), g[1:].ravel(),
                                  np.minimum(g[:, -1] + 1, T - 1)]))
    return np.stack(ps), np.stack(qs)


def sharded_tile_solve_data(mesh, tile_data, *, ty: int, tx: int, tile: int,
                            scale: float, tv_weight: float, tv_huber: float,
                            max_iters: int, loss: str = "edge", v_init=None):
    """Space-sharded contrast-max solve, the distributed counterpart of
    `tracker.compensate.solve_motion_field`: its LM loop
    (`compensate.lm_motion_field`) on this rank's columns, with collective
    hooks.

    tile_data: the global `TileData` of `compensate.build_tile_data` ([T, E],
    T = ty·tx row-major) on every rank, on the device the rank computes on;
    tx must be divisible by the ``space`` axis. v_init: optional global
    [T, 2] warm start, ignored when not finite. Returns (vel [T, 2], cost,
    cost0), replicated."""
    from evo_tpu_torch.dist.halo import exchange_halo
    from evo_tpu_torch.kernels.comp_step import Edges
    from evo_tpu_torch.tracker.compensate import lm_motion_field, tile_system

    group = mesh.get_group(SPACE_AXIS)
    n_space, k = axis_size(mesh, SPACE_AXIS), axis_index(mesh, SPACE_AXIS)
    if tx % n_space:
        raise ValueError(f"tx={tx} not divisible by space axis {n_space}")
    dev = tile_data.ex.device
    txl, T = tx // n_space, ty * tx
    tl = ty * txl
    ldata = tile_data.map(lambda a: space_shard_tiles(mesh, a.reshape((ty, tx) + a.shape[1:]))
                          .reshape((tl,) + a.shape[1:]).contiguous())
    n_vh = (ty - 1) * txl + ty * (txl - 1)
    edge_ok = torch.cat([torch.ones(n_vh, dtype=torch.bool, device=dev),
                         torch.full((ty,), k < n_space - 1, device=dev)])
    n_edges = len(edge_ok)
    cols = block(mesh, SPACE_AXIS, tx)
    root = dist.get_global_rank(group, 0)
    if k == 0:
        ps, qs = (a.reshape(-1) for a in _owned_edges(ty, tx, n_space))
        system = tile_system(1, Edges(ps, qs, T, dev))

    def edge_diffs(v):
        """Per-owned-edge velocity differences [1, E_l, 2], 0 on the masked
        ones (their Huber cost is then 0); the boundary column's right
        neighbour comes from the halo exchange."""
        vg = v.reshape(ty, txl, 2)
        _, from_right = exchange_halo(mesh, vg, SPACE_AXIS, width=1, axis=1)
        d = torch.cat([(vg[:, :-1] - vg[:, 1:]).reshape(-1, 2),
                       (vg[:-1] - vg[1:]).reshape(-1, 2),
                       (vg[:, -1] - from_right[:, 0]).reshape(-1, 2)])
        return torch.where(edge_ok[:, None], d, torch.zeros_like(d))[None]

    def reduce(c):
        dist.all_reduce(c, group=group)
        return c

    def grid_order(a):
        """[n_space, ty·txl, ...] blocks of the ranks' columns -> [T, ...]."""
        tail = a.shape[2:]
        return (a.reshape((n_space, ty, txl) + tail).transpose(0, 1)
                .reshape((T,) + tail))

    def solve(jj, jr, w2, d, lam):
        """Every rank's pieces to the root, which solves the whole system
        (masked edges carry w2 = 0 and d = 0, so their clipped adds are
        no-ops) and broadcasts the update with its factorisation's flag;
        this rank's columns of it."""
        w2 = torch.where(edge_ok, w2, torch.zeros_like(w2))
        pieces = all_gather_cat(torch.cat([jj.reshape(-1), jr.reshape(-1), w2.reshape(-1),
                                           d.reshape(-1)]), group)
        if k == 0:
            g = pieces.reshape(n_space, -1)
            delta, ok = system(grid_order(g[:, : 4 * tl].reshape(n_space, tl, 2, 2))[None],
                               grid_order(g[:, 4 * tl: 6 * tl].reshape(n_space, tl, 2))[None],
                               g[:, 6 * tl: 6 * tl + n_edges].reshape(1, -1),
                               g[:, 6 * tl + n_edges:].reshape(1, -1, 2), lam)
            out = torch.cat([delta.reshape(-1), ok.to(torch.float32)])
        else:
            out = torch.empty(2 * T + 1, dtype=torch.float32, device=dev)
        dist.broadcast(out, src=root, group=group)
        return out[:-1].reshape(ty, tx, 2)[:, cols].reshape(1, tl, 2), out[-1:] != 0

    v = torch.zeros((1, tl, 2), dtype=torch.float32, device=dev)
    if v_init is not None:
        vi = torch.as_tensor(v_init, dtype=torch.float32, device=dev).reshape(ty, tx, 2)
        ok = torch.isfinite(vi).all()
        v = v + torch.where(ok, vi[:, cols].reshape(1, tl, 2), torch.zeros_like(v))
    # on the card the loop sums the costs in kernel B's order: on one space
    # rank the solve then gives the one-device solve's bits
    st = lm_motion_field(
        v, ldata, tile=tile, scale=scale, tv_weight=tv_weight, tv_huber=tv_huber,
        max_iters=max_iters, loss=loss, edge_diffs=edge_diffs, solve=solve, reduce=reduce)
    vel = grid_order(all_gather_cat(st.v, group))
    return vel, st.cost[0], st.cost0[0]
