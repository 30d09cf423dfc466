"""Compensation windows solved together — counterpart of
`evo_tpu/dist/temporal.py`.

Compensation windows are independent: a window's tile solve reads only its
own events, and its result feeds artifacts, never the tracker's state. So W
buffered windows can be solved at once, with the same result per window as
solving each alone (cold). On one card (`mesh=None`) that is the batched LM
of `tracker.compensate.solve_motion_field_batched`: its device-side loop
launches kernels A and B once each a trip over all W windows (one block a
tile row, one a window, so a window's bits do not depend on the batch), with
a read of the stop flag every few trips, where the JAX package vmaps the
solve. With a mesh the windows are
split over the ``batch`` ranks, each rank solves its block batched, and the
solved fields are gathered.

The tracker's event path cannot be distributed this way (window k+1's patch
state depends on window k's solves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.core.transfer import HostCopy
from evo_tpu_torch.dist.mesh import BATCH_AXIS, all_gather_cat, axis_size, block
from evo_tpu_torch.tracker import compensate as comp


def _pad_tile_data(td: comp.TileData, e_max: int) -> comp.TileData:
    """One window's tile data with its event axis ([T, E] fields) padded to
    e_max; padding is masked out by `valid`."""
    pad = e_max - td.ex.shape[1]
    if pad == 0:
        return td
    return dataclasses.replace(
        td, ex=F.pad(td.ex, (0, pad)), ey=F.pad(td.ey, (0, pad)),
        dt_us=F.pad(td.dt_us, (0, pad)), valid=F.pad(td.valid, (0, pad), value=False))


def _stack(tds) -> comp.TileData:
    """W windows' tile data with a leading window axis."""
    return comp.TileData(**{f.name: torch.stack([getattr(td, f.name) for td in tds])
                            for f in dataclasses.fields(comp.TileData)})


def compensate_windows_batched(windows, params=None, height: int = 180,
                               width: int = 240, mesh=None, device=None):
    """Solve W compensation windows together, cold, on `device` (None: the
    card when there is one); with `mesh`, the windows split over its
    ``batch`` axis.

    windows: list of (x, y, t_us) host arrays, one per window. Returns a list
    of (motion_field [TY, TX, 2], compensated_image [H, W], cost, cost0) on
    the host, in window order: each window's result is that of
    `compensate.compensate_window` on it (up to the summation order the
    padding changes), copied to the host in one `HostCopy`."""
    p = params or comp.CompensateParams()
    dev = resolve(device)
    built = [comp.build_tile_data(x, y, t_us, p, height, width, dev)
             for (x, y, t_us) in windows]
    edges, ty_n, tx_n = built[0][1], built[0][2], built[0][3]
    e_max = max(b[0].ex.shape[1] for b in built)
    padded = [_pad_tile_data(b[0], e_max) for b in built]
    w = len(windows)
    # a mesh: the window axis padded to a multiple of the batch size with
    # dead copies of the last window (no valid event, no active tile), whose
    # results are dropped
    n_batch = 1 if mesh is None else axis_size(mesh, BATCH_AXIS)
    dead = dataclasses.replace(padded[-1], valid=torch.zeros_like(padded[-1].valid),
                               active=torch.zeros_like(padded[-1].active))
    padded += [dead] * ((-w) % n_batch)
    if mesh is not None:
        padded = padded[block(mesh, BATCH_AXIS, len(padded))]
    kw = dict(tile=p.tile, scale=p.scale, tv_weight=p.tv_weight, tv_huber=p.tv_huber,
              max_iters=p.max_iters, loss=p.loss)
    vels, costs, costs0 = comp.solve_motion_field_batched(_stack(padded), edges, **kw)
    if mesh is not None:
        group = mesh.get_group(BATCH_AXIS)
        vels = all_gather_cat(vels, group)
        costs, costs0 = (all_gather_cat(c, group) for c in (costs, costs0))

    imgs = []
    for i, (x, y, t_us) in enumerate(windows):
        tid, t_mid = built[i][4], built[i][5]
        imgs.append(comp.compensated_count_splat(
            vels[i], torch.as_tensor(tid).to(dev),
            torch.as_tensor(x.astype(np.float32)).to(dev),
            torch.as_tensor(y.astype(np.float32)).to(dev),
            torch.as_tensor((t_mid - t_us).astype(np.float32)).to(dev),
            p.scale, height, width))
    pulled = HostCopy(dict(vel=vels[:w], cost=costs[:w], cost0=costs0[:w],
                           imgs=torch.stack(imgs))).get()
    return [(pulled["vel"][i].reshape(ty_n, tx_n, 2), pulled["imgs"][i],
             float(pulled["cost"][i]), float(pulled["cost0"][i])) for i in range(w)]
