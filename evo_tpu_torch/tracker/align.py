"""Batched event-patch alignment — the tracker's core solve.

Counterpart of `evo_tpu/tracker/align.py`. Each ready patch's integrated,
normalized event image is aligned against its birth-frame gradients under
an SE(2) warp plus a flow angle, one batched LM for all ready patches:

- integration: newest `num_of_events` events, signed, nearest pixel, in the
  current rect, normalized by the Frobenius norm;
- residual at rect pixel q: pred(q)/sqrt(1e-5 + Σ pred²) + I_norm(q), with
  pred = g(W·a)·(cos φ, sin φ) and 0 outside the image;
- Huber(0.3) on the whole-patch residual norm; lost when the median of the
  last 5 final costs exceeds 0.6;
- post-solve: φ mod 2π, center ← W⁻¹·init_pt, time_without_update, counter
  reset; the event budget from the L1 norm of the warped gradients.

The JAX package selects the ready rows by a two-tier stable-sort compaction
so that its shapes stay static; here they are selected by index.

`solve_step` is one sub-batch's step of the window scan (solve the ready
patches, re-budget them): on the card one launch of the hand-written kernel
`kernels.align_step`, one block per row, whose result for a row does not
depend on the other rows; on the CPU its plain version `solve_step_ref`.
"""

from __future__ import annotations

import math

import torch

from evo_tpu_torch.core import lie
from evo_tpu_torch.kernels import align_step, interp
from evo_tpu_torch.solve.lm import lm_solve
from evo_tpu_torch.tracker import patch_state as ps

HUBER = 0.3
MAX_LM_ITERS = 10
ALIGN_FTOL = 1e-4
LOST_COST_THRESHOLD = 0.6
TIME_WITHOUT_UPDATE_SCALE = 1.0  # seconds·px
GRAD_WINDOW = 64
MAX_SOLVE_TRAVEL = 12.0


def integrate_events(table: ps.PatchTable):
    """[P, S, S] signed nearest-pixel event integration over the current
    rects; events outside the (possibly moved) rect are dropped."""
    _, x, y, p_sign, valid = ps.newest_events(table)
    tl = table.center - ps.PATCH_EXTENT
    rx = torch.round(x - tl[:, 0:1])
    ry = torch.round(y - tl[:, 1:2])
    side = ps.PATCH_SIDE
    inside = (rx >= 0) & (rx < side) & (ry >= 0) & (ry < side)
    w = torch.where(valid & inside, p_sign, torch.zeros_like(p_sign))
    flat = torch.where(inside, ry * side + rx, torch.zeros_like(rx)).long()
    img = torch.zeros(table.capacity, side * side, dtype=w.dtype, device=w.device)
    img.scatter_add_(1, flat, w)
    return img.reshape(table.capacity, side, side)


def batch_timestamps(table: ps.PatchTable):
    """(mid, oldest) timestamps of each patch's integration set."""
    t, _, _, _, valid = ps.newest_events(table)
    big = torch.tensor(1e30, dtype=t.dtype, device=t.device)
    t_min = torch.where(valid, t, big).amin(1)
    t_max = torch.where(valid, t, -big).amax(1)
    has = valid.any(1)
    mid = torch.where(has, 0.5 * (t_min + t_max), table.cur_t)
    oldest = torch.where(has, t_min, table.last_update_t)
    return mid, oldest


def patch_abs_coords(center):
    """[R, S², 2] absolute image coords of the rect pixels, x fastest."""
    r = torch.arange(ps.PATCH_SIDE, dtype=center.dtype, device=center.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    return grid[None] + (center - ps.PATCH_EXTENT)[:, None, :]


def slice_grad_window(grads, slot, se2, center):
    """(win [R, 2, G, G], ox [R], oy [R]): the GRAD_WINDOW² window of
    grads[slot] ([S, 2, H, W] store) around each SE(2)-warped center, origin
    clamped to the image."""
    h, w = grads.shape[2], grads.shape[3]
    c = lie.se2_apply(se2, center)
    ox = (torch.round(c[:, 0]).long() - GRAD_WINDOW // 2).clamp(0, w - GRAD_WINDOW)
    oy = (torch.round(c[:, 1]).long() - GRAD_WINDOW // 2).clamp(0, h - GRAD_WINDOW)
    ar = torch.arange(GRAD_WINDOW, device=grads.device)
    ch = torch.arange(2, device=grads.device)
    win = grads[slot[:, None, None, None], ch[None, :, None, None],
                (oy[:, None] + ar)[:, None, :, None],
                (ox[:, None] + ar)[:, None, None, :]]
    return win, ox, oy


def _warped_points(h: int, w: int, ox, oy, se2, center):
    """Rect pixels of each patch (absolute), their SE(2)-warped window
    coordinates (cx, cy) and whether the warped point lies in the h x w
    image."""
    pts = patch_abs_coords(center)
    wpts = lie.se2_apply(se2[:, None, :], pts)
    inb = ((wpts[..., 0] >= 0.0) & (wpts[..., 0] < w)
           & (wpts[..., 1] >= 0.0) & (wpts[..., 1] < h))
    cx = wpts[..., 0] - ox[:, None].to(wpts.dtype)
    cy = wpts[..., 1] - oy[:, None].to(wpts.dtype)
    return pts, cx, cy, inb


def _flow_residual(gx, gy, inb, cosf, sinf, norm_int):
    """(pred, s2, r) of sampled gradients gx, gy [R, S²]: the projection
    pred = g·(cos f, sin f) on the flow direction, s2 = 1e-5 + Σ pred² and the
    residual r = pred/√s2 + I_norm, both zero outside the image."""
    zero = torch.zeros((), dtype=gx.dtype, device=gx.device)
    pred = torch.where(inb, gx * cosf + gy * sinf, zero)
    s2 = 1e-5 + (pred * pred).sum(-1, keepdim=True)
    return pred, s2, torch.where(inb, pred / torch.sqrt(s2) + norm_int, zero)


def linearize(params5, norm_int, win, ox, oy, h: int, w: int, center):
    """Analytic (r [R, S²], J [R, S², 4]) of the alignment residual at d = 0
    of the SE(2)+flow retraction, sampling the pre-sliced windows
    win [R, 2, G, G] with Catmull-Rom taps in gather form — the JAX
    package's `_sample_grad_win(with_derivs=True)` and `_linearize_win_core`
    in one batched function. The geometry tangents of the warped points are
    written out (the JAX package takes them from jacfwd of the point map)."""
    se2 = params5[:, 0:4]
    flow = params5[:, 4:5]
    pts, cx, cy, inb = _warped_points(h, w, ox, oy, se2, center)
    iy, wy, dwy = interp.cubic_taps_vd(cy, GRAD_WINDOW)
    ix, wx, dwx = interp.cubic_taps_vd(cx, GRAD_WINDOW)
    vals = interp.gather_points(win, iy, ix)
    rows = interp.contract_rows(vals, wy)
    rows_d = interp.contract_rows(vals, dwy)
    g = interp.contract_cols(rows, wx)  # [R, 2, N]
    g_x = interp.contract_cols(rows, dwx)
    g_y = interp.contract_cols(rows_d, wx)
    gx, gy = g[:, 0], g[:, 1]
    cosf, sinf = torch.cos(flow), torch.sin(flow)
    pred, s2, r = _flow_residual(gx, gy, inb, cosf, sinf, norm_int)
    dpdx = g_x[:, 0] * cosf + g_x[:, 1] * sinf
    dpdy = g_y[:, 0] * cosf + g_y[:, 1] * sinf

    # tangents of the warped points under g·exp(δ), δ = (vx, vy, ω), at δ = 0
    c, s = se2[:, 0:1], se2[:, 1:2]
    px, py = pts[..., 0], pts[..., 1]
    jp = torch.stack([
        dpdx * c + dpdy * s,
        dpdx * (-s) + dpdy * c,
        dpdx * (-c * py - s * px) + dpdy * (-s * py + c * px),
        -gx * sinf + gy * cosf,
    ], dim=-1)
    zero = torch.zeros((), dtype=gx.dtype, device=gx.device)
    jp = torch.where(inb[..., None], jp, zero)

    sq = torch.sqrt(s2)
    # d(pred/s)/dδ = J/s − pred · (predᵀ J) / s³
    pj = (pred[:, None, :] @ jp)  # [R, 1, 4]
    j = jp / sq[..., None] - pred[..., None] * pj / (s2 * sq)[..., None]
    return r, j


def _sample_at_warp(grads, slot, se2, center):
    """(gx, gy [R, S²], inb [R, S²]): both gradient channels of grads[slot]
    sampled with Catmull-Rom taps at the SE(2)-warped rect pixels, the
    window sliced at the warp itself (the JAX package's
    `_sample_grad_pair`)."""
    h, w = grads.shape[2], grads.shape[3]
    win, ox, oy = slice_grad_window(grads, slot, se2, center)
    _, cx, cy, inb = _warped_points(h, w, ox, oy, se2, center)
    iy, wy = interp.cubic_taps(cy, GRAD_WINDOW)
    ix, wx = interp.cubic_taps(cx, GRAD_WINDOW)
    g = interp.sample_points(win, iy, wy, ix, wx)
    return g[:, 0], g[:, 1], inb


def residual(params5, norm_int, grads, slot, center):
    """Alignment residual [R, S²] of R parameter rows [R, 5] (SE(2) warp and
    flow angle) against grads[slot], each window sliced at its own warp."""
    gx, gy, inb = _sample_at_warp(grads, slot, params5[:, 0:4], center)
    flow = params5[:, 4:5]
    return _flow_residual(gx, gy, inb, torch.cos(flow), torch.sin(flow), norm_int)[2]


def _retract5(x, d):
    return torch.cat([lie.se2_retract(x[:, 0:4], d[:, 0:3]), x[:, 4:5] + d[:, 3:4]],
                     dim=-1)


def solve_patches(params0, norm_int, grads, slot, center):
    """Alignment LM for R patches (the JAX package's vmapped `_solve_one`): params0 [R, 5], norm_int [R, S²],
    slot [R] into the gradient store grads [S, 2, H, W], center [R, 2].
    Returns (params [R, 5], final_cost [R]) with final_cost = ½·cost, Ceres'
    convention. The gradient window is sliced once, at the initial warp;
    the travel cap keeps every accepted iterate inside it."""
    h, w = grads.shape[2], grads.shape[3]
    win, ox, oy = slice_grad_window(grads, slot, params0[:, 0:4], center)

    def lin(x):
        return linearize(x, norm_int, win, ox, oy, h, w, center)

    def travel(x, x0):
        return torch.linalg.norm(
            lie.se2_apply(x[:, 0:4], center) - lie.se2_apply(x0[:, 0:4], center),
            dim=-1,
        )

    res = lm_solve(
        lin, params0, retract=_retract5, num_iters=MAX_LM_ITERS,
        block_size=ps.PATCH_SIDE * ps.PATCH_SIDE, huber_delta=HUBER,
        init_lambda=1e-4, max_step=float(ps.PATCH_EXTENT) / 2.0,
        travel_fn=travel, max_travel=MAX_SOLVE_TRAVEL, ftol=ALIGN_FTOL,
    )
    return res.x, 0.5 * res.cost


def budgets(grad, se2, flow, center):
    """Adaptive event budget before clamping, for R patches against one
    gradient pair grad [2, H, W]: the L1 norm of the warped, flow-projected
    gradients over the rect, x0.6, sampled with bilinear taps."""
    slot = torch.zeros(se2.shape[0], dtype=torch.long, device=se2.device)
    win, ox, oy = slice_grad_window(grad[None], slot, se2, center)
    _, cx, cy, _ = _warped_points(grad.shape[1], grad.shape[2], ox, oy, se2, center)
    iy, wy = interp.linear_taps(cy, GRAD_WINDOW)
    ix, wx = interp.linear_taps(cx, GRAD_WINDOW)
    g = interp.sample_points(win, iy, wy, ix, wx)
    proj = 0.6 * (g[:, 0] * torch.cos(flow)[:, None] + g[:, 1] * torch.sin(flow)[:, None])
    return proj.abs().sum(-1)


def _border_masks(table, h: int, w: int, lost_border: int = 5):
    cx, cy = table.center[:, 0], table.center[:, 1]
    border = ((cx <= lost_border) | (cy <= lost_border)
              | (cx >= w - lost_border) | (cy >= h - lost_border))
    tl = table.center - ps.PATCH_EXTENT
    rect_oob = ((tl[:, 0] < 0) | (tl[:, 1] < 0)
                | (tl[:, 0] + ps.PATCH_SIDE >= w) | (tl[:, 1] + ps.PATCH_SIDE >= h))
    return border, rect_oob


def _set_budgets(table, grad, rows, rect_oob):
    """num_of_events with the rows `rows` (index tensor) re-budgeted."""
    noe = table.num_of_events
    if rows.numel() == 0:
        return noe
    raw = budgets(grad, table.warp[rows], table.flow[rows], table.center[rows])
    b = raw.to(torch.int32).clamp(ps.MIN_NUM_EVENTS, ps.MAX_NUM_EVENTS)
    b = torch.where(rect_oob[rows], torch.full_like(b, ps.INIT_NUM_EVENTS), b)
    noe = noe.clone()
    noe[rows] = b
    return noe


def update_budgets_solved(table: ps.PatchTable, grad, ran):
    """Budget + border-lost update for the patches that just solved; grad
    [2, H, W] is the newest detection frame's gradient pair."""
    border, rect_oob = _border_masks(table, grad.shape[1], grad.shape[2])
    rows = torch.nonzero(ran, as_tuple=True)[0]
    return table.replace(
        alive=table.alive & ~(ran & border),
        num_of_events=_set_budgets(table, grad, rows, rect_oob),
    )


def update_num_of_events(table: ps.PatchTable, grad, lost_border: int = 5):
    """Border-lost check, then the event budget of every live patch."""
    border, rect_oob = _border_masks(table, grad.shape[1], grad.shape[2],
                                     lost_border)
    apply = table.alive & ~border
    rows = torch.nonzero(apply, as_tuple=True)[0]
    return table.replace(
        alive=apply,
        num_of_events=_set_budgets(table, grad, rows, rect_oob),
    )


def optimize_ready_patches(table: ps.PatchTable, grads):
    """Solve every ready patch and apply the post-solve updates. grads
    [S, 2, H, W] is the gradient store; each patch samples its own slot.
    Returns (new_table, info) with info's ran / cost / lost [P] and the
    integrated images [P, S, S]."""
    ready = ps.is_ready(table) & table.alive & table.initialized
    integrated = integrate_events(table)
    p = table.capacity
    frob = torch.sqrt((integrated ** 2).sum((1, 2))) + 1e-12
    norm_int = (integrated / frob[:, None, None]).reshape(p, -1)
    params0 = torch.cat([table.warp, table.flow[:, None]], dim=-1)
    new_params = params0
    cost = torch.zeros(p, dtype=params0.dtype, device=params0.device)
    rows = torch.nonzero(ready, as_tuple=True)[0]
    if rows.numel():
        new_p, cost_r = solve_patches(params0[rows], norm_int[rows], grads,
                                      table.grad_slot[rows].long(),
                                      table.center[rows])
        new_params = params0.clone()
        new_params[rows] = new_p
        cost[rows] = cost_r

    mid_t, oldest_t = batch_timestamps(table)
    hist = torch.where(
        ready[:, None],
        torch.cat([table.final_costs[:, 1:], cost[:, None]], dim=1),
        table.final_costs,
    )
    n_costs = table.n_costs + ready.to(torch.int32)
    med = hist.median(dim=1).values
    lost = ready & (n_costs >= 5) & (med > LOST_COST_THRESHOLD)
    upd = ready & ~lost
    warp_new = torch.where(upd[:, None], new_params[:, 0:4], table.warp)
    flow_new = torch.where(upd, torch.remainder(new_params[:, 4], 2.0 * math.pi),
                           table.flow)
    center_new = lie.se2_apply(lie.se2_inverse(warp_new), table.init_pt)
    center_new = torch.where(upd[:, None], center_new, table.center)
    delta = torch.linalg.norm(center_new - table.center, dim=-1)
    twu = TIME_WITHOUT_UPDATE_SCALE / delta.clamp_min(0.1)
    new_table = table.replace(
        alive=table.alive & ~lost,
        warp=warp_new,
        flow=flow_new,
        center=center_new,
        counter=torch.where(ready, torch.zeros_like(table.counter), table.counter),
        final_costs=hist,
        n_costs=n_costs,
        cur_t=torch.where(ready, mid_t, table.cur_t),
        last_update_t=torch.where(ready, oldest_t, table.last_update_t),
        time_without_update=torch.where(upd, twu, table.time_without_update),
    )
    return new_table, dict(ran=ready, cost=cost, lost=lost, integrated=integrated)


def predicted_nabla(table: ps.PatchTable, grads):
    """[P, S, S] predicted gradient patches −g(W·a)·(cos φ, sin φ), every
    row against its own gradient slot — the debug view of the reference's
    `Patch::warpImage`."""
    gx, gy, _ = _sample_at_warp(grads, table.grad_slot.long(), table.warp, table.center)
    flow = table.flow[:, None]
    out = -(gx * torch.cos(flow) + gy * torch.sin(flow))
    return out.reshape(-1, ps.PATCH_SIDE, ps.PATCH_SIDE)


def cost_map(table: ps.PatchTable, grads, patch_idx: int, half_width: int = 5):
    """[(2h+1), (2h+1)] alignment cost of one patch over integer
    translations of its warp (row: y offset, column: x offset), Huber as in
    the solve, ½ρ — the reference's `Optimizer::drawCostMap` (11 x 11 by
    default)."""
    integrated = integrate_events(table)[patch_idx]
    frob = torch.sqrt((integrated ** 2).sum()) + 1e-12
    norm_int = (integrated / frob).reshape(1, -1)
    offs = torch.arange(-half_width, half_width + 1, dtype=table.warp.dtype,
                        device=table.warp.device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    n = ox.numel()
    base = torch.cat([table.warp[patch_idx], table.flow[patch_idx][None]])
    params = base.repeat(n, 1)
    params[:, 2] += ox.reshape(-1)
    params[:, 3] += oy.reshape(-1)
    slot = table.grad_slot[patch_idx].long().repeat(n)
    center = table.center[patch_idx].repeat(n, 1)
    r = residual(params, norm_int, grads, slot, center)
    s = (r * r).sum(-1)
    nrm = torch.sqrt(s + 1e-12)
    rho = torch.where(nrm <= HUBER, s, 2.0 * HUBER * nrm - HUBER * HUBER)
    return (0.5 * rho).reshape(ox.shape)


def solve_step_ref(table: ps.PatchTable, grads, latest_grad):
    """Plain version of `solve_step`: `optimize_ready_patches`, then
    `update_budgets_solved` of the rows that solved."""
    table, info = optimize_ready_patches(table, grads)
    table = update_budgets_solved(table, latest_grad, info["ran"])
    return table, info["ran"], info["cost"], info["lost"]


def solve_step(table: ps.PatchTable, grads, latest_grad):
    """Solve every ready patch against the gradient store grads [S, 2, H, W],
    apply the post-solve updates and re-budget the patches that solved
    against latest_grad [2, H, W], the newest detection frame's gradients.
    Returns (table, ran, cost, lost), the last three [P] as
    `optimize_ready_patches` logs them. A table on the card takes the kernel
    (`kernels.align_step`, one launch), a table on the CPU the plain version."""
    if table.center.device.type == "cpu":
        return solve_step_ref(table, grads, latest_grad)
    fields, ran, cost, lost, _ = align_step.align_step(table, grads, latest_grad)
    return table.replace(**fields), ran, cost, lost


SCAN_LOG_FIELDS = ("ran", "cost", "lost", "center", "cur_t", "alive", "track_id")


def process_window_scan(table: ps.PatchTable, grads, ex, ey, et, ep, mask,
                        latest_grad):
    """A frame window's K event sub-batches, in order: route events, then
    `solve_step` (solve the ready patches, re-budget the patches that
    solved). ex, ey, et, ep, mask: [K, C]. Returns (table, stacked log dict
    of [K, P, ...] tensors)."""
    logs = {k: [] for k in SCAN_LOG_FIELDS}
    for k in range(ex.shape[0]):
        table = ps.route_events(table, ex[k], ey[k], et[k], ep[k], mask[k])
        table, ran, cost, lost = solve_step(table, grads, latest_grad)
        step = dict(ran=ran, cost=cost, lost=lost,
                    center=table.center, cur_t=table.cur_t,
                    alive=table.alive, track_id=table.track_id)
        for name in SCAN_LOG_FIELDS:
            logs[name].append(step[name])
    return table, {k: torch.stack(v) for k, v in logs.items()}
