"""Pyramidal Lucas-Kanade optical flow — counterpart of
`evo_tpu/kernels/lk.py`.

All points are tracked together. Each point's level window is one
LK_WINDOW² slice around it, and every (re)sampling inside the iteration is
the separable Catmull-Rom interpolant in gather form
(`interp.sample_grid`). The iterate-translate loop stops per point after
`num_iters` trips or once the update falls under eps 0.01 — a finished point
is frozen exactly, as under the JAX package's vmapped `while_loop`.

That is the plain version (`pyramidal_lk_ref`, `track_pyramids_ref`). On the
card `pyramidal_lk` builds both pyramids with `kernels.frame_maps` and tracks
every point in one launch of `kernels.frame_rows` (a block a point, all
levels, no host read); the tracker's frame step runs that kernel with the
pyramids it keeps (`tracker.detector.frame_apply`).
"""

from __future__ import annotations

import torch

from evo_tpu_torch.kernels import interp
from evo_tpu_torch.kernels.gradients import image_pyramid

LK_WINDOW = 64


def _slice_windows(img, oy, ox, size: int):
    """[N, size, size] windows of img [H, W] at integer origins [N]."""
    ar = torch.arange(size, device=img.device)
    rows = (oy[:, None] + ar)[:, :, None]
    cols = (ox[:, None] + ar)[:, None, :]
    return img[rows, cols]


def _origin(c, half: int, hi: int):
    return (torch.round(c).long() - half).clamp(0, hi)


def _track_level(img0, img1, pt0, guess, radius: int, num_iters: int):
    """Track points pt0 [N, 2] (x, y) at one level from the initial
    displacement guess [N, 2]. Returns (flow [N, 2], ok [N])."""
    h, w = img0.shape
    win_side = min(LK_WINDOW, h, w)
    half = win_side // 2
    r = torch.arange(-radius, radius + 1, dtype=img0.dtype, device=img0.device)

    ox0 = _origin(pt0[:, 0], half, w - win_side)
    oy0 = _origin(pt0[:, 1], half, h - win_side)
    win0 = _slice_windows(img0, oy0, ox0, win_side)
    x0 = pt0[:, 0:1] - ox0[:, None].to(img0.dtype) + r  # [N, S] window coords
    y0 = pt0[:, 1:2] - oy0[:, None].to(img0.dtype) + r
    ix, wx, dwx = interp.cubic_taps_vd(x0, win_side)
    iy, wy, dwy = interp.cubic_taps_vd(y0, win_side)
    t = interp.sample_grid(win0, iy, wy, ix, wx)  # [N, S(y), S(x)] template
    gx = interp.sample_grid(win0, iy, wy, ix, dwx)
    gy = interp.sample_grid(win0, iy, dwy, ix, wx)
    a11 = (gx * gx).sum((1, 2))
    a12 = (gx * gy).sum((1, 2))
    a22 = (gy * gy).sum((1, 2))
    det = a11 * a22 - a12 * a12
    ok_grad = det > 1e-7
    det_safe = torch.where(ok_grad, det, torch.ones_like(det))

    ox1 = _origin(pt0[:, 0] + guess[:, 0], half, w - win_side)
    oy1 = _origin(pt0[:, 1] + guess[:, 1], half, h - win_side)
    win1 = _slice_windows(img1, oy1, ox1, win_side)
    bx1 = pt0[:, 0:1] - ox1[:, None].to(img0.dtype) + r
    by1 = pt0[:, 1:2] - oy1[:, None].to(img0.dtype) + r

    eps2 = 1e-4  # OpenCV criteria: eps 0.01, squared
    v = guess.to(img0.dtype).clone()
    d2 = torch.full_like(a11, float("inf"))
    it = 0
    while it < num_iters:
        active = d2 >= eps2
        if not bool(active.any()):
            break
        jx, vx = interp.cubic_taps(bx1 + v[:, 0:1], win_side)
        jy, vy = interp.cubic_taps(by1 + v[:, 1:2], win_side)
        e = interp.sample_grid(win1, jy, vy, jx, vx) - t
        b1 = (e * gx).sum((1, 2))
        b2 = (e * gy).sum((1, 2))
        dv = torch.stack([-(a22 * b1 - a12 * b2) / det_safe,
                          -(-a12 * b1 + a11 * b2) / det_safe], dim=-1)
        v = torch.where(active[:, None], v + dv, v)
        d2 = torch.where(active, (dv * dv).sum(-1), d2)
        it += 1
    # the target window is anchored at pt0 + guess: an iterate that travels
    # beyond its slack samples clamped window edges, so it fails
    slack = half - radius - 1
    ok_travel = ((v - guess).abs() <= slack).all(-1)
    return v, ok_grad & torch.isfinite(v).all(-1) & ok_travel


def track_pyramids_ref(pyr0, pyr1, pts, valid, *, radius: int = 10, num_iters: int = 30):
    """Track points pts [N, 2] (x, y) from pyramid pyr0 to pyr1 (level 0
    first, as `image_pyramid` gives them). Returns (new_pts, flow, status)."""
    num_levels = len(pyr0)
    flow = torch.zeros_like(pts)
    status = valid.clone()
    for lvl in range(num_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        v, ok = _track_level(pyr0[lvl], pyr1[lvl], pts / scale, flow / scale,
                             radius, num_iters)
        flow = v * scale
        status = status & ok
    new_pts = pts + flow
    h, w = pyr1[0].shape
    in_img = ((new_pts[:, 0] >= 1) & (new_pts[:, 0] < w - 1)
              & (new_pts[:, 1] >= 1) & (new_pts[:, 1] < h - 1))
    return new_pts, flow, status & in_img


def pyramidal_lk_ref(img0, img1, pts, valid, *, num_levels: int = 3,
                     radius: int = 10, num_iters: int = 30):
    """Plain version of `pyramidal_lk`."""
    return track_pyramids_ref(image_pyramid(img0, num_levels), image_pyramid(img1, num_levels),
                              pts, valid, radius=radius, num_iters=num_iters)


def pyramidal_lk(img0, img1, pts, valid, *, num_levels: int = 3,
                 radius: int = 10, num_iters: int = 30):
    """Track points pts [N, 2] (x, y) from img0 to img1 ([H, W] each).

    Returns (new_pts [N, 2], flow [N, 2], status [N] bool). Images on the
    card take the kernels (`frame_maps` for each pyramid, one `frame_rows`
    launch for the points), images on the CPU the plain version."""
    if img0.device.type == "cpu":
        return pyramidal_lk_ref(img0, img1, pts, valid, num_levels=num_levels,
                                radius=radius, num_iters=num_iters)
    from evo_tpu_torch.kernels import frame_maps, frame_rows

    pyr0, pyr1 = (frame_maps.pyramid(im, frame_maps.frame_maps(im), num_levels)
                  for im in (img0, img1))
    flow, status = frame_rows.track(pyr0, pyr1, pts, valid, radius=radius,
                                    num_iters=num_iters)
    return pts + flow, flow, status
