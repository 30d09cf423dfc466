"""Patch tables for the tests of the alignment step
(`evo_tpu_torch.tracker.align.solve_step` and its kernel), made with numpy
from a seed. It imports no JAX, so the tests of the card import it too.

`edge_table` holds one row of each case the step must get right beside
ordinary ready rows: no integration set, events outside the rect, a window
clamped at the image border, a rect that leaves the image (`rect_oob`), a row
that ends at the border (border-lost), a warp that carries most of the rect
out of the image, a degenerate system (no gradient: a singular, damped
normal matrix), a lost row (the median of its last five costs above 0.6),
rows that are not ready, dead or not initialized, and, with `nan_row`, a
row whose flow is NaN (every step bad).
"""

import numpy as np

from evo_tpu_torch.tracker import patch_state as ps

H, W = 180, 240
LOST_COST_THRESHOLD = 0.6  # tracker/align.py


def smooth_grads(rng, slots: int = 4, h: int = H, w: int = W, blobs: int = 400,
                 zero_slot: int | None = 3):
    """[slots, 2, h, w] float32 gradient store of smooth images (sums of
    Gaussian blobs of 2-4 px: texture in both directions in every patch, so
    that the alignment has a sharp optimum), slot `zero_slot` all zeros."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.zeros((slots, 2, h, w), np.float32)
    for s in range(slots):
        if s == zero_slot:
            continue
        img = np.zeros((h, w))
        for _ in range(blobs):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            sig = rng.uniform(2.0, 4.0)
            img += rng.uniform(-1, 1) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
        gy, gx = np.gradient(img)
        out[s, 0], out[s, 1] = gx, gy
    return out


def _events_for(rng, grad2, cx, cy, e: int):
    """E events at the integer pixels of the rect around (cx, cy), drawn with
    a density that grows with the x gradient there and with its negative
    sign as polarity: the image a flow of angle 0 makes, so the row starts
    near a sharp optimum."""
    r = np.arange(-ps.PATCH_EXTENT, ps.PATCH_EXTENT + 1)
    px = np.clip(np.round(cx) + r, 0, grad2.shape[2] - 1).astype(int)
    py = np.clip(np.round(cy) + r, 0, grad2.shape[1] - 1).astype(int)
    gx = grad2[0][np.ix_(py, px)]
    weight = np.abs(gx) + 0.05 * np.abs(gx).max() + 1e-12
    pick = rng.choice(gx.size, e, p=(weight / weight.sum()).ravel())
    iy, ix = np.divmod(pick, len(r))
    pol = np.where(gx.ravel()[pick] > 0, -1.0, 1.0)
    return (px[ix].astype(np.float32), py[iy].astype(np.float32),
            pol.astype(np.float32))


ORDINARY = 8  # rows 0-7: ordinary ready rows; the edge rows follow
EDGES = ("no_events", "events_outside", "window_clamped", "rect_oob", "border",
         "leaves_image", "degenerate", "lost", "not_ready", "dead", "uninitialized")


def edge_table(rng, grads, nan_row: bool = False):
    """A table (numpy, by field) of ORDINARY ready rows and then one row of
    each of EDGES (and "nan_flow" with `nan_row`) against `grads`
    (`smooth_grads`: slot 3 holds no gradient). Returns (the table, the row
    index of each case by name)."""
    names = [f"ready_{i}" for i in range(ORDINARY)] + list(EDGES)
    if nan_row:
        names.append("nan_flow")
    p = len(names)
    t = ps.table_to_numpy(ps.empty_table(p, device="cpu"))
    e = t["ev_t"].shape[1]
    h, w = grads.shape[2], grads.shape[3]
    center = np.stack([rng.uniform(40, w - 40, p), rng.uniform(40, h - 40, p)], -1)
    rows = {n: i for i, n in enumerate(names)}
    center[rows["window_clamped"]] = (20.3, 15.6)
    center[rows["rect_oob"]] = (8.4, 90.2)
    center[rows["border"]] = (3.6, 100.1)
    center[rows["leaves_image"]] = (w - 14.2, 60.7)
    center = center.astype(np.float32)
    slot = (np.arange(p) % 3).astype(np.int32)
    slot[rows["degenerate"]] = 3
    warp = np.tile(np.array([1, 0, 0, 0], np.float32), (p, 1))
    # start a little off the alignment, so that the LM moves
    warp[:, 2:4] = rng.uniform(-0.6, 0.6, (p, 2)).astype(np.float32)
    ang = rng.uniform(-0.02, 0.02, p)
    warp[:, 0], warp[:, 1] = np.cos(ang), np.sin(ang)
    warp[rows["leaves_image"], 2] = 10.0  # most of the rect warps off the right edge
    ev = {k: np.zeros((p, e), np.float32) for k in ("ev_t", "ev_x", "ev_y", "ev_p")}
    for i in range(p):
        ex, ey, ep = _events_for(rng, grads[slot[i]], center[i, 0], center[i, 1], e)
        ev["ev_x"][i], ev["ev_y"][i], ev["ev_p"][i] = ex, ey, ep
        ev["ev_t"][i] = np.sort(rng.uniform(0, 0.05, e)).astype(np.float32)
    ev["ev_x"][rows["events_outside"]] += 40.0
    noe = np.full(p, ps.MAX_NUM_EVENTS, np.int32)
    noe[rows["no_events"]] = 0
    counter = np.full(p, ps.READY_COUNTER + 5, np.int32)
    counter[rows["not_ready"]] = 5
    alive = np.ones(p, bool)
    alive[rows["dead"]] = False
    initialized = np.ones(p, bool)
    initialized[rows["uninitialized"]] = False
    final_costs = rng.uniform(0.0, 0.2, (p, 5)).astype(np.float32)
    n_costs = rng.integers(0, 8, p).astype(np.int32)
    final_costs[rows["lost"]] = 1.0
    n_costs[rows["lost"]] = 4
    flow = np.zeros(p, np.float32)
    if nan_row:
        flow[rows["nan_flow"]] = np.nan
    t.update(
        alive=alive, initialized=initialized, track_id=np.arange(p, dtype=np.int32),
        center=center, init_pt=(center + rng.uniform(-1, 1, (p, 2))).astype(np.float32),
        warp=warp, flow=flow, num_of_events=noe, counter=counter,
        ev_count=np.full(p, e + 17, np.int32), grad_slot=slot,
        final_costs=final_costs, n_costs=n_costs,
        cur_t=rng.uniform(0, 0.05, p).astype(np.float32),
        last_update_t=rng.uniform(0, 0.05, p).astype(np.float32), **ev,
    )
    return t, rows


def rect_displacement(wa, wb, center):
    """[P] largest distance between the images of a row's rect pixels under
    the warps wa and wb [P, 4] (float64)."""
    r = np.arange(-ps.PATCH_EXTENT, ps.PATCH_EXTENT + 1, dtype=np.float64)
    gx, gy = np.meshgrid(r, r)
    px = center[:, 0, None] + gx.ravel()[None]
    py = center[:, 1, None] + gy.ravel()[None]

    def apply(w):
        w = w.astype(np.float64)
        return (w[:, 0, None] * px - w[:, 1, None] * py + w[:, 2, None],
                w[:, 1, None] * px + w[:, 0, None] * py + w[:, 3, None])

    (ax, ay), (bx, by) = apply(wa), apply(wb)
    return np.sqrt((ax - bx) ** 2 + (ay - by) ** 2).max(1)


def angle_diff(a, b):
    return np.abs((a.astype(np.float64) - b + np.pi) % (2 * np.pi) - np.pi)


# rows whose solve float32 leaves loose, with their (px, rad) bars: most of
# `leaves_image`'s rect warps out of the image, so few pixels hold it, it
# runs all 10 trips, and the plain version alone moves it up to 6.3e-4 px
# (centre), 3.4e-3 px (rect pixels) and 1.35e-3 rad (flow) between the CPU
# and the card, as far as the kernel moves it from the plain version there
WEAK_ROWS = {"leaves_image": (5e-3, 3e-3)}


def assert_same_step(ours: dict, ref: dict, ran, cost, ref_cost, center0, rows,
                     px: float = 1e-3, rad: float = 1e-4):
    """Two results of one step (numpy tables `ours` and `ref`, the costs of
    the rows that ran) held to the bars `tests/test_torch_align_step.py`
    states, row by row, with the failing rows' names in the message: the
    centres and where the two warps put each rect pixel within `px`, the
    flow within `rad`, `WEAK_ROWS` within their own bars. A row whose median
    final cost lies within 1e-5 of the lost threshold may be lost in one
    result and not in the other."""
    names = list(rows)
    px_bar = np.array([WEAK_ROWS.get(n, (px, rad))[0] for n in names])
    rad_bar = np.array([WEAK_ROWS.get(n, (px, rad))[1] for n in names])
    med = np.median(ref["final_costs"], axis=1)
    sure = np.abs(med - LOST_COST_THRESHOLD) > 1e-5

    def which(bad):
        return [names[i] for i in np.nonzero(bad)[0]]

    for name in ("alive", "counter", "n_costs", "cur_t", "last_update_t"):
        bad = (ours[name] != ref[name]).reshape(len(names), -1).any(1)
        if name == "alive":
            bad &= sure
        assert not bad.any(), (name, which(bad))
    bad = np.abs(ours["num_of_events"].astype(int) - ref["num_of_events"]) > 1
    assert not bad.any(), ("num_of_events", which(bad))
    c, rc = cost[ran], ref_cost[ran]
    assert np.all(np.abs(c - rc) <= 1e-4 * np.abs(rc)), ("cost", c, rc)
    bad = np.abs(ours["center"] - ref["center"]).max(1) > px_bar
    assert not bad.any(), ("center", which(bad))
    bad = rect_displacement(ours["warp"], ref["warp"], center0) > px_bar
    assert not bad.any(), ("warp", which(bad))
    bad = angle_diff(ours["flow"], ref["flow"]) > rad_bar
    assert not bad.any(), ("flow", which(bad))
    twu, rtwu = ours["time_without_update"], ref["time_without_update"]
    bad = np.abs(twu - rtwu) > 1e-3 * np.abs(rtwu)
    assert not bad.any(), ("time_without_update", which(bad))
