"""Compensation on one CUDA card: its two kernels held to their plain
versions and timed, and the seconds it takes end to end in the evaluator.

    python evo_tpu_torch/run/time_comp.py [--root DIR] [--modes tracker sync default]
    python evo_tpu_torch/run/time_comp.py [--root DIR] --kernels

`main` times the evaluator's runs on the 3walls scene (1.2 s at DAVIS
density, seed 3, as `chip_smoke.py` drives it) with the `evo_tpu_torch`
package found under DIR (default: the tree this file is in): the tracker
experiment, the standard mode on the synchronous drive and on the default
drive, each after a short warm-up run. It prints one JSON line a mode: wall
and stage seconds, compensation windows, the launches and host reads of
compensation and VO's launches where the tree counts them, and in the
standard mode VO's seconds by geometric stage (`vo_stage_s`). Only names that every version of
the port with temporal batching has are used, so two trees can be compared
in one call on one card: unpack the other commit into a directory
`.gitignore` lists and run this file once per tree, in turns.

`check_comp_tile` and `check_comp_step` (used by `chip_smoke.py` phase 3)
hold kernel A (`kernels.comp_tile`) and kernel B (`kernels.comp_step`) to
their plain versions in `tracker.compensate` at the main path's shapes and
time them: device ms a launch over many launches between one pair of CUDA
events behind a busy queue, host µs a launch, the bound, the plain version's
time and, for B, the library's (`torch.linalg.cholesky_ex` and
`torch.cholesky_solve` on the same assembled dense systems, which the port
never calls). Where the tree's wrappers have the clock builds (`STAGES`),
`clock_comp_tile` and `clock_comp_step` hold each clock build to its plain
build bit for bit and split a launch's cycles by stage. `--kernels` runs
all of these at `TILE_SHAPES` and `STEP_SHAPES` (phase 3's shapes) on the
tree under DIR and prints one JSON line a shape, so two trees' kernels can
be timed in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
# kernel A's function, counted as the operations it needs (the kernel does
# more: 16 candidate taps an event, 64 deposits, the differences and
# products again for each vertical tap): a valid event's warp (~8), its
# 2 (2r + 1) = 14 Gaussian taps with slopes (~12 each) and (2r + 1)^2 = 49
# deposits into 3 planes (a multiply and an add each); a pixel of a tile
# whose loss is taken: 6 differences, the 3 products with their 6 tangents
# (21), the separable 7-tap blur of 9 planes (2 x 9 x 7 x 2), lambda_1 with
# its tangents (~40) and its share of the pool (~7)
COMP_TILE_FLOPS_PER_EVENT = 8 + 2 * 7 * 12 + 7 * 7 * 3 * 2
COMP_TILE_FLOPS_PER_PIXEL = 6 + 21 + 2 * 9 * 7 * 2 + 40 + 7
SCENE = dict(duration_s=1.2, fps=20.0, seed=3, scene="3walls", contrast_threshold=0.05)
# kernel A against its plain version: the score relative, J absolute (r = maxRes
# - score, near 1000, cannot hold the score's 0.005-0.3 to 1e-4 alone)
TOL_SCORE, TOL_J = 1e-4, 1e-3
# the main path's shapes (`chip_smoke.py` phase 3): kernel A (windows, events
# a tile, loss, tile px) and kernel B (windows, tile px); B also at the 15 px
# tiles of `dist.multihost`'s scaling measurement (192 tiles, band 32), the
# band its block-wide factorisation takes
TILE_SHAPES = ((1, 256, "edge", 20), (1, 1024, "edge", 20), (1, 1024, "variance", 20),
               (8, 1024, "edge", 20), (1, 1024, "edge", 40))
STEP_SHAPES = ((1, 20), (8, 20), (1, 40), (1, 15))


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_error(A, b, delta):
    """The normwise backward error of a step delta [W, T, 2] for the damped
    systems A [W, 2T, 2T] delta = -b [W, 2T], in float64 (per window):
    |b + A delta| / (|A| |delta| + |b|) in the max norms. A Cholesky solve
    in float32 keeps it near 1e-7 whatever the system's condition, where its
    forward error grows with the condition (two float32 solves of a system
    of condition 3e4 part by ~1e-4 of the step)."""
    A, b = A.double(), b.double()
    x = delta.double().reshape(b.shape)
    res = (b[..., None] + A @ x[..., None])[..., 0]
    return res.abs().amax(-1) / (A.abs().sum(-1).amax(-1) * x.abs().amax(-1) + b.abs().amax(-1))


def tile_rows(dev, nw: int, e: int, tile: int = 20, seed: int = 0):
    """W windows of the DAVIS240C tiles of `tile` px, E slots each, about 70 %
    filled with events within 15 ms of the window's mid time, laid out as
    `compensate.build_tile_data` lays them out and flattened to [W·T, E]
    rows: (vel [W·T, 2], TileData)."""
    from evo_tpu_torch.tracker.compensate import TileData

    gen = torch.Generator(device="cpu").manual_seed(seed)
    tx = 240 // tile
    t = torch.arange(tx * (180 // tile)).repeat(nw)
    rows = len(t)
    tlx = (t % tx * tile).float()
    tly = (t // tx * tile).float()
    # events on a few edges of each tile, so the edge loss has structure
    ex = tlx[:, None] + (torch.randint(0, 4, (rows, e), generator=gen) * tile / 4
                         + torch.rand(rows, e, generator=gen) * 0.6)
    ey = tly[:, None] + torch.rand(rows, e, generator=gen) * tile
    dt_us = torch.rand(rows, e, generator=gen) * 30_000 - 15_000
    valid = torch.rand(rows, e, generator=gen) < 0.7
    active = torch.rand(rows, generator=gen) < 0.9
    vel = torch.randn(rows, 2, generator=gen) * 0.05
    vel[0] = 0.0  # integer offsets: outer taps exactly at |d| == radius
    data = TileData(*(a.contiguous().to(dev) for a in (ex, ey, dt_us, valid, tlx, tly, active)))
    return vel.contiguous().to(dev), data


def _events(data) -> dict:
    return {k: getattr(data, k) for k in ("ex", "ey", "dt_us", "valid", "tlx", "tly", "active")}


def check_comp_tile(timer, dev, nw: int, e: int, loss: str = "edge", reps: int = 200,
                    tile: int = 20) -> dict:
    """Kernel A against its plain version (autograd through the plain splat,
    on the card) on W windows of the DAVIS240C tiles of `tile` px (108 of
    20 px, 24 of 40 px), E events each: the score (r = MAX_RES - score where
    the loss is taken) within 1e-4 relative, r equal to the plain r where
    the tile escaped or is inactive (to 1e-4 relative), J within 1e-3,
    `escaped` equal. Raises otherwise."""
    from evo_tpu_torch.kernels import comp_tile
    from evo_tpu_torch.kernels.splat import warp_splat_ref
    from evo_tpu_torch.tracker import compensate as comp

    vel, data = tile_rows(dev, nw, e, tile)
    rows, side = vel.shape[0], 3 * tile
    kw = dict(tile=tile, scale=1e-3, loss=loss, weight=comp.GAUSS_NORM,
              sigma=comp.SIGMA_SPLAT, radius=comp.SPLAT_RADIUS, blur=comp.blur_taps())
    r, J = torch.empty(rows, device=dev), torch.empty((rows, 2), device=dev)
    esc = torch.empty(rows, dtype=torch.bool, device=dev)
    score = torch.empty(rows, device=dev)
    comp_tile.TileLaunch(vel, _events(data), **kw, r=r, J=J, escaped=esc, score=score).launch()
    r_ref, J_ref = comp.tile_residual_and_jacobian_ref(vel, data, tile, 1e-3, loss,
                                                       splat=warp_splat_ref)
    img = warp_splat_ref(vel, data.ex, data.ey, data.dt_us, data.valid, data.tlx, data.tly,
                         scale=1e-3, tile=tile, weight=comp.GAUSS_NORM)
    esc_ref = img.mean((1, 2)) <= 1e-4
    score_ref = (comp.tile_edge_loss(img) / comp.MAX_RES if loss == "edge"
                 else comp.tile_variance_loss(img))
    torch.cuda.synchronize()
    scored = data.active & ~esc_ref
    err_score = ((score - score_ref).abs() / score_ref.abs().clamp_min(1e-30))[scored].max().item()
    err_r = ((r - r_ref).abs() / r_ref.abs().clamp_min(1e-30))[~scored].max().item() \
        if bool((~scored).any()) else 0.0
    err_J = (J - J_ref).abs().max().item()
    same_esc = bool(torch.equal(esc, esc_ref))
    score_size = score_ref[scored].abs().min().item()
    if not (err_score <= TOL_SCORE and err_r <= TOL_SCORE and err_J <= TOL_J and same_esc
            and J_ref.abs().max().item() > 10 * TOL_J):
        raise AssertionError(f"comp_tile [{rows}, {e}] {tile} px {loss}: score off by "
                             f"{err_score} (relative), r elsewhere by {err_r}, J by {err_J} "
                             f"(|J| up to {J_ref.abs().max().item()}), escaped equal {same_esc}")
    out_r, out_J = torch.empty_like(r), torch.empty_like(J)
    launch = comp_tile.TileLaunch(vel, _events(data), **kw, r=out_r, J=out_J).launch
    loss_rows = float((data.active & ~esc).sum())
    n_flops = (float(data.valid.sum()) * COMP_TILE_FLOPS_PER_EVENT
               + loss_rows * side * side * COMP_TILE_FLOPS_PER_PIXEL)
    n_bytes = rows * e * 13 + rows * (8 + 8 + 1) + rows * (4 + 8 + 1)
    b_ms, by = bound(n_bytes, n_flops)
    return dict(kernel="comp_tile", shape=f"{loss} [{rows}, {e}] {tile} px -> r, J",
                max_abs_err=err_J, score_rel_err=err_score, r_rel_err=err_r,
                score_min=score_size, ms=timer.device_ms(launch, reps),
                host_us=timer.host_us(launch, reps),
                plain_ms=timer.device_ms(lambda: comp.tile_residual_and_jacobian_ref(
                    vel, data, tile, 1e-3, loss, splat=warp_splat_ref), 5),
                bound_ms=b_ms, bound_by=by, bound_flops=n_flops, bound_bytes=n_bytes,
                library_ms=None, escaped=int(esc.sum()), loss_rows=int(loss_rows))


def check_comp_step(timer, dev, nw: int, tile: int = 20, reps: int = 200) -> dict:
    """Kernel B against its plain version on W windows of the DAVIS240C grid
    of `tile` px tiles (r and J from kernel A): the solve entry against
    `tile_system_ref` (ok equal, a backward error of at most 1e-6: both
    factorisations round in float32, each in its own order, and their
    forward errors grow with the system's condition, so those are printed,
    not held); the loop entry's INIT | HEAD, then TAIL | HEAD at the
    candidate's residuals, each against `lm_step_ref` on a copy of the
    kernel's state before the launch (costs 1e-5 relative; the accept,
    damping and stop equal; the candidate the solve entry's on the pieces
    the plain version forms, within 1e-5 of the step: the same device code on
    the same system, where one weight an ulp apart moves it ~2e-6). Raises
    otherwise."""
    from evo_tpu_torch.kernels import comp_step
    from evo_tpu_torch.solve.lm import huber_weights
    from evo_tpu_torch.tracker import compensate as comp

    tx, ty = 240 // tile, 180 // tile
    t = tx * ty
    vel, data = tile_rows(dev, nw, 1024, tile, seed=5)
    edges = comp.grid_edges(ty, tx, dev)
    p, q, band = edges.p, edges.q, edges.band
    tv = dict(tv_weight=1e3, tv_huber=10.0)

    def residuals(v):
        r, J = comp.tile_residual_and_jacobian(v.reshape(-1, 2).contiguous(), data, tile, 1e-3)
        return r.reshape(nw, t), J.reshape(nw, t, 2)

    v = vel.reshape(nw, t, 2)
    r, J = residuals(v)
    # the solve entry on the loop's first system
    d = v[:, p] - v[:, q]
    w2 = (huber_weights(((1e3 * d.abs()) ** 2).sum(-1), 10.0) * 1e3 * 1e3).contiguous()
    jj = (J[..., :, None] * J[..., None, :]).contiguous()
    jr = (J * r[..., None]).contiguous()
    lam = torch.full((nw,), 1e-4, device=dev)
    plain = comp.tile_system_ref(nw, t, p, q)
    delta, ok = comp_step.solve(jj, jr, w2, d.contiguous(), lam, edges)
    want, ok_ref = plain(jj, jr, w2, d, lam)
    # both factorisations round in float32, each in its own order: each is
    # held to the system by its backward error; the forward errors against a
    # float64 solve are printed beside
    A, b = plain.assemble(jj, jr, w2, d, lam)
    exact = -torch.linalg.solve(A.double(), b.double()[..., None])[..., 0].reshape(nw, t, 2)
    scale = exact.abs().amax((1, 2))

    def off(x):
        return ((x.double() - exact).abs().amax((1, 2)) / scale).max().item()

    err_solve, err_plain = off(delta), off(want)
    eta, eta_plain = (backward_error(A, b, x).max().item() for x in (delta, want))
    if not (torch.equal(ok, ok_ref) and bool(ok.all()) and eta <= 1e-6):
        raise AssertionError(f"comp_step solve, {nw} x {t} tiles: ok {ok.tolist()} against "
                             f"{ok_ref.tolist()}, backward error {eta} (the plain "
                             f"version's {eta_plain})")
    # the loop entry, two launches, each against the plain step run on a copy
    # of the kernel's state before it: the decisions equal, the costs within
    # 1e-5 relative, and the candidate that of the solve entry (held above)
    # on the head's system as the plain version assembles its pieces
    loop = comp_step.LmLoop(nw, edges, **tv)
    loop.v.copy_(v)
    loop.r.copy_(r)
    loop.J.copy_(J)
    errs = {}

    def state(init: bool):
        ints = {k: getattr(loop, k).clone() for k in ("active", "iters")}
        return comp.LmState(
            v=loop.v.clone(), r=loop.r.clone(), J=loop.J.clone(), d=loop.v[:, p] - loop.v[:, q],
            lam=lam.clone() if init else loop.lam.clone(),
            cost=None if init else loop.cost.clone(), cost0=None if init else loop.cost0.clone(),
            active=torch.ones(nw, dtype=torch.bool, device=dev) if init else ints["active"] != 0,
            iters=torch.zeros(nw, dtype=torch.int32, device=dev) if init else ints["iters"],
            v_new=None if init else loop.v_new.clone(),
            bad=None if init else loop.bad != 0)

    def head_by_entry(st):
        """The head's candidate from the solve entry on the pieces the plain
        version forms from the state, and the step's size."""
        w2 = (huber_weights(((1e3 * st.d.abs()) ** 2).sum(-1), 10.0) * 1e3 * 1e3).contiguous()
        step, _ = comp_step.solve((st.J[..., :, None] * st.J[..., None, :]).contiguous(),
                                  (st.J * st.r[..., None]).contiguous(), w2,
                                  st.d.contiguous(), st.lam.contiguous(), edges)
        return st.v + step, step.abs().amax((1, 2)).clamp_min(1e-30)

    def compare(what, st, mode, **res):
        comp.lm_step_ref(st, mode, p, q, **res, **tv)
        by_entry, size = head_by_entry(st)
        live = st.active & ~st.bad
        off = ((loop.v_new - by_entry).abs().amax((1, 2)) / size)[live]
        e = dict(cost_rel=((loop.cost - st.cost).abs() / st.cost.abs()).max().item(),
                 candidate_to_solve_entry=off.max().item() if off.numel() else 0.0,
                 candidate_to_plain=((loop.v_new - st.v_new).abs().amax((1, 2))
                                     / size)[live].max().item() if off.numel() else 0.0,
                 v_equal=bool(torch.equal(loop.v, st.v)),
                 bad_equal=bool(torch.equal(loop.bad != 0, st.bad)),
                 active_equal=bool(torch.equal(loop.active != 0, st.active)),
                 lam_equal=bool(torch.equal(loop.lam, st.lam)))
        errs[what] = e
        if not (e["cost_rel"] <= 1e-5 and e["v_equal"] and e["bad_equal"] and e["active_equal"]
                and e["lam_equal"] and e["candidate_to_solve_entry"] <= 1e-5):
            raise AssertionError(f"comp_step loop entry, {nw} x {t} tiles, {what}: {e}")

    st = state(True)
    loop.step(comp_step.INIT | comp_step.HEAD)
    compare("init", st, comp_step.INIT | comp_step.HEAD)
    r_new, J_new = residuals(loop.v_new)
    loop.r_new.copy_(r_new)
    loop.J_new.copy_(J_new)
    st = state(False)
    loop.step(comp_step.TAIL | comp_step.HEAD)
    compare("tail", st, comp_step.TAIL | comp_step.HEAD, r_new=r_new, J_new=J_new)
    # time: the head alone (the solve: the launch's long part) is idempotent
    head = lambda: loop.step(comp_step.HEAD)  # noqa: E731
    loop.active.fill_(1)
    # what the head needs: the edges' differences and IRLS weights and their
    # share of the assembly (~30 an edge), the tiles' blocks (~10 a tile),
    # the banded factorisation (n band^2) and the two substitutions (4 n band)
    n = 2 * t
    n_flops = nw * (30 * p.numel() + 10 * t + n * band * band + 4 * n * band)
    n_bytes = nw * (t * (2 + 1 + 2 + 2) * 4 + 16) + 2 * p.numel() * 8
    b_ms, by = bound(n_bytes, n_flops)
    A, b = plain.assemble(jj, jr, w2, d, lam)

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        torch.cholesky_solve(b[..., None], L)

    return dict(kernel="comp_step", shape=f"{nw} x {t} tiles, band {band}, one HEAD launch",
                max_abs_err=(delta - want).abs().max().item(), backward_error=eta,
                plain_backward_error=eta_plain, solve_of_step=err_solve,
                plain_solve_of_step=err_plain,
                errors=errs, ms=timer.device_ms(head, reps),
                host_us=timer.host_us(head, reps),
                solve_ms=timer.device_ms(lambda: comp_step.solve(
                    jj, jr, w2, d.contiguous(), lam, edges), reps),
                plain_ms=timer.device_ms(lambda: comp.lm_step_ref(
                    comp.LmState(**{**st.__dict__}), comp_step.HEAD, p, q, **tv), 10),
                bound_ms=b_ms, bound_by=by, bound_flops=n_flops, bound_bytes=n_bytes,
                library_ms=timer.device_ms(library, 20))


def _differ(a: dict, b: dict) -> list:
    """The names whose tensors differ between a and b (NaN equal to NaN)."""
    return [k for k, v in a.items()
            if not torch.equal(torch.nan_to_num(v), torch.nan_to_num(b[k]))
            or not torch.equal(torch.isnan(v), torch.isnan(b[k]))]


def _split(stages, clocks) -> dict:
    """Cycles by stage: the mean over the rows and the longest row's (which
    sets the launch's time)."""
    c = clocks.double().cpu()
    longest = int(c[:, -1].argmax())
    return dict(stages=list(stages), mean_cycles=[round(float(v), 1) for v in c.mean(0)],
                longest_row_cycles=[int(v) for v in c[longest]])


def clock_comp_tile(timer, dev, nw: int, e: int, loss: str = "edge", reps: int = 200,
                    tile: int = 20) -> dict:
    """Kernel A's clock build (`TileLaunch(..., clocks=)`) on `check_comp_tile`'s
    rows: every output the plain build's bits, each row's stage cycles adding
    up to its total (raises otherwise). Returns its device ms over `reps`
    launches (`clock_build_ms`) and the split of one more launch over the
    rows that took the loss (`clock`)."""
    from evo_tpu_torch.kernels import comp_tile
    from evo_tpu_torch.tracker import compensate as comp

    vel, data = tile_rows(dev, nw, e, tile)
    rows = vel.shape[0]
    kw = dict(tile=tile, scale=1e-3, loss=loss, weight=comp.GAUSS_NORM,
              sigma=comp.SIGMA_SPLAT, radius=comp.SPLAT_RADIUS, blur=comp.blur_taps())
    outs = []
    for clocked in (False, True):
        o = dict(r=torch.empty(rows, device=dev), J=torch.empty((rows, 2), device=dev),
                 escaped=torch.empty(rows, dtype=torch.bool, device=dev),
                 score=torch.empty(rows, device=dev))
        clocks = (torch.zeros((rows, len(comp_tile.STAGES)), dtype=torch.int64, device=dev)
                  if clocked else None)
        launch = comp_tile.TileLaunch(vel, _events(data), **kw, **o, clocks=clocks).launch
        launch()
        outs.append((o, clocks, launch))
    torch.cuda.synchronize()
    (plain, _, _), (clocked, clocks, launch) = outs
    differ = _differ({k: v.float() for k, v in plain.items()},
                   {k: v.float() for k, v in clocked.items()})
    ran = (data.active & ~clocked["escaped"]).cpu()
    c = clocks.cpu()
    if differ or not torch.equal(c[:, :-1].sum(1), c[:, -1]) or not (c[:, -1] > 0).all():
        raise AssertionError(f"comp_tile's clock build [{rows}, {e}] {tile} px {loss}: outputs "
                             f"{differ} differ, or its stages do not add up: {c[:4].tolist()}")
    ms = timer.device_ms(launch, reps)
    launch()
    torch.cuda.synchronize()
    return dict(clock_build_ms=ms, clock=_split(comp_tile.STAGES, clocks[ran.to(dev)]))


def clock_comp_step(timer, dev, nw: int, tile: int = 20, reps: int = 200) -> dict:
    """Kernel B's clock build (`LmLoop(..., clocks=True)`) against its plain
    build on `check_comp_step`'s first system: INIT | HEAD, then HEAD, each
    state the plain build's bits, each window's stages adding up to its
    total (raises otherwise). Returns its device ms over `reps` HEAD
    launches (`clock_build_ms`) and the split of one more (`clock`)."""
    from evo_tpu_torch.kernels import comp_step
    from evo_tpu_torch.tracker import compensate as comp

    tx, ty = 240 // tile, 180 // tile
    t = tx * ty
    vel, data = tile_rows(dev, nw, 1024, tile, seed=5)
    edges = comp.grid_edges(ty, tx, dev)
    r, J = comp.tile_residual_and_jacobian(vel, data, tile, 1e-3)
    loops = []
    for clocked in (False, True):
        loop = comp_step.LmLoop(nw, edges, tv_weight=1e3, tv_huber=10.0, clocks=clocked)
        loop.v.copy_(vel.reshape(nw, t, 2))
        loop.r.copy_(r.reshape(nw, t))
        loop.J.copy_(J.reshape(nw, t, 2))
        loop.step(comp_step.INIT | comp_step.HEAD)
        loop.step(comp_step.HEAD)
        loops.append(loop)
    torch.cuda.synchronize()
    # every part of the state the kernel writes (r_new and J_new are kernel A's)
    names = [n for n, _ in comp_step.FLOAT_STATE if n not in ("r_new", "J_new")] \
        + list(comp_step.INT_STATE)
    differ = _differ(*({n: getattr(lp, n).float() for n in names} for lp in loops))
    c = loops[1].clocks.cpu()
    if differ or not torch.equal(c[:, :-1].sum(1), c[:, -1]) or not (c[:, -1] > 0).all():
        raise AssertionError(f"comp_step's clock build, {nw} x {t} tiles: state {differ} "
                             f"differs, or its stages do not add up: {c.tolist()}")
    head = lambda: loops[1].step(comp_step.HEAD)  # noqa: E731
    ms = timer.device_ms(head, reps)
    head()
    torch.cuda.synchronize()
    return dict(clock_build_ms=ms, clock=_split(comp_step.STAGES, loops[1].clocks))


def time_kernels(timer, dev, reps: int = 200) -> list[dict]:
    """Both kernels of this tree at `TILE_SHAPES` and `STEP_SHAPES`: each
    `check_comp_tile` / `check_comp_step` row, with the clock build's split
    where the tree has one."""
    from evo_tpu_torch.kernels import comp_step, comp_tile

    rows = []
    for nw, e, loss, tile in TILE_SHAPES:
        row = check_comp_tile(timer, dev, nw, e, loss, reps, tile)
        if hasattr(comp_tile, "STAGES"):
            row.update(clock_comp_tile(timer, dev, nw, e, loss, reps, tile))
        rows.append(row)
    for nw, tile in STEP_SHAPES:
        row = check_comp_step(timer, dev, nw, tile, reps)
        if hasattr(comp_step, "STAGES"):
            row.update(clock_comp_step(timer, dev, nw, tile, reps))
        rows.append(row)
    return rows


def simulate(dev):
    from evo_tpu_torch.io import sim

    return sim.to_dataset(sim.EventCameraSimulator(sim.SimParams(**SCENE), device=dev).generate())


def run_mode(dataset, mode: str) -> dict:
    """One evaluator run of `mode` (tracker, sync, default) after a warm-up
    run of three frames: wall and stage seconds, windows, what the tree
    counts of compensation's and VO's launches and compensation's host
    reads, and, in the standard mode, VO's seconds by geometric stage."""
    from evo_tpu_torch.kernels import splat
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.tracker import compensate

    params = dict(tracker=dict(tracker_experiment=True), sync=dict(pipelined=False),
                  default={})[mode]
    with tempfile.TemporaryDirectory() as tmp:
        Evaluator(dataset, EvaluatorParams(**params, output_dir=tmp)).run(max_frames=3)
    counters = [splat]
    for name in ("comp_tile", "comp_step", "localize", "ba_solve"):
        try:
            counters.append(__import__(f"evo_tpu_torch.kernels.{name}", fromlist=[name]))
        except ImportError:
            pass
    if hasattr(compensate, "reset_counts"):
        counters.append(compensate)
    with tempfile.TemporaryDirectory() as tmp:
        ev = Evaluator(dataset, EvaluatorParams(**params, output_dir=tmp))
        for c in counters:
            c.reset_counts()
        t0 = time.perf_counter()
        ev.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ev.finish()
    counts = {}
    for c in counters:
        counts.update({k: v for k, v in vars(c).items()
                       if isinstance(v, int) and (k.startswith("launches") or k in (
                           "host_reads",))})
    c = ev.counters.counts
    windows = int(c["compensation_windows"])
    out = dict(mode=mode, wall_s=wall, rt_multiple=c["frames"] / SCENE["fps"] / wall,
               stage_s=dict(ev.counters.times), compensation_windows=windows, counts=counts)
    vo = getattr(ev, "vo", None)
    if vo is not None and mode != "tracker":  # VO's stages, and its solves where counted
        out["vo_stage_s"] = dict(vo.stage_s)
        out["vo_stage_calls"] = dict(getattr(vo, "stage_calls", {}))
        out["ba_iterations"] = int(sum(it for it, *_ in vo.ba_log))
    if "host_reads" in counts and windows:
        out["host_reads_per_window"] = counts["host_reads"] / windows
    return out


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="directory that holds the evo_tpu_torch package to time")
    ap.add_argument("--modes", nargs="+", default=["tracker", "sync", "default"],
                    choices=["tracker", "sync", "default"])
    ap.add_argument("--kernels", action="store_true",
                    help="time the two kernels at phase 3's shapes instead of the modes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_comp: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import evo_tpu_torch

    from evo_tpu_torch.run.time_splat import card

    label = card()
    root = os.path.dirname(os.path.dirname(evo_tpu_torch.__file__))
    if args.kernels:
        from evo_tpu_torch.run.time_align import split_text
        from evo_tpu_torch.run.time_splat import Timer

        dev = torch.device("cuda")
        for row in time_kernels(Timer(dev), dev):
            lib = row["library_ms"]
            print(f"time_comp {root}: kernel {row['kernel']} {row['shape']}: device "
                  f"{row['ms'] * 1e3:.2f} us  host {row['host_us']:.2f} us  bound "
                  f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']})  library "
                  f"{'none' if lib is None else f'{lib * 1e3:.2f} us'} ({label})", flush=True)
            if "clock" in row:
                print(f"time_comp {root}: clock split {row['kernel']} {row['shape']} (build "
                      f"{row['clock_build_ms'] * 1e3:.2f} us; cycles, mean | longest row): "
                      f"{split_text(row['clock'])}", flush=True)
            print("time_comp_kernel " + json.dumps(dict(row, root=root, card=label),
                                                   default=str), flush=True)
        from evo_tpu_torch.kernels import nvcc

        for name, log in sorted(nvcc.build_logs.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"time_comp {root}: ptxas ({name}): {line.strip()}", flush=True)
        return 0
    dataset = simulate(torch.device("cuda"))
    for mode in args.modes:
        row = run_mode(dataset, mode)
        row.update(root=root, card=label)
        print("time_comp " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
