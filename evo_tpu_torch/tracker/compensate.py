"""Motion compensation by per-tile contrast (edge) maximization + TV.

Counterpart of `evo_tpu/tracker/compensate.py`:

- the sensor plane is cut into 20x20 px tiles (12x9 on DAVIS240C);
- each tile with more than `min_events` events gets a translational
  velocity that warps its events to the window's mid-time; the events are
  splatted as 7x7 Gaussians (σ=1, 1/(2πσ²) weight) into a 3x-padded tile
  image, scored by the edge loss maxRes − Σ NMS₅ₓ₅(λ₁(structure tensor))/maxRes,
  with an escape penalty maxRes·(1+‖v‖²) when the events leave the tile;
- neighbouring tiles are coupled by TV residuals w·|vp − vq| under
  Huber(10), w = 1e3;
- the solved field warps every event into the count image (nearest splat).

The LM solves the per-tile velocities; each tile residual depends only on
its own velocity, so the Jacobian is block-diagonal ([T, 2]) and the damped
2T x 2T normal system is banded (the TV edges join tiles at most a grid row
apart). `solve_motion_field_batched` solves W windows at once, each window
frozen once it stops; the one-window solve is its case W = 1.

- On the card the LM is a device-side loop (`lm_motion_field_on_card`): per
  trip one launch of kernel A (`kernels.comp_tile`: warp, splat and loss of
  every tile row with the Jacobian in forward mode, as the JAX package's
  jacfwd) and one of kernel B (`kernels.comp_step`: the trip's accept and
  the next trip's banded solve, a block a window); the host reads the stop
  flag every `READS_EVERY` trips.
- On the CPU the same loop runs from the host (`lm_motion_field`) on the
  plain versions: `tile_residual_and_jacobian_ref` (the fused splat's plain
  version and one reverse-mode pass over Σ_t r_t), `tile_system_ref` (one
  batched Cholesky) and `lm_head` / `lm_tail`; `lm_step_ref` is kernel B's
  loop entry in plain PyTorch.
- With a mesh, `compensate_window` solves the tile columns space-sharded
  (`dist.tiling`) through `lm_motion_field` with collective hooks; on the
  card its residuals are kernel A's and its root's solve kernel B's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.core.transfer import HostCopy
from evo_tpu_torch.kernels import comp_step, comp_tile
from evo_tpu_torch.kernels.splat import splat_image, warp_splat
from evo_tpu_torch.solve.lm import huber_weights

MAX_RES = 1e3
SIGMA_SPLAT = 1.0
SPLAT_RADIUS = 3
SIGMA_ST = 1.5
K_ST = 3
K_NMS = 2
GAUSS_NORM = 1.0 / (2.0 * np.pi * SIGMA_SPLAT * SIGMA_SPLAT)
# LM trips the host queues on the card between two reads of the stop flag
# (a window takes ~14 trips: ~4 reads, at most 3 trips queued past the stop)
READS_EVERY = 4


@dataclasses.dataclass(frozen=True)
class CompensateParams:
    tile: int = 20
    tv_weight: float = 1e3
    tv_huber: float = 10.0
    scale: float = 1e-3  # µs -> ms time scaling of velocities
    min_events: int = 100
    max_iters: int = 50
    events_per_tile_cap: int = 4096
    loss: str = "edge"  # 'edge' | 'variance'


@dataclasses.dataclass
class TileData:
    """Per-tile padded event arrays: ex, ey, dt_us (t_mid − t_event),
    valid [T, E]; tile origins tlx, tly and the active mask [T]."""

    ex: torch.Tensor
    ey: torch.Tensor
    dt_us: torch.Tensor
    valid: torch.Tensor
    tlx: torch.Tensor
    tly: torch.Tensor
    active: torch.Tensor

    def map(self, fn) -> "TileData":
        """The same fields, each passed through `fn`."""
        return TileData(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


def _band_blur_matrix(size: int, sigma: float, radius: int, device):
    """[size, size] banded Toeplitz matrix of a truncated 1-D Gaussian."""
    i = torch.arange(size, dtype=torch.float32, device=device)
    d = i[:, None] - i[None, :]
    g = torch.exp(-0.5 * (d / sigma) ** 2) * (1.0 / math.sqrt(2.0 * math.pi * sigma * sigma))
    return torch.where(d.abs() <= radius, g, torch.zeros((), device=device))


def tile_edge_loss(img):
    """Σ NMS(λ₁(structure tensor)) of padded tile images img [T, 3H, 3W]
    -> [T]."""
    h3, w3 = img.shape[-2:]
    gx = F.pad(img[:, : h3 - 1, 1:w3] - img[:, : h3 - 1, : w3 - 1], (0, 1, 0, 1))
    gy = F.pad(img[:, 1:h3, : w3 - 1] - img[:, : h3 - 1, : w3 - 1], (0, 1, 0, 1))
    by = _band_blur_matrix(h3, SIGMA_ST, K_ST, img.device)
    bx = _band_blur_matrix(w3, SIGMA_ST, K_ST, img.device)

    def blur(a):
        return by @ a @ bx.T

    sxx = blur(gx * gx)
    sxy = blur(gx * gy)
    syy = blur(gy * gy)
    tr = sxx + syy
    # clamp before sqrt so the derivative is 0, not NaN, on empty regions
    disc2 = (sxx - syy) ** 2 + 4.0 * sxy * sxy
    disc = torch.sqrt(disc2.clamp_min(1e-12))
    lam1 = (0.5 * (tr + disc)).clamp_min(0.0)
    nms = F.max_pool2d(lam1[:, None], 2 * K_NMS + 1, stride=K_NMS)[:, 0]
    return nms.clamp_min(0.0).sum((1, 2))


def tile_variance_loss(img):
    """Variance of the positive pixels of tile images img [T, 3H, 3W] -> [T],
    the counter seeded at 1."""
    pos = img > 0.0
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    cnt = pos.sum((1, 2)).to(img.dtype) + 1.0
    mean = torch.where(pos, img, zero).sum((1, 2)) / cnt
    var = torch.where(pos, (img - mean[:, None, None]) ** 2, zero).sum((1, 2)) / cnt
    return torch.where(mean > 0.0, var, zero)


def tile_residual_ref(vel, data: TileData, tile: int, scale: float, loss: str = "edge",
                      splat=warp_splat):
    """Plain version: the contrast residual of every tile, vel [T, 2] -> r [T],
    differentiable with respect to vel. `splat` is `kernels.splat.warp_splat`
    (its plain version on the CPU, its kernels on the card) or
    `warp_splat_ref`."""
    img = splat(vel, data.ex, data.ey, data.dt_us, data.valid, data.tlx, data.tly,
                scale=scale, tile=tile, weight=GAUSS_NORM, sigma=SIGMA_SPLAT,
                radius=SPLAT_RADIUS)
    escaped = img.mean((1, 2)) <= 1e-4
    if loss == "edge":
        score = tile_edge_loss(img) / MAX_RES
    elif loss == "variance":
        score = tile_variance_loss(img)
    else:
        raise ValueError(loss)
    r_escape = MAX_RES * (1.0 + vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1])
    r = torch.where(escaped, r_escape, MAX_RES - score)
    return torch.where(data.active, r, torch.zeros_like(r))


def tile_residual_and_jacobian_ref(vel, data: TileData, tile: int, scale: float,
                                   loss: str = "edge", splat=warp_splat):
    """Plain version of kernel A (`kernels.comp_tile`): (r [T], J [T, 2]) with
    J[t] = ∂r_t/∂v_t, from one backward pass of autograd (`splat` as for
    `tile_residual_ref`)."""
    v = vel.detach().requires_grad_(True)
    with torch.enable_grad():
        r = tile_residual_ref(v, data, tile, scale, loss, splat)
        (jac,) = torch.autograd.grad(r.sum(), v)
    return r.detach(), jac


# Reads of the LM's stop flag by the host, since the last reset.
host_reads = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global host_reads
    with _count_lock:
        host_reads = 0


def _count_read() -> None:
    global host_reads
    with _count_lock:
        host_reads += 1


@functools.cache
def blur_taps() -> tuple:
    """The structure tensor's blur taps at distance 0..3: a row of
    `_band_blur_matrix`, as the plain version builds it."""
    return tuple(float(g) for g in _band_blur_matrix(2 * K_ST + 1, SIGMA_ST, K_ST, "cpu")
                 [K_ST, K_ST:])


def _tile_launch(vel, data: TileData, tile: int, scale: float, loss: str, r, J, **kw):
    return comp_tile.TileLaunch(
        vel, {f.name: getattr(data, f.name) for f in dataclasses.fields(data)}, tile=tile,
        scale=scale, loss=loss, weight=GAUSS_NORM, sigma=SIGMA_SPLAT, radius=SPLAT_RADIUS,
        blur=blur_taps(), r=r, J=J, **kw)


def tile_residual_and_jacobian(vel, data: TileData, tile: int, scale: float,
                               loss: str = "edge"):
    """(r [T], J [T, 2]) with J[t] = ∂r_t/∂v_t: kernel A on the card, the
    plain version (autograd) on the CPU."""
    if vel.device.type == "cpu":
        return tile_residual_and_jacobian_ref(vel, data, tile, scale, loss)
    rows = vel.shape[0]
    r = torch.empty(rows, dtype=torch.float32, device=vel.device)
    J = torch.empty((rows, 2), dtype=torch.float32, device=vel.device)
    _tile_launch(vel.contiguous(), data, tile, scale, loss, r, J).launch()
    return r, J


def tile_residual(vel, data: TileData, tile: int, scale: float, loss: str = "edge"):
    """Contrast residual of every tile: vel [T, 2] -> r [T]; kernel A's r on
    the card, the plain version on the CPU."""
    if vel.device.type == "cpu":
        return tile_residual_ref(vel, data, tile, scale, loss)
    return tile_residual_and_jacobian(vel, data, tile, scale, loss)[0]


def _edges(ty: int, tx: int):
    """Horizontal + vertical neighbour index pairs over a ty x tx grid."""
    ids = np.arange(ty * tx).reshape(ty, tx)
    h = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    v = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    return np.concatenate([h, v], axis=0)


# The grids' edges, one `kernels.comp_step.Edges` per (ty, tx, device): every
# window of a grid shares them, and the kernels' incidence of the edges is
# built once. The compensation worker and the main thread both build tiles.
_grids: dict = {}
_grids_lock = threading.Lock()


def grid_edges(ty: int, tx: int, device) -> comp_step.Edges:
    """The TV edges of a ty x tx grid on `device` (horizontal, then
    vertical neighbours, row-major)."""
    key = (ty, tx, str(device))
    with _grids_lock:
        if key not in _grids:
            e = _edges(ty, tx)
            _grids[key] = comp_step.Edges(e[:, 0], e[:, 1], ty * tx, device)
        return _grids[key]


def solve_motion_field(tile_data: TileData, edges: comp_step.Edges, *, tile: int,
                       scale: float, tv_weight: float, tv_huber: float,
                       max_iters: int, loss: str = "edge", v_init=None):
    """Block-structured LM over per-tile velocities [T, 2]: the solve of
    `solve_motion_field_batched` for one window.

    edges: the grid's TV edges (`grid_edges`); v_init: optional [T, 2] warm
    start (the previous window's field), ignored when not finite. Returns
    (v [T, 2], cost, cost0) as tensors."""
    one = tile_data.map(lambda a: a[None])
    vi = None
    if v_init is not None:
        vi = torch.as_tensor(v_init, dtype=torch.float32,
                             device=tile_data.ex.device).reshape(1, -1, 2)
    v, cost, cost0 = solve_motion_field_batched(
        one, edges, tile=tile, scale=scale, tv_weight=tv_weight,
        tv_huber=tv_huber, max_iters=max_iters, loss=loss, v_init=vi)
    return v[0], cost[0], cost0[0]


def tv_rho(d, tv_weight: float, tv_huber: float):
    """Huber cost of the TV residuals w·|d| of edge differences d [..., E, 2]
    -> [..., E]."""
    s = ((tv_weight * d.abs()) ** 2).sum(-1)
    n = torch.sqrt(s + 1e-12)
    return torch.where(n <= tv_huber, s, 2.0 * tv_huber * n - tv_huber ** 2)


def lane_sum(x):
    """The sum over the last axis of x [..., N] in kernel B's order (a warp's
    32 lanes each summing the entries l, l + 32, ... in turn, then a xor
    butterfly over the lanes), so that a loop driven from the host sums a
    window's cost as the device-side loop does."""
    n = x.shape[-1]
    x = F.pad(x, (0, (-n) % 32)).reshape(*x.shape[:-1], -1, 32)
    acc = torch.zeros_like(x[..., 0, :])
    for k in range(x.shape[-2]):
        acc = acc + x[..., k, :]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def tile_system_ref(nw: int, T: int, p, q):
    """Plain version of kernel B's solve (`kernels.comp_step.solve`): the
    damped solve of W block-structured 2T x 2T normal systems over the TV
    edges (p, q) [E] long, with its scatter indices built once.

    Returns solve(jj, jr, w2, d, lam) -> (delta [W, T, 2], ok [W]): from the
    per-tile Gauss-Newton blocks jj [W, T, 2, 2] and gradients jr [W, T, 2],
    the per-edge IRLS weights w2 [W, E] and differences d [W, E, 2], it
    assembles A and b (GN of w|δ| is the weighted quadratic with Jᵀr = w²δ),
    damps the diagonal by lam [W] and solves by one batched Cholesky; ok is
    False for a window whose factorisation failed. `solve.assemble` gives
    the damped A [W, 2T, 2T] and b [W, 2T] alone."""
    dev = p.device
    t2 = 2 * torch.arange(T, device=dev)
    blk_r = (t2[:, None, None] + torch.arange(2, device=dev)[None, :, None]).expand(T, 2, 2)
    blk_c = (t2[:, None, None] + torch.arange(2, device=dev)[None, None, :]).expand(T, 2, 2)
    tv_rows, tv_cols, tv_sign, b_rows, b_sign, b_comp = [], [], [], [], [], []
    for c in range(2):
        tv_rows += [2 * p + c, 2 * q + c, 2 * p + c, 2 * q + c]
        tv_cols += [2 * p + c, 2 * q + c, 2 * q + c, 2 * p + c]
        tv_sign += [1.0, 1.0, -1.0, -1.0]
        b_rows += [2 * p + c, 2 * q + c]
        b_sign += [1.0, -1.0]
        b_comp += [c, c]
    win = torch.arange(nw, device=dev)[:, None]
    blk = tuple(a.reshape(-1) for a in torch.broadcast_tensors(
        win, blk_r.reshape(1, -1), blk_c.reshape(1, -1)))
    tv = tuple(a.reshape(-1) for a in torch.broadcast_tensors(
        win, torch.cat(tv_rows)[None], torch.cat(tv_cols)[None]))
    bi = tuple(a.reshape(-1) for a in torch.broadcast_tensors(win, torch.cat(b_rows)[None]))

    def assemble(jj, jr, w2, d, lam):
        A = torch.zeros((nw, 2 * T, 2 * T), dtype=jj.dtype, device=dev)
        A.index_put_(blk, jj.reshape(-1), accumulate=True)
        b = jr.reshape(nw, 2 * T).clone()
        A.index_put_(tv, torch.cat([s * w2 for s in tv_sign], 1).reshape(-1), accumulate=True)
        b.index_put_(bi, torch.cat([s * w2 * d[..., c] for s, c in zip(b_sign, b_comp)],
                                   1).reshape(-1), accumulate=True)
        diag = torch.diagonal(A, dim1=-2, dim2=-1).clamp_min(1e-8)
        return A + lam[:, None, None] * torch.diag_embed(diag), b

    def solve(jj, jr, w2, d, lam):
        A, b = assemble(jj, jr, w2, d, lam)
        L, info = torch.linalg.cholesky_ex(A)
        delta = -torch.cholesky_solve(b[..., None], L)[..., 0]
        return delta.reshape(nw, T, 2), info == 0

    solve.assemble = assemble
    return solve


def tile_system(nw: int, edges: comp_step.Edges):
    """`tile_system_ref`'s solve over `edges` on the CPU; on the card, kernel
    B's solve entry (`kernels.comp_step.solve`)."""
    if edges.p.device.type == "cpu":
        return tile_system_ref(nw, edges.t, edges.p, edges.q)

    def solve(jj, jr, w2, d, lam):
        return comp_step.solve(jj.contiguous(), jr.contiguous(), w2.contiguous(),
                               d.contiguous(), lam.contiguous(), edges)

    return solve


@dataclasses.dataclass
class LmState:
    """The plain LM's state of W windows: the accepted velocities v [W, T,
    2] with their residuals r [W, T], Jacobians J [W, T, 2] and TV edge
    differences d [W, E, 2]; damping, cost, cost0 [W]; active [W] bool;
    iters [W] (trips run while active); and the candidate v_new [W, T, 2]
    with bad [W] (its step failed)."""

    v: torch.Tensor
    r: torch.Tensor
    J: torch.Tensor
    d: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    cost0: torch.Tensor
    active: torch.Tensor
    iters: torch.Tensor
    v_new: torch.Tensor | None = None
    bad: torch.Tensor | None = None


def lm_head(st: LmState, solve, tv_weight: float, tv_huber: float) -> None:
    """The head of an LM trip: the IRLS weights of the TV edges, the damped
    solve at v, and the candidate v_new (v where the step failed: not ok or
    not finite)."""
    w2 = huber_weights(((tv_weight * st.d.abs()) ** 2).sum(-1), tv_huber) \
        * tv_weight * tv_weight
    J, r = st.J, st.r
    delta, ok = solve(J[..., :, None] * J[..., None, :], J * r[..., None], w2, st.d, st.lam)
    bad = ~ok | ~torch.isfinite(delta).all(-1).all(-1)
    delta = torch.where(bad[:, None, None], torch.zeros_like(delta), delta)
    st.v_new, st.bad = st.v + delta, bad


def lm_tail(st: LmState, r_new, J_new, d_new, cost_new) -> None:
    """The tail of an LM trip: accept the candidate where its cost is finite
    and lower and its step did not fail; halve or quadruple the damping
    (within [1e-9, 1e6]); a window stops on a relative decrease below 1e-6 or
    a damping past 1e5, and from then on keeps its state."""
    active = st.active
    accept = active & torch.isfinite(cost_new) & (cost_new < st.cost) & ~st.bad
    rel = (st.cost - cost_new) / st.cost.clamp_min(1e-12)
    done = (accept & (rel < 1e-6)) | (st.lam > 1e5)
    st.v = torch.where(accept[:, None, None], st.v_new, st.v)
    st.r = torch.where(accept[:, None], r_new, st.r)
    st.J = torch.where(accept[:, None, None], J_new, st.J)
    st.d = torch.where(accept[:, None, None], d_new, st.d)
    st.lam = torch.where(active, torch.where(accept, st.lam * 0.5, st.lam * 4.0)
                         .clamp(1e-9, 1e6), st.lam)
    st.cost = torch.where(accept, cost_new, st.cost)
    st.iters = st.iters + active.to(st.iters.dtype)
    st.active = active & ~done


def lm_motion_field(v, data: TileData, *, tile: int, scale: float, tv_weight: float,
                    tv_huber: float, max_iters: int, loss: str, edge_diffs, solve,
                    reduce=None) -> LmState:
    """The LM loop of W windows' tile velocities v [W, T, 2] from their start,
    T the tiles this caller holds (`data` [W·T, E] rows), driven from the
    host: the CPU's loop, and the space-sharded solve's on any device.

    Hooks, so that the one-device and the space-sharded solves
    (`dist.tiling.sharded_tile_solve_data`) share it: edge_diffs(v) -> the
    differences [W, E, 2] of the TV edges this caller owns; solve(jj, jr, w2,
    d, lam) -> (delta [W, T, 2], ok [W]) from this caller's normal-equation
    pieces (`tile_system`); reduce(c) -> the cost [W] of the whole field from
    this caller's part (None: it is the whole). On the card a window's cost
    is summed in kernel B's order (`lane_sum`). A window stops after
    `max_iters`, on a relative cost decrease below 1e-6, or once its damping
    passes 1e5; from then on it keeps its velocities, damping and cost while
    the others go on, so each window sees the accepts it would see alone.

    Each trip evaluates the residuals and Jacobians once, at the candidate
    (`lm_tail` keeps them when it accepts), and the host reads the stop flag
    once every `READS_EVERY` trips: trips queued past a window's stop leave
    it as it is. Returns the final `LmState` (v, cost, cost0, iters)."""
    nw, T = v.shape[:2]
    lanes = v.device.type == "cuda"

    def residuals(v):
        r, J = tile_residual_and_jacobian(v.reshape(nw * T, 2), data, tile, scale, loss)
        return r.reshape(nw, T), J.reshape(nw, T, 2)

    def cost_of(r, d):
        if lanes:
            c = lane_sum(r * r) + lane_sum(tv_rho(d, tv_weight, tv_huber))
        else:
            c = (r * r).sum(-1) + tv_rho(d, tv_weight, tv_huber).sum(-1)
        return c if reduce is None else reduce(c)

    with torch.no_grad():
        r, J = residuals(v)
        d = edge_diffs(v)
        cost = cost_of(r, d)
        st = LmState(v=v, r=r, J=J, d=d, cost=cost, cost0=cost,
                     lam=torch.full((nw,), 1e-4, dtype=torch.float32, device=v.device),
                     active=torch.ones(nw, dtype=torch.bool, device=v.device),
                     iters=torch.zeros(nw, dtype=torch.int32, device=v.device))
        for k in range(max_iters):
            lm_head(st, solve, tv_weight, tv_huber)
            r_new, J_new = residuals(st.v_new)
            d_new = edge_diffs(st.v_new)
            lm_tail(st, r_new, J_new, d_new, cost_of(r_new, d_new))
            if k + 1 < max_iters and (k + 1) % READS_EVERY == 0:
                _count_read()
                if not bool(st.active.any()):
                    break
    return st


def lm_step_ref(st: LmState, mode: int, p, q, *, r_new=None, J_new=None,
                tv_weight: float, tv_huber: float) -> None:
    """Plain version of one launch of kernel B's loop entry
    (`kernels.comp_step.LmLoop.step`) on the unmeshed state `st`: mode
    `INIT` (st.cost, cost0 from st.r and st.v, st.d set), or `TAIL` with the
    residuals r_new, J_new at st.v_new; `| HEAD` then makes the next
    candidate. Windows that have stopped keep their state."""
    from evo_tpu_torch.kernels.comp_step import HEAD, INIT, TAIL

    nw, T = st.v.shape[:2]
    if mode & INIT:
        st.d = st.v[:, p] - st.v[:, q]
        st.cost = st.cost0 = (st.r * st.r).sum(-1) + tv_rho(st.d, tv_weight, tv_huber).sum(-1)
    if mode & TAIL:
        d_new = st.v_new[:, p] - st.v_new[:, q]
        cost_new = (r_new * r_new).sum(-1) + tv_rho(d_new, tv_weight, tv_huber).sum(-1)
        lm_tail(st, r_new, J_new, d_new, cost_new)
    if mode & HEAD:
        v_new, bad = st.v_new, st.bad
        lm_head(st, tile_system_ref(nw, T, p, q), tv_weight, tv_huber)
        if v_new is not None:  # a window that has stopped keeps its candidate
            keep = ~st.active
            st.v_new = torch.where(keep[:, None, None], v_new, st.v_new)
            st.bad = torch.where(keep, bad, st.bad)


def lm_motion_field_on_card(v, data: TileData, edges: comp_step.Edges, *, tile: int,
                            scale: float, tv_weight: float, tv_huber: float,
                            max_iters: int, loss: str):
    """The LM loop of W windows on the card as a device-side loop: per trip
    two launches, kernel B's step (the tail of the last trip and the head of
    this one) and kernel A at the candidate (only the windows still
    iterating); the state stays in `kernels.comp_step.LmLoop`'s arena. The
    host queues `READS_EVERY` trips between two reads of the stop flag; a
    window that has stopped ignores the trips queued past it, so the result
    is that of a read after every trip. Same arguments as `lm_motion_field`,
    with the grid's edges in place of the hooks; returns the `LmLoop` (v,
    cost, cost0, iters)."""
    from evo_tpu_torch.kernels.comp_step import HEAD, INIT, TAIL, LmLoop

    nw, T = v.shape[:2]
    loop = LmLoop(nw, edges, tv_weight, tv_huber)
    loop.v.copy_(v)
    at_v = _tile_launch(loop.v.view(nw * T, 2), data, tile, scale, loss,
                        loop.r.view(-1), loop.J.view(-1, 2)).launch
    at_new = _tile_launch(loop.v_new.view(nw * T, 2), data, tile, scale, loss,
                          loop.r_new.view(-1), loop.J_new.view(-1, 2), live=loop.active,
                          rows_per_window=T).launch
    with torch.no_grad():
        at_v()
        loop.step(INIT | (HEAD if max_iters > 0 else 0))
        for k in range(max_iters):
            at_new()
            loop.step(TAIL | (HEAD if k + 1 < max_iters else 0))
            if k + 1 < max_iters and (k + 1) % READS_EVERY == 0:
                _count_read()
                if not bool(loop.active.any()):
                    break
    return loop


def solve_motion_field_batched(tile_data: TileData, edges: comp_step.Edges, *, tile: int,
                               scale: float, tv_weight: float, tv_huber: float,
                               max_iters: int, loss: str = "edge", v_init=None):
    """The LM of W independent windows at once, the counterpart of
    `jax.vmap(solve_motion_field)` (`evo_tpu/dist/temporal.py`).

    tile_data: fields with a leading window axis, ex, ey, dt_us, valid
    [W, T, E] and tlx, tly, active [W, T]; edges: the grid's (`grid_edges`);
    v_init: optional [W, T, 2] warm start, a window's ignored when not finite
    (None: cold). On the card, the device-side loop `lm_motion_field_on_card`
    (kernels A and B, two launches a trip over all W windows); on the CPU,
    `lm_motion_field` with the plain versions. Returns (v [W, T, 2], cost
    [W], cost0 [W])."""
    dev = tile_data.ex.device
    nw, T = tile_data.ex.shape[:2]
    # the W·T tiles as one batch of rows
    flat = tile_data.map(lambda a: a.reshape((nw * T,) + a.shape[2:]))
    v = torch.zeros((nw, T, 2), dtype=torch.float32, device=dev)
    if v_init is not None:
        vi = torch.as_tensor(v_init, dtype=torch.float32, device=dev).reshape(nw, T, 2)
        finite = torch.isfinite(vi).all(-1).all(-1)
        v = v + torch.where(finite[:, None, None], vi, torch.zeros_like(vi))
    kw = dict(tile=tile, scale=scale, tv_weight=tv_weight, tv_huber=tv_huber,
              max_iters=max_iters, loss=loss)
    if dev.type == "cuda":
        st = lm_motion_field_on_card(v, flat, edges, **kw)
    else:
        st = lm_motion_field(v, flat, edge_diffs=lambda v: v[:, edges.p] - v[:, edges.q],
                             solve=tile_system(nw, edges), **kw)
    return st.v, st.cost, st.cost0


def build_tile_data(x: np.ndarray, y: np.ndarray, t_us: np.ndarray,
                    params: CompensateParams | None = None, height: int = 180,
                    width: int = 240, device=None):
    """Host-side tile bucketing: per-tile padded event arrays, with the
    per-tile capacity the smallest power of two >= 256 that holds the
    fullest tile, capped at `events_per_tile_cap`.

    Returns (TileData on `device` (None: the card when there is one), the
    grid's edges (`grid_edges`), ty, tx, tile id of each event [N] (numpy),
    t_mid)."""
    p = params or CompensateParams()
    device = resolve(device)
    tx_n = width // p.tile
    ty_n = height // p.tile
    T = tx_n * ty_n
    n = len(x)
    t_mid = 0.5 * (float(t_us[0]) + float(t_us[-1])) if n else 0.0

    tix = np.clip(x.astype(np.int64) // p.tile, 0, tx_n - 1)
    tiy = np.clip(y.astype(np.int64) // p.tile, 0, ty_n - 1)
    tid = tiy * tx_n + tix
    order = np.argsort(tid, kind="stable")
    counts = np.bincount(tid, minlength=T)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    need = int(counts.max()) if n else 1
    E = min(p.events_per_tile_cap, max(256, 1 << (need - 1).bit_length()))
    gather = np.zeros((T, E), np.int64)
    valid = np.zeros((T, E), bool)
    tid_sorted = tid[order]
    pos_in_tile = np.arange(n) - starts[tid_sorted]
    keep = pos_in_tile < E
    gather[tid_sorted[keep], pos_in_tile[keep]] = order[keep]
    valid[tid_sorted[keep], pos_in_tile[keep]] = True

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    data = TileData(
        ex=dev(x[gather].astype(np.float32)),
        ey=dev(y[gather].astype(np.float32)),
        dt_us=dev((t_mid - t_us[gather]).astype(np.float32)),
        valid=dev(valid),
        tlx=dev((np.arange(T) % tx_n * p.tile).astype(np.float32)),
        tly=dev((np.arange(T) // tx_n * p.tile).astype(np.float32)),
        active=dev(counts > p.min_events),
    )
    return data, grid_edges(ty_n, tx_n, device), ty_n, tx_n, tid, t_mid


def compensate_window(x: np.ndarray, y: np.ndarray, t_us: np.ndarray,
                      params: CompensateParams | None = None,
                      height: int = 180, width: int = 240, v_init=None,
                      device=None, defer: bool = False, mesh=None):
    """Compensate one window of host events on `device` (None: the card when
    there is one).

    Returns (motion_field [TY, TX, 2], compensated_image [H, W] of counts,
    solve_cost, initial_cost) on the host. With `defer=True` it returns a
    `DeferredWindow` instead, whose `get()` gives that tuple: the copy to the
    host is queued and nothing waits for it here. With `mesh` (a
    `dist.mesh.make_mesh` mesh; every rank calls with the same window) the
    tile columns are solved space-sharded (`dist.tiling.sharded_tile_solve_data`),
    with the one-device result up to summation order."""
    p = params or CompensateParams()
    device = resolve(device)
    data, edges, ty_n, tx_n, tid, t_mid = build_tile_data(
        x, y, t_us, p, height, width, device
    )
    kw = dict(tile=p.tile, scale=p.scale, tv_weight=p.tv_weight, tv_huber=p.tv_huber,
              max_iters=p.max_iters, loss=p.loss, v_init=v_init)
    if mesh is not None:
        from evo_tpu_torch.dist.tiling import sharded_tile_solve_data

        vel, cost, cost0 = sharded_tile_solve_data(mesh, data, ty=ty_n, tx=tx_n, **kw)
    else:
        vel, cost, cost0 = solve_motion_field(data, edges, **kw)
    img = compensated_count_splat(
        vel, torch.as_tensor(tid).to(device),
        torch.as_tensor(x.astype(np.float32)).to(device),
        torch.as_tensor(y.astype(np.float32)).to(device),
        torch.as_tensor((t_mid - t_us).astype(np.float32)).to(device),
        p.scale, height, width,
    )
    out = DeferredWindow(vel, HostCopy(dict(
        vel=vel.reshape(ty_n, tx_n, 2), img=img, cost=cost, cost0=cost0)))
    return out if defer else out.get()


class DeferredWindow:
    """A solved window whose result is on its way to the host. `vel_dev` is
    the solved field [T, 2] still on the device: the next window's warm start
    takes it from there."""

    def __init__(self, vel_dev, copy: HostCopy):
        self.vel_dev = vel_dev
        self._copy = copy

    def get(self):
        d = self._copy.get()
        return d["vel"], d["img"], float(d["cost"]), float(d["cost0"])


def compensated_count_splat(vel, tile_id, x, y, dt_us, scale: float,
                            height: int, width: int):
    """Nearest count splat of all events shifted by their tile's velocity."""
    v = vel[tile_id]
    shift = dt_us * scale
    cx = torch.round(x + shift * v[:, 0])
    cy = torch.round(y + shift * v[:, 1])
    return count_splat(cx, cy, height, width)


def count_splat(cx, cy, height: int, width: int):
    ones = torch.ones_like(cx)
    return splat_image(cx.contiguous(), cy.contiguous(), ones, height, width,
                       mode="nearest")
