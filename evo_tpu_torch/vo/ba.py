"""Sliding-window bundle adjustment with an explicit Schur complement —
counterpart of `evo_tpu/vo/ba.py`.

    residual_o = p2d_o − π(intr, T_w_c[f_o]⁻¹ · X[l_o])      (2 per obs)

with Huber(0.8) per observation block, the intrinsics constant, and the
first two active poses held fixed for gauge freedom. Observations are packed
into padded arrays [O] with a mask; the per-observation Jacobians are
analytic; the normal equations are assembled by scatter-adds into dense
per-frame and per-landmark blocks (`observation_sums`: summed in one order on
every device, so the card gives the same bits from run to run); the
landmark block is eliminated in closed form (batched 3x3 inverses), and the
reduced camera system ([6F, 6F], F <= 21) is solved densely by Cholesky.

`ba_solve` runs the whole solve as one launch of `kernels.ba_solve` (CUDA)
on the card, and `ba_solve_ref`, the plain version, on the CPU: there the LM
loop is a Python loop that reads one flag per iteration.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.kernels import ba_solve as kba
from evo_tpu_torch.solve.lm import huber_weights
from evo_tpu_torch.solve.precision import SegmentSum, compensated_scatter_add

HUBER = 0.8
MAX_ITERS = 50


def _reproj_residual(pose, lm, intr, p2d):
    """[..., 2] reprojection residual of poses [..., 7] and landmarks
    [..., 3] against pixels p2d [..., 2]."""
    p_cam = lie.se3_apply(lie.se3_inverse(pose), lm)
    return p2d - camera.project(intr, p_cam)


def _obs_linearize(pose, lm, intr, p2d):
    """Residual [O, 2] and its Jacobians in the pose tangent [O, 2, 6] and
    the landmark [O, 2, 3], analytic. With

      p_c(δ, d3) = (T·exp(δ))⁻¹ · (X + d3) = exp(−δ) · (R(q)ᵀ (X + d3 − t))

    at δ = 0: ∂p_c/∂δ = [−I₃ | [p_c]ₓ] (tangent order (v, ω)) and
    ∂p_c/∂d3 = R(q)ᵀ; the [2, 3] projection Jacobian is
    `camera.project_jacobian`."""
    Rt = lie.quat_to_matrix(pose[..., 0:4]).transpose(-1, -2)  # R_cw
    p_c = (Rt @ (lm - pose[..., 4:7])[..., None])[..., 0]
    r = p2d - camera.project(intr, p_c)
    Jpi = camera.project_jacobian(intr, p_c)
    # r = p2d − π(p_c), so J = −Jπ · ∂p_c/∂·
    Jp = torch.cat([Jpi, -Jpi @ lie.so3_hat(p_c)], dim=-1)
    Jl = -Jpi @ Rt
    return r, Jp, Jl


_order_consts: dict = {}
_order_lock = threading.Lock()


def _order_constants(F: int, L: int, compensated: bool, device):
    """`observation_orders`' constants for one shape, made once: the masked
    rows' slot of each sum [3, 1] and the slots' edges [3, L F + 2] (scaled
    by the key's range, L F, where the key is a pair)."""
    k = (F, L, compensated, device)
    with _order_lock:
        if k not in _order_consts:
            n = torch.tensor([[F], [L], [L * F]], device=device)
            scale = 1 if compensated else L * F
            edges = (torch.arange(L * F + 2, device=device) * scale).expand(3, -1).contiguous()
            _order_consts[k] = (n, edges)
        return _order_consts[k]


def observation_orders(obs_frame, obs_lm, F: int, L: int, compensated: bool = False,
                       obs_mask=None):
    """The orders in which the normal equations' three slot sums (by frame,
    by landmark, by (landmark, frame) pair) add observations obs_frame,
    obs_lm [O], as `SegmentSum`s: by slot and then by (landmark, frame)
    pair, which is the order the front end lists observations in, with the
    observations whose `obs_mask` is False (weight 0) left out (in one more
    slot past the last); with `compensated`, by slot and index over every
    row, the order of `compensated_scatter_add` within each of its chunks.

    Each equals `SegmentSum(idx, n, key=pair, keep=obs_mask)` (or
    `SegmentSum(idx, n)`) bit for bit, `order` and `starts`, in six PyTorch
    operations (four with `compensated`) and no host read: the three sums'
    keys slot L F + pair (or the slot) stacked into one [3, O] tensor, one
    stable sort of its rows (ties by index: SegmentSum's order), one batched
    `searchsorted` of the slots' edges for the starts; the rest are views."""
    if obs_frame.dtype != torch.int64:
        obs_frame = obs_frame.long()
    if obs_lm.dtype != torch.int64:
        obs_lm = obs_lm.long()
    n, edges = _order_constants(F, L, compensated, obs_frame.device)
    pair = torch.add(obs_frame, obs_lm, alpha=F)
    slots = torch.stack((obs_frame, obs_lm, pair))
    if compensated:
        keys = slots
    else:
        mask = obs_mask if obs_mask is None or obs_mask.dtype == torch.bool else obs_mask.bool()
        if mask is not None:
            slots = torch.where(mask, slots, n)
        keys = torch.add(pair, slots, alpha=L * F)
    keys, order = torch.sort(keys, dim=1, stable=True)
    starts = torch.searchsorted(keys, edges)
    return [SegmentSum.from_order(o, s[:m + 2], m)
            for o, s, m in zip(order.unbind(0), starts.unbind(0), (F, L, L * F))]


def observation_sums(obs_frame, obs_lm, F: int, L: int, compensated: bool = False,
                     obs_mask=None):
    """The three scatter-adds of the normal equations (by frame, by
    landmark, by (landmark, frame) pair) for observations obs_frame, obs_lm
    [O]: `observation_orders`' `SegmentSum`s, which are `index_add_`'s sums
    on the CPU and the same on every run on the card; with `compensated`
    the two-float chunked sums instead, over every row."""
    if compensated:
        pair = obs_lm.long() * F + obs_frame.long()
        return [functools.partial(compensated_scatter_add, i, n_out=n)
                for i, n in ((obs_frame.long(), F), (obs_lm.long(), L), (pair, L * F))]
    return observation_orders(obs_frame, obs_lm, F, L, False, obs_mask)


def normal_equations(poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, wmask,
                     pose_fixed, sums, huber: float = HUBER):
    """The normal-equation blocks (Hpp [F, 6, 6], Hll [L, 3, 3], A [L, F, 6,
    3], bp [F, 6], bl [L, 3]) of the observations obs_frame, obs_lm [O],
    obs_p2d [O, 2] at (poses [F, 7], landmarks [L, 3]): analytic Jacobians,
    Huber IRLS weights times wmask [O], the fixed poses' Jacobians zeroed,
    each block summed over the observations by `sums`
    (`observation_sums`)."""
    by_frame, by_lm, by_pair = sums
    r, Jp, Jl = _obs_linearize(poses[obs_frame], landmarks[obs_lm], intr, obs_p2d)
    # robust IRLS weight per 2-residual block
    w = huber_weights((r * r).sum(-1), huber) * wmask  # [O]
    Jp = torch.where(pose_fixed[obs_frame][:, None, None], torch.zeros_like(Jp), Jp)
    wr = r * w[:, None]
    wJp = Jp * w[:, None, None]
    wJl = Jl * w[:, None, None]
    F, L = poses.shape[0], landmarks.shape[0]
    return (by_frame(wJp.transpose(1, 2) @ Jp),  # [O, 6, 6] summed by frame
            by_lm(wJl.transpose(1, 2) @ Jl),
            # per-(landmark, frame) coupling blocks A[l, f] = Σ_o w JpᵀJl
            by_pair(wJp.transpose(1, 2) @ Jl).reshape(L, F, 6, 3),
            by_frame((Jp.transpose(1, 2) @ wr[..., None])[..., 0]),
            by_lm((Jl.transpose(1, 2) @ wr[..., None])[..., 0]))


def reduced_system(Hpp, Hll, A, bp, bl, lam, pin_pose, pin_lm):
    """The reduced camera system of the normal-equation blocks
    (`normal_equations`) damped by `lam` (Marquardt diagonal scaling) and
    pinned (`pin_pose` [F, 6, 6], `pin_lm` [L, 3, 3]: identity blocks that
    keep fixed poses and unobserved landmarks invertible): (S [6F, 6F],
    v [F, 6], Hll⁻¹ [L, 3, 3], the inverses' `inv_ex` info [L])."""
    F = Hpp.shape[0]
    frames = torch.arange(F, device=Hpp.device)
    dpp = torch.diagonal(Hpp, dim1=1, dim2=2).clamp_min(1e-8)
    dll = torch.diagonal(Hll, dim1=1, dim2=2).clamp_min(1e-8)
    Hpp = Hpp + lam * torch.diag_embed(dpp) + pin_pose
    Hll = Hll + lam * torch.diag_embed(dll) + pin_lm

    Hll_inv, inv_info = torch.linalg.inv_ex(Hll)  # [L, 3, 3]
    T = torch.einsum("lfij,ljk->lfik", A, Hll_inv)  # [L, F, 6, 3]
    # reduced camera system S = Hpp − Σ_l T_l A_lᵀ ; v = bp − Σ_l T_l bl_l
    S = -torch.einsum("lfij,lgkj->fgik", T, A)  # [F, F, 6, 6]
    S[frames, frames] += Hpp
    S = S.permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    v = bp - torch.einsum("lfij,lj->fi", T, bl)  # [F, 6]
    return S, v, Hll_inv, inv_info


def decide(cost, cost_new, tol: float):
    """The accept and stop tests of a trip from the current and the
    candidate costs, each a pair (float32, float64) of `ba_solve_ref`'s
    evaluation: accept if the float64 cost falls, stop if it falls by less
    than `tol` of itself. The float32 cost is good to ~1e-6 of itself only
    (each residual is a difference of pixel coordinates of ~100 px, good to
    ~1e-5 px), so tests within that of their thresholds would go either way
    in float32, and differently on the card and on the CPU. One float32 case
    is kept: a state whose float32 cost is zero, every observation
    reproduced exactly, is final, as in `evo_tpu` (nothing lowers a zero
    cost, so every step is rejected until the damping passes 1e6); the
    float64 cost would still see gains of the pixels' own rounding there.
    Returns (accept, stop, the relative decrease)."""
    (c32, c64), n64 = cost, cost_new[1]
    rel = (c64 - n64) / c64.clamp_min(1e-12)
    return torch.isfinite(n64) & (n64 < c64) & (c32 > 0), rel < tol, rel


def ba_solve(poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed, *,
             num_iters: int = MAX_ITERS, huber: float = HUBER, compensated: bool = False,
             tol: float = 1e-6):
    """Run the windowed BA (arguments and results as `ba_solve_ref`'s): on
    the card one launch of the CUDA kernel `kernels.ba_solve`, which sums in
    `observation_orders`' orders, its iteration count a 0-dim tensor; on
    the CPU `ba_solve_ref`."""
    if poses.device.type == "cuda":
        orders = observation_orders(obs_frame, obs_lm, poses.shape[0], landmarks.shape[0],
                                    compensated, obs_mask)
        return kba.ba_solve(poses, landmarks, intr, obs_frame.long(), obs_lm.long(), obs_p2d,
                            obs_mask.bool(), pose_fixed.bool(), orders, num_iters=num_iters,
                            huber=huber, compensated=compensated, tol=tol)
    return ba_solve_ref(poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed,
                        num_iters=num_iters, huber=huber, compensated=compensated, tol=tol)


def result_to_host(res) -> tuple:
    """`ba_solve`'s result on the host as numpy: (poses', landmarks', cost,
    cost0, iterations), the last three Python numbers. The kernel's result
    lies in one block of the card's memory (`kernels.ba_solve.BaResult`):
    one copy reads it all."""
    packed = getattr(res, "packed", None)
    if packed is None:
        poses, lms, cost, cost0, iters = res
        return (poses.cpu().numpy(), lms.cpu().numpy(), float(cost), float(cost0), int(iters))
    f, l = res[0].shape[0], res[1].shape[0]
    host = packed.cpu().numpy()
    return (host[:f * 7].reshape(f, 7), host[f * 7:f * 7 + l * 3].reshape(l, 3),
            float(host[-3]), float(host[-2]), int(host[-1:].view(np.int32)[0]))


def ba_solve_ref(
    poses,
    landmarks,
    intr,
    obs_frame,
    obs_lm,
    obs_p2d,
    obs_mask,
    pose_fixed,
    *,
    num_iters: int = MAX_ITERS,
    huber: float = HUBER,
    compensated: bool = False,
    tol: float = 1e-6,
    trace: list | None = None,
):
    """Run the windowed BA in plain PyTorch (the kernel's plain version).

    poses [F, 7] (T_w_c), landmarks [L, 3], intr [9] (constant),
    obs_frame / obs_lm [O] integer indices, obs_p2d [O, 2], obs_mask [O]
    bool, pose_fixed [F] bool (gauge: the first two active frames, and the
    padding frames).

    `compensated=True` assembles the normal-equation blocks with two-float
    chunked accumulation (`solve.precision`). The Huber cost is evaluated in
    float64 and in the poses' dtype (`decide` makes each accept and stop
    test on them); the float64 cost is returned, in the poses' dtype. With
    `trace` (a list), each trip appends its decision's numbers (the float64
    cost and candidate cost, accept, rel_decrease, lam) as floats: the
    tests read where a decision lay. `tol` is the function tolerance: an
    accepted step whose relative cost decrease falls below it ends the
    solve, as does a damping grown past 1e6.

    The scatter-adds sum in one order on every device (`observation_sums`),
    so the card's result is the same on every run.

    Returns (poses', landmarks', final_cost, initial_cost, iterations).
    """
    F = poses.shape[0]
    L = landmarks.shape[0]
    dtype, dev = poses.dtype, poses.device
    obs_frame = obs_frame.long()
    obs_lm = obs_lm.long()
    wmask = obs_mask.to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    def robust_cost(poses, landmarks, dt):
        r = _reproj_residual(poses.to(dt)[obs_frame], landmarks.to(dt)[obs_lm], intr.to(dt),
                             obs_p2d.to(dt))
        s = (r * r).sum(-1)
        n = torch.sqrt(s + 1e-12)
        rho = torch.where(n <= huber, s, 2.0 * huber * n - huber * huber)
        return (rho * wmask.to(dt)).sum()

    def costs(poses, landmarks):
        """The Huber cost in the poses' dtype and in float64."""
        return robust_cost(poses, landmarks, dtype), robust_cost(poses, landmarks, torch.float64)

    sums = observation_sums(obs_frame, obs_lm, F, L, compensated, obs_mask)
    # padding landmarks stay put
    lm_has_obs = sums[1](wmask[:, None])[:, 0] > 0
    pin_pose = pose_fixed.to(dtype)[:, None, None] * eye6
    pin_lm = (~lm_has_obs).to(dtype)[:, None, None] * eye3

    def step(poses, landmarks, lam, cost):
        Hpp, Hll, A, bp, bl = normal_equations(
            poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, wmask, pose_fixed, sums,
            huber)
        S, v, Hll_inv, inv_info = reduced_system(Hpp, Hll, A, bp, bl, lam, pin_pose, pin_lm)
        # a reduced system that is not positive definite makes the step bad
        Lc, chol_info = torch.linalg.cholesky_ex(S)
        dp = torch.cholesky_solve(-v.reshape(6 * F, 1), Lc).reshape(F, 6)
        bad = (chol_info != 0) | (inv_info != 0).any() | ~torch.isfinite(dp).all()
        dp = torch.where(bad, torch.zeros_like(dp), dp)
        # back-substitute landmarks: δl = −Hll⁻¹ (bl + Σ_f A_lfᵀ δp_f)
        Alp = torch.einsum("lfij,fi->lj", A, dp)  # [L, 3]
        dl = -(Hll_inv @ (bl + Alp)[..., None])[..., 0]
        dl = torch.where(bad | ~lm_has_obs[:, None], torch.zeros_like(dl), dl)

        poses_new = torch.where(pose_fixed[:, None], poses, lie.se3_retract(poses, dp))
        lms_new = landmarks + dl
        cost_new = costs(poses_new, lms_new)
        accept, stop, rel_decrease = decide(cost, cost_new, tol)
        accept = accept & ~bad
        done = (accept & stop) | (lam > 1e6)
        if trace is not None:
            trace.append(dict(cost=float(cost[1]), cost_new=float(cost_new[1]),
                              accept=bool(accept), rel_decrease=float(rel_decrease),
                              lam=float(lam)))
        poses = torch.where(accept, poses_new, poses)
        landmarks = torch.where(accept, lms_new, landmarks)
        lam = torch.where(accept, lam * 0.5, lam * 4.0).clamp(1e-10, 1e8)
        cost = tuple(torch.where(accept, n, c) for c, n in zip(cost, cost_new))
        return poses, landmarks, lam, cost, done

    cost0 = costs(poses, landmarks)
    cost = cost0
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    n_it = 0
    while n_it < num_iters:
        poses, landmarks, lam, cost, done = step(poses, landmarks, lam, cost)
        n_it += 1
        if bool(done):  # the loop's one host read per iteration
            break
    return poses, landmarks, cost[1].to(dtype), cost0[1].to(dtype), n_it
