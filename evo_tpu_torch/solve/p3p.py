"""Perspective-3-Point absolute pose solver (Grunert's method) — counterpart
of `evo_tpu/solve/p3p.py`, batched over a leading hypothesis dimension.

The quartic is solved on a fixed sign-change grid followed by bisection and
Newton polishing, and all four candidate poses come back with a validity
mask: RANSAC scores every candidate instead of disambiguating.

Math (Grunert 1841, coefficients per Haralick et al. 1994): given unit rays
j1, j2, j3 to world points P1, P2, P3, the distance ratio v = s3/s1
satisfies a quartic; back-substitution gives camera-frame points, and a
3-point triad alignment yields the pose.
"""

from __future__ import annotations

import torch

from evo_tpu_torch.core import lie

_N_GRID = 256
_V_MAX = 16.0
# 24 halvings shrink the widest bracket (~16) to ~1e-6; the Newton polish
# then reaches float32 resolution
_N_BISECT = 24
_N_NEWTON = 6


def quartic_grid(dtype, device):
    """The sign-change grid of the quartic's roots [_N_GRID] on (0, _V_MAX]:
    geometric-ish, denser near small ratios."""
    g = torch.linspace(0.0, 1.0, _N_GRID, dtype=dtype, device=device)
    return 1e-4 + (_V_MAX - 1e-4) * g * g


def _quartic_real_roots(coeffs):
    """Real positive roots of A4 v⁴ + A3 v³ + A2 v² + A1 v + A0 in
    (0, _V_MAX]; each coefficient [...]. Returns (roots [..., 4],
    valid [..., 4])."""
    A4, A3, A2, A1, A0 = (c[..., None] for c in coeffs)

    def f(v):
        return (((A4 * v + A3) * v + A2) * v + A1) * v + A0

    def fp(v):
        return ((4.0 * A4 * v + 3.0 * A3) * v + 2.0 * A2) * v + A1

    grid = quartic_grid(A4.dtype, A4.device)
    vals = f(grid)  # [..., N]
    sign_change = torch.signbit(vals[..., :-1]) != torch.signbit(vals[..., 1:])
    # the k-th bracket (smallest first) is where the running count of sign
    # changes first reaches k + 1; with no such bracket the index is 0, and
    # `have` is then whatever interval 0 says (as in the JAX package)
    rank = torch.cumsum(sign_change, dim=-1)
    idx = []
    for k in range(4):
        kth = sign_change & (rank == k + 1)
        first = torch.argmax(kth.to(torch.int32), dim=-1)
        idx.append(torch.where(kth.any(-1), first, torch.zeros_like(first)))
    idx = torch.stack(idx, dim=-1)  # [..., 4]
    have = torch.gather(sign_change, -1, idx)
    lo = grid[idx]
    hi = grid[idx + 1]

    for _ in range(_N_BISECT):
        mid = 0.5 * (lo + hi)
        same_side = torch.signbit(f(mid)) == torch.signbit(f(lo))
        lo = torch.where(same_side, mid, lo)
        hi = torch.where(same_side, hi, mid)
    root = 0.5 * (lo + hi)

    for _ in range(_N_NEWTON):
        d = fp(root)
        step = f(root) / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        r2 = root - step
        ok = (r2 > 0) & (r2 <= _V_MAX) & torch.isfinite(r2)
        root = torch.where(ok, r2, root)
    valid = have & (root > 0) & torch.isfinite(root)
    return root, valid


def _kabsch_3pt(p_world, p_cam):
    """Rigid T_c_w (p_cam = R p_world + t) from 3 exact correspondences by
    orthonormal-triad alignment; p [..., 3 points, 3]. Degenerate only for
    collinear points, where P3P itself is degenerate."""

    def triad(p):
        u1 = p[..., 1, :] - p[..., 0, :]
        u1 = u1 / torch.linalg.norm(u1, dim=-1, keepdim=True).clamp_min(1e-12)
        v = p[..., 2, :] - p[..., 0, :]
        v = v - (v * u1).sum(-1, keepdim=True) * u1
        u2 = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
        u3 = lie.cross(u1, u2)
        return torch.stack([u1, u2, u3], dim=-1)  # orthonormal columns

    W = triad(p_world)
    C = triad(p_cam)
    R = C @ W.transpose(-1, -2)  # right-handed triads both sides: a proper rotation
    cw = p_world.mean(-2)
    cc = p_cam.mean(-2)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _solve3_cramer(J, r):
    """x with J x = r by Cramer's rule; J [..., 3, 3], r [..., 3]."""
    c0, c1, c2 = J[..., :, 0], J[..., :, 1], J[..., :, 2]
    cross = lie.cross

    def dot(a, b):
        return (a * b).sum(-1)

    det = dot(c0, cross(c1, c2))
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    x0 = dot(r, cross(c1, c2))
    x1 = dot(c0, cross(r, c2))
    x2 = dot(c0, cross(c1, r))
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def p3p_grunert(bearings, points):
    """Solve P3P. bearings [..., 3, 3] unit rays in the camera frame (one per
    row), points [..., 3, 3] world points. Returns (poses_w_c [..., 4, 7]
    candidate camera poses T_w_c, valid [..., 4])."""
    j1, j2, j3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    a2 = ((P2 - P3) ** 2).sum(-1)  # a² (opposite vertex 1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    # scale normalization: unit-ish triangle sides keep the quartic well
    # conditioned in float32; distances rescale at the end
    scale2 = ((a2 + b2 + c2) / 3.0).clamp_min(1e-12)
    scale = torch.sqrt(scale2)
    a2, b2, c2 = a2 / scale2, b2 / scale2, c2 / scale2
    ca = (j2 * j3).sum(-1)  # cos(alpha)
    cb = (j1 * j3).sum(-1)
    cg = (j1 * j2).sum(-1)

    b2s = torch.where(b2 < 1e-12, torch.full_like(b2, 1e-12), b2)
    amc = (a2 - c2) / b2s
    apc = (a2 + c2) / b2s
    bmc = (b2 - c2) / b2s
    bma = (b2 - a2) / b2s

    A4 = (amc - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca * ca
    A3 = 4.0 * (
        amc * (1.0 - amc) * cb
        - (1.0 - apc) * ca * cg
        + 2.0 * (c2 / b2s) * ca * ca * cb
    )
    A2 = 2.0 * (
        amc * amc
        - 1.0
        + 2.0 * amc * amc * cb * cb
        + 2.0 * bmc * ca * ca
        - 4.0 * apc * ca * cb * cg
        + 2.0 * bma * cg * cg
    )
    A1 = 4.0 * (
        -amc * (1.0 + amc) * cb
        + 2.0 * (a2 / b2s) * cg * cg * cb
        - (1.0 - apc) * ca * cg
    )
    A0 = (1.0 + amc) ** 2 - 4.0 * (a2 / b2s) * cg * cg

    v, v_valid = _quartic_real_roots((A4, A3, A2, A1, A0))  # [..., 4]

    def k(x):  # per-hypothesis scalar against the 4 roots
        return x[..., None]

    # u = s2/s1 from the rational relation (Grunert back-substitution)
    denom = 2.0 * (k(cg) - v * k(ca))
    denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    u = ((-1.0 + k(amc)) * v * v - 2.0 * k(amc) * k(cb) * v + 1.0 + k(amc)) / denom

    s1sq = k(b2) / (1.0 + v * v - 2.0 * v * k(cb)).clamp_min(1e-12)
    s1 = torch.sqrt(s1sq) * k(scale)  # undo the normalization
    s2 = u * s1
    s3 = v * s1
    dist_valid = v_valid & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Newton polish of (s1, s2, s3) on the three law-of-cosines residuals,
    # with their Jacobian in closed form: removes the back-substitution error
    a2s, b2s_, c2s = k(a2 * scale2), k(b2 * scale2), k(c2 * scale2)
    kca, kcb, kcg = k(ca), k(cb), k(cg)
    eye = 1e-9 * torch.eye(3, dtype=v.dtype, device=v.device)
    s = torch.stack([s1, s2, s3], dim=-1)  # [..., 4, 3]
    for _ in range(3):
        t1, t2, t3 = s[..., 0], s[..., 1], s[..., 2]
        r = torch.stack([
            t2 * t2 + t3 * t3 - 2.0 * t2 * t3 * kca - a2s,
            t1 * t1 + t3 * t3 - 2.0 * t1 * t3 * kcb - b2s_,
            t1 * t1 + t2 * t2 - 2.0 * t1 * t2 * kcg - c2s,
        ], dim=-1)
        z = torch.zeros_like(t1)
        J = torch.stack([
            torch.stack([z, 2.0 * t2 - 2.0 * t3 * kca, 2.0 * t3 - 2.0 * t2 * kca], dim=-1),
            torch.stack([2.0 * t1 - 2.0 * t3 * kcb, z, 2.0 * t3 - 2.0 * t1 * kcb], dim=-1),
            torch.stack([2.0 * t1 - 2.0 * t2 * kcg, 2.0 * t2 - 2.0 * t1 * kcg, z], dim=-1),
        ], dim=-2)
        s_new = s - _solve3_cramer(J + eye, r)
        ok = torch.isfinite(s_new).all(-1) & (s_new > 0).all(-1)
        s = torch.where(ok[..., None], s_new, s)

    # camera-frame points of every root: [..., 4, 3 points, 3]
    p_cam = s[..., :, :, None] * bearings[..., None, :, :]
    R, t = _kabsch_3pt(points[..., None, :, :], p_cam)  # T_c_w
    poses = lie.se3_inverse(torch.cat([lie.quat_from_matrix(R), t], dim=-1))  # T_w_c
    finite = torch.isfinite(poses).all(-1)
    return poses, dist_valid & finite


def reprojection_angle_residual(pose_w_c, bearings, points):
    """1 − cos(angle) between observed bearings and predicted directions.
    pose_w_c [..., 7], bearings and points [N, 3] -> [..., N]."""
    p_cam = lie.se3_apply(lie.se3_inverse(pose_w_c)[..., None, :], points)
    norm = torch.linalg.norm(p_cam, dim=-1, keepdim=True)
    pred = p_cam / norm.clamp_min(1e-12)
    return 1.0 - (bearings * pred).sum(-1)
