"""Batched-hypothesis RANSAC — counterpart of `evo_tpu/solve/ransac.py`.

Draw H minimal samples up front, solve all H hypotheses in one batched call,
score every hypothesis against every correspondence with one [H·M, N]
residual matrix, and take the hypothesis with most inliers. No
data-dependent iteration count, no early exit.

Randomness is explicit: the minimal samples come from a `torch.Generator`
the caller passes, or from an `indices` [H, S] tensor given instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.kernels import localize as klocalize
from evo_tpu_torch.solve import epipolar, p3p


@dataclasses.dataclass(frozen=True)
class RansacResult:
    model: Any  # best model parameters
    inliers: torch.Tensor  # [N] bool
    num_inliers: torch.Tensor  # [] int32
    best_idx: torch.Tensor  # [] int32 index into the H·M candidates


def sample_indices(generator, num_hyp: int, sample_size: int, n_valid: int,
                   n_max: int) -> torch.Tensor:
    """[H, S] random indices into the first `n_valid` entries, on the
    generator's device. Sampling is with replacement per hypothesis:
    duplicates make a degenerate minimal set that simply scores poorly."""
    return torch.randint(0, max(int(n_valid), 1), (num_hyp, sample_size),
                         generator=generator, device=generator.device) % n_max


def ransac(
    solver: Callable,
    residual_fn: Callable,
    data: tuple,
    n_valid: int,
    n_max: int,
    *,
    sample_size: int,
    num_hypotheses: int = 256,
    threshold: float = 1e-3,
    valid_mask=None,
    generator: torch.Generator | None = None,
    indices=None,
) -> RansacResult:
    """Generic batched RANSAC.

    solver : (sample_data) -> (models [H, M, ...], model_valid [H, M]), M
        candidate models per minimal sample (e.g. the 4 P3P roots).
    residual_fn : (models [H·M, ...], data) -> residuals [H·M, N] (>= 0). A
        NaN residual is an outlier.
    data : tuple of tensors with leading dimension N = n_max (padded);
        `n_valid` entries are real.
    """
    if indices is None:
        indices = sample_indices(generator, num_hypotheses, sample_size, n_valid, n_max)
    idx = indices.to(data[0].device)
    models, model_valid = solver(tuple(a[idx] for a in data))  # [H, M, ...], [H, M]
    flat_models = models.flatten(0, 1)
    inlier_matrix = (residual_fn(flat_models, data) < threshold) \
        & model_valid.reshape(-1, 1)  # [H·M, N]
    if valid_mask is not None:
        inlier_matrix = inlier_matrix & valid_mask
    counts = inlier_matrix.sum(-1)
    # the first of the candidates with most inliers
    order = torch.arange(len(counts), device=counts.device)
    best = torch.where(counts == counts.max(), order, len(counts)).min()
    return RansacResult(
        model=flat_models[best],
        inliers=inlier_matrix[best],
        num_inliers=counts[best].to(torch.int32),
        best_idx=best.to(torch.int32),
    )


def relative_pose_ransac(f1, f2, n_valid: int, *, num_hypotheses: int = 256,
                         threshold: float = 1e-4, valid_mask=None,
                         generator=None, indices=None):
    """2D-2D bootstrap: 8-point essential RANSAC over bearing pairs f1, f2
    [N, 3] (padded). Each minimal essential estimate is decomposed into its
    4 (R, t) candidates, and every candidate is scored by the triangulated
    angular reprojection residual. The best pose is refined nonlinearly on
    its inliers, and the inliers are reselected against the refined pose.

    Returns (pose_1_2 [7] with unit translation, RansacResult with the final
    inlier set)."""

    def solver(sample):
        E = epipolar.eight_point(*sample)
        cands = epipolar.decompose_candidates(E)
        return cands, torch.ones(cands.shape[:2], dtype=torch.bool, device=cands.device)

    def residual(poses, data):
        return epipolar.relative_reprojection_residual(poses, *data)

    res = ransac(
        solver, residual, (f1, f2), n_valid, f1.shape[0], sample_size=8,
        num_hypotheses=num_hypotheses, threshold=threshold, valid_mask=valid_mask,
        generator=generator, indices=indices,
    )
    pose_1_2 = epipolar.refine_relative_pose(res.model, f1, f2, res.inliers.to(f1.dtype))
    inl = epipolar.relative_reprojection_residual(pose_1_2, f1, f2) < threshold
    if valid_mask is not None:
        inl = inl & valid_mask
    return pose_1_2, RansacResult(model=res.model, inliers=inl,
                                  num_inliers=inl.sum().to(torch.int32),
                                  best_idx=res.best_idx)


def absolute_pose_ransac(bearings, points, n_valid: int, *, num_hypotheses: int = 128,
                         threshold: float = 1.12e-4,  # 1 - cos(atan2(3 px, 200))
                         valid_mask=None, generator=None, indices=None):
    """2D-3D localization: P3P RANSAC over bearings and world points [N, 3]
    (padded); all 4 roots of every minimal solve are scored. Returns (best
    pose_w_c [7], RansacResult)."""

    def solver(sample):
        return p3p.p3p_grunert(*sample)

    def residual(poses, data):
        return p3p.reprojection_angle_residual(poses, *data)

    res = ransac(
        solver, residual, (bearings, points), n_valid, bearings.shape[0],
        sample_size=3, num_hypotheses=num_hypotheses, threshold=threshold,
        valid_mask=valid_mask, generator=generator, indices=indices,
    )
    return res.model, res


def refine_absolute_pose(pose_w_c, bearings, points, inliers, num_iters: int = 10):
    """Nonlinear refinement of an absolute pose [7] on its inlier set:
    minimizes the angular residuals with the LM on the SE(3) manifold."""
    from evo_tpu_torch.solve.lm import lm_solve

    w = inliers.to(bearings.dtype)

    def residual(x):  # x [1, 7]
        return p3p.reprojection_angle_residual(x, bearings, points) * w

    out = lm_solve(None, pose_w_c[None], residual_fn=residual,
                   retract=lie.se3_retract, tangent_dim=6, num_iters=num_iters)
    return out.x[0]


def refine_absolute_pose_reselect(pose_w_c, bearings, points, inliers, threshold):
    """`refine_absolute_pose`, then the inliers of the refined pose."""
    refined = refine_absolute_pose(pose_w_c, bearings, points, inliers)
    r = p3p.reprojection_angle_residual(refined, bearings, points)
    return refined, r < threshold


def localize_camera_fused(intr, pix, points, n_valid: int, valid_mask, threshold, *,
                          num_hypotheses: int = 128, generator=None, indices=None):
    """The whole 2D-3D localization stage: unproject the padded pixel
    observations, P3P RANSAC, nonlinear refinement on the inliers, and
    inlier reselection. Returns (pose_w_c [7], inliers [N]). On the card one
    launch of the CUDA kernel `kernels.localize`; on the CPU
    `localize_camera_fused_ref`."""
    if pix.device.type == "cuda":
        if indices is None:
            indices = sample_indices(generator, num_hypotheses, 3, n_valid, pix.shape[0])
        out = klocalize.localize(intr, pix, points, valid_mask, threshold, indices)
        return out.pose, out.inliers
    return localize_camera_fused_ref(intr, pix, points, n_valid, valid_mask, threshold,
                                     num_hypotheses=num_hypotheses, generator=generator,
                                     indices=indices)


def localize_camera_fused_ref(intr, pix, points, n_valid: int, valid_mask, threshold, *,
                              num_hypotheses: int = 128, generator=None, indices=None):
    """`localize_camera_fused` in plain PyTorch (the kernel's plain version):
    the refinement's Jacobian by forward-mode autodiff."""
    bearings = camera.unproject(intr, pix)
    pose, res = absolute_pose_ransac(
        bearings, points, n_valid, num_hypotheses=num_hypotheses,
        threshold=threshold, valid_mask=valid_mask, generator=generator,
        indices=indices,
    )
    refined, inl = refine_absolute_pose_reselect(
        pose, bearings, points, res.inliers, threshold)
    return refined, inl & valid_mask
