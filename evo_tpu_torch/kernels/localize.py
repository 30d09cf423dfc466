"""VO's 2D-3D localization as one CUDA kernel, one launch a call.

Counterpart of `evo_tpu/solve/ransac.py::localize_camera_fused` (one jitted
XLA program in the JAX package; it has no Pallas kernel here):
`csrc/localize.cu`, built at first use by `kernels.nvcc` with `-fmad=false`,
unprojects the pixels, solves Grunert's P3P for every given minimal sample
(a warp eight samples, a lane a root), scores the 4 roots of each (a warp a
candidate, its lanes over the points), takes the first candidate with the
most inliers (a block reduction), refines it by the LM of `solve.lm.lm_solve`
with a closed-form Jacobian (`angle_residual_jacobian` is its plain form)
and reselects the inliers, in one block; its bits do not depend on the
block's size. The plain version is `solve.ransac.localize_camera_fused_ref`;
`solve.ransac.localize_camera_fused` picks between the two by the tensors'
device. Tensors on the card only: a CPU tensor raises here, as does a
failed build or launch. `localize(..., clocks=True)` launches the clock
build (-DEVO_LOC_CLOCKS, a library of its own), which writes the launch's
clock64() cycles by stage (`STAGES`) into the result's `clocks`; the main
path never launches it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from evo_tpu_torch.core import lie
from evo_tpu_torch.kernels import nvcc
from evo_tpu_torch.solve import p3p

THREADS = 512
# the shared memory of a launch holds 14 floats a point: 227 KB take 4,000
MAX_POINTS = 4096

# launches since the last reset, under a lock (VO may run on its own thread)
launches_localize = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_localize
    with _count_lock:
        launches_localize = 0


def _count() -> None:
    global launches_localize
    with _count_lock:
        launches_localize += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # intr, pix, pts, valid, samples, grid, threshold, n, h, threads, fout,
    # iout, inliers, clocks, stream
    "evo_localize": ([_P] * 6 + [_F] + [_I] * 3 + [_P] * 5, _I),
}
# the clock build's stages, in csrc/localize.cu's `Stage` order: (a) to (d)
# (with the refinement's weights), the LM's linearizations, normal equations
# and one-thread solves and decisions (summed over its trips), (f)
STAGES = ("unproject", "p3p", "score", "select", "lm_linearize", "lm_normal", "lm_solve",
          "reselect", "total")
_grid_lock = threading.Lock()
_grids: dict = {}


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/localize.cu at first use); with
    `clocks`, its clock build (-DEVO_LOC_CLOCKS)."""
    name, flags = "evo_localize", ("-fmad=false",)
    if clocks:
        name, flags = name + "_clock", flags + ("-DEVO_LOC_CLOCKS",)
    return nvcc.load(name, ["localize.cu"], _SIGNATURES, extra_flags=flags,
                     headers=("vo_geometry.cuh",))


def _grid(device):
    """`p3p.quartic_grid` on `device`, made once: the plain version's grid."""
    with _grid_lock:
        if device not in _grids:
            _grids[device] = p3p.quartic_grid(torch.float32, device).contiguous()
        return _grids[device]


@dataclasses.dataclass(frozen=True)
class LocalizeResult:
    pose: torch.Tensor  # [7] refined pose_w_c
    inliers: torch.Tensor  # [N] bool, the refined pose's (and valid)
    best_idx: torch.Tensor  # [] int32 into the 4 H candidates
    num_inliers: torch.Tensor  # [] int32, the best candidate's count
    ransac_pose: torch.Tensor  # [7] the best candidate
    candidates: torch.Tensor  # [4 H, 7] every root of every sample
    candidate_valid: torch.Tensor  # [4 H] int32, 1 where the root is valid
    counts: torch.Tensor  # [4 H] int32 inliers of each candidate
    trips: torch.Tensor  # [] int32, the refinement's LM trips
    clocks: torch.Tensor | None = None  # [len(STAGES)] int64, the clock build's


def run(launch, intr, pix, points, valid_mask, threshold: float, indices,
        threads: int = THREADS, clocks: bool = False) -> LocalizeResult:
    """Check the inputs, allocate the outputs in one arena on pix's device
    and call `launch(*the entry's arguments but the stream)`; with `clocks`,
    an int64 [len(STAGES)] for the clock build's cycles too."""
    dev = pix.device
    n, h = pix.shape[0], indices.shape[0]
    want = dict(intr=(intr, (9,), torch.float32), pix=(pix, (n, 2), torch.float32),
                points=(points, (n, 3), torch.float32), valid_mask=(valid_mask, (n,), torch.bool),
                indices=(indices, (h, 3), torch.int64))
    for name, (a, shape, dtype) in want.items():
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, not {shape}")
        if not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")
    if not 1 <= n <= MAX_POINTS or h < 1:
        raise ValueError(f"{n} points (1 to {MAX_POINTS}) and {h} hypotheses")
    if threads < 64 or threads % 32:
        raise ValueError(f"{threads} threads: a multiple of 32, at least 64")
    nf, ni = 14 + 28 * h, 3 + 8 * h
    arena = torch.empty(nf + ni + (n + 3) // 4, dtype=torch.float32, device=dev)
    fout, iout = arena[:nf], arena[nf:nf + ni].view(torch.int32)
    inliers = arena[nf + ni:].view(torch.uint8)[:n]
    clk = torch.zeros(len(STAGES), dtype=torch.int64, device=dev) if clocks else None
    launch(intr.data_ptr(), pix.data_ptr(), points.data_ptr(), valid_mask.data_ptr(),
           indices.data_ptr(), _grid(dev).data_ptr(), float(threshold), n, h, threads,
           fout.data_ptr(), iout.data_ptr(), inliers.data_ptr(),
           0 if clk is None else clk.data_ptr())
    return LocalizeResult(
        pose=fout[:7], inliers=inliers.view(torch.bool), best_idx=iout[0], num_inliers=iout[1],
        ransac_pose=fout[7:14], candidates=fout[14:].view(4 * h, 7),
        candidate_valid=iout[2 + 4 * h:2 + 8 * h], counts=iout[2:2 + 4 * h],
        trips=iout[2 + 8 * h], clocks=clk)


def localize(intr, pix, points, valid_mask, threshold: float, indices,
             clocks: bool = False) -> LocalizeResult:
    """The localization of `solve.ransac.localize_camera_fused` on the card:
    intr [9], pix [N, 2], points [N, 3] float32, valid_mask [N] bool and the
    minimal samples `indices` [H, 3] int64 (moved to the card if they are
    not there). One launch; with `clocks`, of the clock build."""
    dev = pix.device
    if dev.type != "cuda":
        raise RuntimeError(f"localize has no kernel for device {dev}: the plain version is "
                           "solve.ransac.localize_camera_fused_ref")
    fn = _lib(clocks).evo_localize
    out = run(lambda *args: nvcc.launch(fn, pix, *args), intr, pix, points, valid_mask,
              threshold, indices.to(dev, torch.int64), clocks=clocks)
    _count()
    return out


def angle_residual_jacobian(pose_w_c, bearings, points):
    """The kernel's linearization of `p3p.reprojection_angle_residual` in
    plain PyTorch: r [N] and J [N, 6] in the tangent of `lie.se3_retract` at
    0, closed form. With p_c = exp(-delta) T^-1 X, dp_c/d(v, omega) =
    [-I | [p_c]x] and d(1 - b.p/|p|)/dp = -(b - (b.phat) phat)/|p|."""
    p = lie.se3_apply(lie.se3_inverse(pose_w_c), points)
    nrm = torch.linalg.norm(p, dim=-1, keepdim=True).clamp_min(1e-12)
    ph = p / nrm
    r = 1.0 - (bearings * ph).sum(-1)
    g = -(bearings - (bearings * ph).sum(-1, keepdim=True) * ph) / nrm
    return r, torch.cat([-g, lie.cross(g, p)], dim=-1)
