"""The BA normal equations reduced over the ``batch`` axis — counterpart of
`evo_tpu/dist/reduce.py`.

The observations are split over ``batch``; each rank assembles the partial
blocks Hpp, Hll, A, bp and bl of its block as the BA does
(`vo.ba.normal_equations`, summed in one order on every run); one
`all_reduce` over ``batch`` sums them, ahead of the small Schur solve every
rank can then do alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.dist.mesh import BATCH_AXIS, block
from evo_tpu_torch.vo.ba import normal_equations, observation_sums


def sharded_normal_equations(mesh, poses, landmarks, intr, obs_frame, obs_lm,
                             obs_p2d, obs_mask, pose_fixed, huber: float = 0.8,
                             device=None):
    """One distributed linearization pass. poses [F, 7], landmarks [L, 3],
    intr [9], pose_fixed [F] and the observations obs_frame, obs_lm [O],
    obs_p2d [O, 2], obs_mask [O] (O divisible by the batch axis; pad with
    mask False) are global on every rank. Returns the replicated (Hpp
    [F, 6, 6], Hll [L, 3, 3], A [L, F, 6, 3], bp [F, 6], bl [L, 3]) in float32
    on `device` (None: the card when there is one)."""
    dev = resolve(device)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i64(a):
        return torch.as_tensor(a, device=dev).long()

    poses, landmarks, intr = f32(poses), f32(landmarks), f32(intr)
    fixed = torch.as_tensor(pose_fixed, device=dev).bool()
    rows = block(mesh, BATCH_AXIS, len(obs_frame))
    of, ol = i64(obs_frame[rows]), i64(obs_lm[rows])
    op, om = f32(obs_p2d[rows]), f32(obs_mask[rows])
    F, L = poses.shape[0], landmarks.shape[0]

    parts = normal_equations(poses, landmarks, intr, of, ol, op, om, fixed,
                             observation_sums(of, ol, F, L, obs_mask=om > 0), huber)
    # one reduction over the observation shards for all five blocks
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=mesh.get_group(BATCH_AXIS))
    out, at = [], 0
    for p in parts:
        out.append(flat[at: at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)
