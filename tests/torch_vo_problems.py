"""Inputs for the tests of VO's two kernels (`kernels.localize`,
`kernels.ba_solve`), made with numpy from a seed and the port's own camera
and Lie functions. It imports no JAX, so the tests of the card import it
too (`import torch_vo_problems`).
"""

import numpy as np
import torch

from evo_tpu_torch.core import camera, lie

# a DAVIS240C-like calibration with the radtan distortion of its lens
INTR = np.array([199.0, 198.0, 132.0, 110.0, -0.37, 0.2, 1e-3, -6e-4, -0.05], np.float32)
PINHOLE = np.array([199.0, 198.0, 132.0, 110.0, 0, 0, 0, 0, 0], np.float32)
# the front end's threshold: 1 - cos(atan2(3 px, 200 px))
THRESHOLD = float(1.0 - np.cos(np.arctan2(3.0, 200.0)))


def T(a):
    return torch.as_tensor(np.asarray(a))


def localize_problem(seed, n=70, b=128, h=128):
    """A localization as the front end calls it: n points 3-8 m ahead of a
    random camera, their pixels through the radtan camera with 0.3 px noise,
    the first 10 moved 25 px (outliers), padded to the bucket b; h minimal
    samples, two of them degenerate (a repeated point). Returns (intr [9],
    pix [b, 2], points [b, 3], n, valid [b], indices [h, 3] int64), CPU
    tensors."""
    rng = np.random.default_rng(seed)
    pose = lie.se3_exp(T(rng.normal(0, 0.3, 6).astype(np.float32)))
    pts_c = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(3, 8, n)], -1).astype(np.float32)
    pix = np.zeros((b, 2), np.float32)
    pix[:n] = camera.project(T(INTR), T(pts_c)).numpy() + rng.normal(0, 0.3, (n, 2))
    pix[:10] += 25.0
    pts = np.zeros((b, 3), np.float32)
    pts[:n] = lie.se3_apply(pose, T(pts_c)).numpy()
    idx = rng.integers(0, n, (h, 3))
    idx[5] = [3, 3, 7]
    idx[9] = [11, 11, 11]
    return T(INTR), T(pix), T(pts), n, T(np.arange(b) < n), T(idx)


def ba_problem(seed=0, F=6, L=64, O=256, n_points=40):
    """tests/test_torch_vo.py's BA scene: cameras on an arc (pinhole) looking
    at n_points points around z ~ 7, observed with 0.3 px noise, frame by
    frame; the poses but the first two perturbed (5 cm, 0.01 rad) and the
    points (8 cm); padded as the front end pads (masked observations,
    landmarks without any, to L and O); the first two frames fixed. Returns
    the eight tensors `ba_solve` takes (obs indices int64), on the CPU."""
    rng = np.random.default_rng(seed)
    intr = T(PINHOLE)
    poses = torch.stack([lie.se3_exp(T(np.array(
        [0.4 * i, 0.02 * i, 0.01 * i, 0.0, 0.05 * i, 0.0], np.float32))) for i in range(F)])
    pts = np.stack([rng.uniform(-2, 3.5, n_points), rng.uniform(-1.5, 1.5, n_points),
                    rng.uniform(5, 9, n_points)], -1).astype(np.float32)
    of, ol, op = [], [], []
    for f in range(F):
        p_cam = lie.se3_apply(lie.se3_inverse(poses[f]), T(pts)).numpy()
        pix = camera.project(intr, T(p_cam)).numpy()
        ok = ((p_cam[:, 2] > 0.5) & (pix[:, 0] > 5) & (pix[:, 0] < 235)
              & (pix[:, 1] > 5) & (pix[:, 1] < 175))
        for i in np.flatnonzero(ok):
            of.append(f)
            ol.append(int(i))
            op.append(pix[i] + rng.normal(0, 0.3, 2))
    pert = poses.clone()
    for f in range(2, F):
        xi = rng.standard_normal(6) * np.array([0.05] * 3 + [0.01] * 3)
        pert[f] = lie.se3_retract(poses[f], T(xi.astype(np.float32)))
    pts = (pts + rng.standard_normal(pts.shape) * 0.08).astype(np.float32)
    o = len(of)
    assert o <= O and n_points <= L
    pad = O - o
    lms = np.zeros((L, 3), np.float32)
    lms[:n_points] = pts
    return [a.contiguous() for a in (
        pert, T(lms), intr, T(np.array(of + [0] * pad, np.int64)),
        T(np.array(ol + [0] * pad, np.int64)),
        T(np.concatenate([np.array(op, np.float32), np.zeros((pad, 2), np.float32)])),
        T(np.arange(O) < o), T(np.arange(F) < 2))]
