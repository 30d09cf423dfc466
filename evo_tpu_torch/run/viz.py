"""Offline debug views — counterpart of `evo_tpu/run/viz.py`.

The reference's visualizer shows the frame with patch overlays, the raw
events, the predicted and integrated nabla and the cost map of a patch, and
a 3D scene. These render from the same state to PNG files, written by the
port's own writer (`io.png`); the trajectory plot and the 3D scene need
matplotlib and return None where it is missing.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from evo_tpu_torch.core import lie
from evo_tpu_torch.io.png import write_png
from evo_tpu_torch.tracker import align
from evo_tpu_torch.tracker import patch_state as ps


def _to_u8(img: np.ndarray) -> np.ndarray:
    lo, hi = float(np.min(img)), float(np.max(img))
    if hi - lo < 1e-12:
        return np.zeros_like(img, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def save_gray(path: str, img: np.ndarray) -> str:
    """A float image stretched to [0, 255] as a grayscale PNG."""
    return write_png(path, _to_u8(np.asarray(img)))


def save_rgb(path: str, rgb: np.ndarray) -> str:
    return write_png(path, np.asarray(rgb, np.uint8))


def render_feature_overlay(frame: np.ndarray, tracker, trail_len: int = 20):
    """The frame with patch rects (green) and trajectory trails (red)
    burned in, as an RGB array — the reference's main view."""
    h, w = frame.shape
    rgb = np.stack([_to_u8(frame)] * 3, axis=-1)
    mirror = tracker.host_mirror()
    for i in np.flatnonzero(mirror["alive"]):
        cx, cy = mirror["center"][i]
        x0 = int(np.clip(cx - ps.PATCH_EXTENT, 0, w - 1))
        x1 = int(np.clip(cx + ps.PATCH_EXTENT, 0, w - 1))
        y0 = int(np.clip(cy - ps.PATCH_EXTENT, 0, h - 1))
        y1 = int(np.clip(cy + ps.PATCH_EXTENT, 0, h - 1))
        rgb[y0, x0:x1, 1] = 255
        rgb[y1, x0:x1, 1] = 255
        rgb[y0:y1, x0, 1] = 255
        rgb[y0:y1, x1, 1] = 255
        trail = tracker.trajectories.get(int(mirror["track_id"][i]), [])[-trail_len:]
        for _, tx, ty in trail:
            xi, yi = int(np.clip(tx, 0, w - 1)), int(np.clip(ty, 0, h - 1))
            rgb[yi, xi] = (255, 64, 64)
    return rgb


def render_event_image(x, y, p, height: int = 180, width: int = 240):
    """Raw events by polarity as an RGB array: green +1, red -1."""
    rgb = np.zeros((height, width, 3), np.uint8)
    xi = np.clip(np.round(x).astype(int), 0, width - 1)
    yi = np.clip(np.round(y).astype(int), 0, height - 1)
    pos = p > 0
    rgb[yi[pos], xi[pos], 1] = 255
    rgb[yi[~pos], xi[~pos], 0] = 255
    return rgb


def save_patch_views(out_dir: str, tracker, patch_idx: int = 0) -> dict:
    """The per-patch debug views of row `patch_idx`: integrated nabla,
    predicted nabla, cost map. Returns {name: path}."""
    os.makedirs(out_dir, exist_ok=True)
    table = tracker.global_table()
    views = {
        "integrated_nabla": align.integrate_events(table)[patch_idx],
        "predicted_nabla": align.predicted_nabla(table, tracker.grads)[patch_idx],
        "cost_map": align.cost_map(table, tracker.grads, patch_idx),
    }
    return {name: save_gray(os.path.join(out_dir, f"{name}.png"), v.cpu().numpy())
            for name, v in views.items()}


def _frustum_segments(pose: np.ndarray, scale: float = 0.15):
    """Wireframe segments of a camera frustum at a T_w_c pose [qw qx qy qz tx
    ty tz]: the centre to the four image corners, and the far rectangle."""
    q = torch.tensor(np.asarray(pose[:4], np.float64))
    R = lie.quat_to_matrix(q / torch.linalg.norm(q)).numpy()
    c = np.asarray(pose[4:7], np.float64)
    corners = np.array([[-1, -1, 2.0], [1, -1, 2.0], [1, 1, 2.0], [-1, 1, 2.0]]) * scale
    pts = (R @ corners.T).T + c
    segs = [(c, p) for p in pts]
    segs += [(pts[i], pts[(i + 1) % 4]) for i in range(4)]
    return segs


def render_scene_3d(out_path: str, vo, max_stored: int = 60) -> str | None:
    """The 3D scene as a PNG: active keyframe frusta (green), stored ones
    (gray), the Sim(3)-aligned ground truth (red), live landmarks (blue) and
    archived ones (light gray). None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Line3DCollection
    except ImportError:
        return None

    active = [vo.active_frames[t].pose for t in sorted(vo.active_frames)]
    stored = [kf.pose for kf in vo.stored_frames[-max_stored:]]
    if not active and not stored:
        return None
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")

    def add_frusta(poses, color, lw):
        segs = [s for p in poses for s in _frustum_segments(np.asarray(p))]
        if segs:
            ax.add_collection3d(Line3DCollection(segs, colors=color, linewidths=lw))

    add_frusta(stored, "0.6", 0.6)
    add_frusta(active, "tab:green", 1.0)
    if vo.map.landmarks:
        lm = np.stack(list(vo.map.landmarks.values()))
        ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], s=4, c="tab:blue",
                   label=f"landmarks ({len(lm)})")
    if vo.stored_landmarks:
        sl = np.stack([p for _, p in vo.stored_landmarks])
        ax.scatter(sl[:, 0], sl[:, 1], sl[:, 2], s=2, c="0.75",
                   label=f"archived ({len(sl)})")
    if vo.gt_aligned:
        gt = np.stack([np.asarray(g[4:7]) for g in vo.gt_aligned])
        ax.plot(gt[:, 0], gt[:, 1], gt[:, 2], "r--", lw=1, label="GT (Sim3-aligned)")
    pts = np.stack([np.asarray(p[4:7]) for p in active + stored])
    ctr, rad = pts.mean(0), max(float(np.ptp(pts, 0).max()) / 2, 0.5)
    ax.set_xlim(ctr[0] - rad, ctr[0] + rad)
    ax.set_ylim(ctr[1] - rad, ctr[1] + rad)
    ax.set_zlim(ctr[2] - rad, ctr[2] + rad)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_trajectories(out_path: str, vo, show_gt: bool = True) -> str | None:
    """Top-down (x, z) plot of the keyframe centres against the Sim(3)-aligned
    ground truth. None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    poses = vo.poses()
    if not poses:
        return None
    est = np.stack([p[4:7] for p in poses])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(est[:, 0], est[:, 2], "o-", label="estimated", ms=3)
    if show_gt and vo.gt_aligned:
        gt = np.stack([g[4:7] for g in vo.gt_aligned])
        ax.plot(gt[:, 0], gt[:, 2], "x--", label="GT (Sim3-aligned)", ms=3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out_path
