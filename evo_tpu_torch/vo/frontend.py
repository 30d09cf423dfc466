"""Visual-odometry front end: keyframe policy, localization, mapping, BA —
counterpart of `evo_tpu/vo/frontend.py`, same policy:

- keyframe admission: frame 0 = identity; frame 1 = 2D-2D bootstrap (8-point
  RANSAC over shared-track bearings with unit-norm translation); later
  frames = 2D-3D localization (P3P RANSAC + nonlinear refinement + inlier
  reselection), accepted when inliers > num_inliers, else a re-bootstrap is
  tried, else the last pose is reused for up to max_num_without_add frames;
- map maintenance: the oldest keyframe beyond the active window is evicted,
  landmarks that lose their last observation are archived, each track is
  triangulated on its 2nd observation;
- windowed BA after every accepted keyframe (`evo_tpu_torch.vo.ba`);
- ground truth synchronized by SE(3) interpolation, and a live
  Sim(3)-aligned ATE.

The bookkeeping (dicts of tracks, float64 numpy poses and landmarks) lives on
the host; every solve packs padded float32 arrays and runs on the geometry
device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.core import device as _device
from evo_tpu_torch.io.replay import interpolate_gt
from evo_tpu_torch.solve import ransac, triangulate
from evo_tpu_torch.vo import ba
from evo_tpu_torch.vo.align_sim3 import ErrorMetric, align_trajectories_sim3
from evo_tpu_torch.vo.keyframe import Keyframe, MapLandmarks, Match

_log = logging.getLogger(__name__)
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


@dataclasses.dataclass
class VoParams:
    """The JAX package's `VoParams`, same fields and defaults except
    `geometry_backend`."""

    num_active_frames: int = 20
    num_inliers: int = 55
    ransac_min_inliers: int = 15
    max_iterations: int = 50
    max_num_without_add: int = 4
    ransac_threshold: float = 5e-5
    reprojection_error_px: float = 3.0
    huber_loss: float = 0.8
    num_bootstrap_hypotheses: int = 256
    num_localize_hypotheses: int = 128
    # compensated (two-float) assembly of the BA normal-equation blocks
    ba_compensated: bool = False
    # BA function tolerance: an accepted LM step whose relative cost
    # decrease falls below it ends the solve
    ba_tol: float = 1e-5
    # robustness gates, in units of the map's scale (the bootstrap
    # translation has unit length): one near-parallel triangulation at ~1e6
    # would poison the map and the localization that follows
    max_landmark_depth: float = 1e3
    max_pose_translation: float = 1e3
    # "default": the VO geometry (RANSAC, triangulation, BA, Sim3) runs on
    # the front end's device, the card when there is one. "cpu": the caller
    # asks for the host CPU. (The JAX package defaults to "cpu" because its
    # accelerator sits behind a network round trip; a local card does not.)
    geometry_backend: str = "default"


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class VisualOdometryFrontEnd:
    def __init__(self, calib, params: VoParams | None = None, seed: int = 0,
                 device=None):
        self.params = params or VoParams()
        if self.params.geometry_backend not in ("default", "cpu"):
            raise ValueError(
                f"geometry_backend {self.params.geometry_backend!r}: 'default' or 'cpu'")
        self.calib = calib
        self.device = _device.resolve(
            "cpu" if self.params.geometry_backend == "cpu" else device)
        self.intr = torch.tensor(calib.to_list(), dtype=torch.float32, device=self.device)
        self.active_frames: dict[int, Keyframe] = {}  # t_us -> Keyframe
        self.stored_frames: list[Keyframe] = []
        self.map = MapLandmarks()
        self.stored_landmarks: list[tuple[int, np.ndarray]] = []
        self.without_add = 0
        self.gt_t_us = np.zeros(0, np.int64)
        self.gt_poses = np.zeros((0, 7))
        self.gt_list: list[np.ndarray] = []
        self.gt_aligned: list[np.ndarray] = []
        self.zero_gt: np.ndarray | None = None
        self.last_ate: ErrorMetric | None = None
        # the minimal samples of every RANSAC come from this generator; it
        # lives on the host, so one seed draws the same samples on any device
        self.generator = torch.Generator(device="cpu").manual_seed(seed)
        # (iterations, initial cost, final cost, observations) of every BA
        self.ba_log: list[tuple[int, float, float, int]] = []
        # device types the solves' results were found on
        self.solve_devices: set[str] = set()
        # wall seconds per geometric stage; each stage ends by pulling its
        # result to the host, so the device's work is inside
        self.stage_s: collections.defaultdict = collections.defaultdict(float)
        # calls per geometric stage (a localization or a BA is one solve)
        self.stage_calls: collections.defaultdict = collections.defaultdict(int)

    # ------------------------------------------------------------------
    def set_ground_truth(self, t_us: np.ndarray, poses: np.ndarray) -> None:
        self.gt_t_us = t_us
        self.gt_poses = poses

    def load_numpy_state(self, active_frames, stored_frames, landmarks: dict,
                         observations: dict, stored_landmarks, without_add: int,
                         gt_list=(), gt_aligned=(), zero_gt=None) -> None:
        """Carry a front end's state across from host data (e.g. the JAX
        front end's): keyframes are any objects with `t_us`, `landmarks`
        and `pose`; the map's `landmarks` and `observations` are dicts by
        track id. Everything is copied."""

        def kf(k):
            return Keyframe(
                t_us=int(k.t_us),
                landmarks={int(t): np.asarray(p, np.float64).copy()
                           for t, p in k.landmarks.items()},
                pose=np.asarray(k.pose, np.float64).copy())

        self.active_frames = {int(k.t_us): kf(k) for k in active_frames}
        self.stored_frames = [kf(k) for k in stored_frames]
        self.map = MapLandmarks(
            landmarks={int(t): np.asarray(p, np.float64).copy()
                       for t, p in landmarks.items()},
            observations={int(t): [int(o) for o in obs]
                          for t, obs in observations.items()})
        self.stored_landmarks = [(int(t), np.asarray(p, np.float64).copy())
                                 for t, p in stored_landmarks]
        self.without_add = int(without_add)
        self.gt_list = [np.asarray(g).copy() for g in gt_list]
        self.gt_aligned = [np.asarray(g).copy() for g in gt_aligned]
        self.zero_gt = None if zero_gt is None else np.asarray(zero_gt).copy()

    def poses(self) -> list[np.ndarray]:
        """Every keyframe pose, stored then active, in time order."""
        return [kf.pose for kf in self.stored_frames] + [
            self.active_frames[t].pose for t in sorted(self.active_frames)]

    def _sample_indices(self, num_hyp: int, sample_size: int, n_valid: int,
                        n_max: int) -> torch.Tensor:
        return ransac.sample_indices(self.generator, num_hyp, sample_size, n_valid, n_max)

    def _f32(self, arr) -> torch.Tensor:
        return torch.tensor(np.asarray(arr), dtype=torch.float32, device=self.device)

    def _packed(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host arrays on the device in one copy of one packed buffer: a view
        of it for each array, with the array's dtype and shape (each at an
        8-byte offset)."""
        offsets, size = [], 0
        for a in arrays:
            offsets.append(size)
            size += -(-a.nbytes // 8) * 8
        buf = np.zeros(size, np.uint8)
        for a, at in zip(arrays, offsets):
            buf[at:at + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        dev = torch.from_numpy(buf).to(self.device)
        return [dev[at:at + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
                for a, at in zip(arrays, offsets)]

    def _pad2(self, arr, size: int) -> torch.Tensor:
        """Rows of `arr` (numpy or tensor) as float32 on the device, padded
        with zero rows to `size`."""
        t = arr if isinstance(arr, torch.Tensor) else self._f32(arr)
        return torch.cat([t, t.new_zeros((size - len(t),) + t.shape[1:])])

    @contextlib.contextmanager
    def _timed(self, stage: str):
        t0 = time.perf_counter()
        self.stage_calls[stage] += 1
        try:
            yield
        finally:
            self.stage_s[stage] += time.perf_counter() - t0

    def _pull(self, *tensors) -> list[np.ndarray]:
        """Solver results to the host, noting the device they were on."""
        self.solve_devices.update(t.device.type for t in tensors)
        return [t.cpu().numpy() for t in tensors]

    # -- policy ---------------------------------------------------------
    def new_keyframe_candidate(self, keyframe: Keyframe) -> bool:
        match = Match()
        if not self._is_new_keyframe_needed(keyframe, match):
            self.without_add += 1
            return False

        gt = self._sync_gt(keyframe.t_us)
        if gt is not None:
            if not self.gt_list:
                self.zero_gt = gt
            zero = self._f32(self.zero_gt)
            rel = lie.se3_compose(lie.se3_inverse(zero), self._f32(gt)).cpu().numpy()
            self.gt_list.append(rel)
            self.gt_aligned.append(rel)

        self._delete_keyframe()
        self._add_keyframe(keyframe, match)
        self._optimize()

        poses = self.poses()
        if len(poses) > 5 and self.gt_list:
            with self._timed("ate"):
                sim, ate = align_trajectories_sim3(self.gt_list, poses, self.device)
                self.last_ate = ate
                aligned = lie.sim3_mul_se3(lie.sim3_inverse(self._f32(sim)),
                                           self._f32(np.stack(self.gt_list)))
                self.gt_aligned = list(aligned.cpu().numpy().astype(np.float64))
            _log.info(
                "ATE rmse=%.4f mean=%.4f max=%.4f min=%.4f",
                ate.rmse, ate.mean, ate.max, ate.min,
            )
        _log.info(
            "keyframe @%d added; map has %d landmarks",
            keyframe.t_us, len(self.map.landmarks),
        )
        return True

    def _is_new_keyframe_needed(self, keyframe: Keyframe, match: Match) -> bool:
        if not self.active_frames:
            keyframe.pose = np.array([1.0, 0, 0, 0, 0, 0, 0])
            match.inliers = list(keyframe.landmarks)
            return True
        if len(self.active_frames) == 1:
            return self._init_cameras(keyframe, match)
        self._localize_camera(keyframe, match)
        keyframe.pose = match.pose.copy()
        if len(match.inliers) > self.params.num_inliers:
            return True
        if self._init_cameras(keyframe, match):
            return True
        if self.params.max_num_without_add > self.without_add:
            last_t = max(self.active_frames)
            match.pose = self.active_frames[last_t].pose.copy()
            keyframe.pose = match.pose.copy()
            match.inliers = list(keyframe.landmarks)
            return True
        _log.info("few inliers after localization: %d", len(match.inliers))
        return True

    # -- geometric stages ----------------------------------------------
    def _init_cameras(self, keyframe: Keyframe, match: Match) -> bool:
        """2D-2D bootstrap against the newest active keyframe."""
        start = self.active_frames[max(self.active_frames)]
        shared = start.shared_tracks(keyframe)
        if len(shared) < 8:
            return False
        n = len(shared)
        b = _bucket(n)
        # bearings of the shared tracks, padded with zero rows
        f1 = self._pad2(camera.unproject(
            self.intr, self._f32(np.stack([start.landmarks[t] for t in shared]))), b)
        f2 = self._pad2(camera.unproject(
            self.intr, self._f32(np.stack([keyframe.landmarks[t] for t in shared]))), b)
        valid = torch.arange(b, device=self.device) < n
        with self._timed("bootstrap"):
            pose_rel, res = ransac.relative_pose_ransac(
                f1, f2, n, num_hypotheses=self.params.num_bootstrap_hypotheses,
                threshold=self.params.ransac_threshold, valid_mask=valid,
                indices=self._sample_indices(
                    self.params.num_bootstrap_hypotheses, 8, n, b),
            )
            # T_w_new = T_w_last · T_rel (the unit-norm translation fixes the scale)
            pose_w = lie.se3_compose(self._f32(start.pose), pose_rel)
            pose_np, inl = self._pull(pose_w, res.inliers)
        n_inl = int(inl.sum())
        _log.info("bootstrap with %d RANSAC inliers", n_inl)
        if n_inl < max(self.params.ransac_min_inliers, self.params.num_inliers):
            return False
        match.inliers = [t for t, ok in zip(shared, inl[:n]) if ok]
        keyframe.pose = pose_np.astype(np.float64)
        match.pose = keyframe.pose.copy()
        return True

    def _localize_camera(self, keyframe: Keyframe, match: Match) -> None:
        """2D-3D localization against the current landmark map."""
        match.inliers = []
        tracks = [t for t in keyframe.landmarks if t in self.map.landmarks]
        if len(tracks) < 4:
            return
        pix = np.stack([keyframe.landmarks[t] for t in tracks])
        pts = np.stack([self.map.landmarks[t] for t in tracks])
        n = len(tracks)
        b = _bucket(n)
        threshold = 1.0 - np.cos(np.arctan2(self.params.reprojection_error_px, 200.0))
        with self._timed("localize"):
            # padded on the host, moved in one copy
            pix_b = np.zeros((b, 2), np.float32)
            pts_b = np.zeros((b, 3), np.float32)
            pix_b[:n], pts_b[:n] = pix, pts
            idx = self._sample_indices(self.params.num_localize_hypotheses, 3, n, b)
            pix_t, pts_t, valid, idx = self._packed(pix_b, pts_b, np.arange(b) < n,
                                                    idx.numpy().astype(np.int64))
            refined, inl_mask = ransac.localize_camera_fused(
                self.intr, pix_t, pts_t, n, valid, float(threshold),
                num_hypotheses=self.params.num_localize_hypotheses, indices=idx)
            refined_np, inl = self._pull(refined, inl_mask)
        pose_np = refined_np.astype(np.float64)
        # sanity gate: a localization that teleports the camera outside the
        # map's scale is a degenerate P3P fit, not a pose
        if not np.all(np.isfinite(pose_np)) or (
            np.linalg.norm(pose_np[4:7]) > self.params.max_pose_translation
        ):
            _log.warning("localization rejected: |t|=%.3g",
                         float(np.linalg.norm(pose_np[4:7])))
            return
        match.pose = pose_np
        match.inliers = [t for t, ok in zip(tracks, inl[:n]) if ok]

    # -- map maintenance ------------------------------------------------
    def _add_keyframe(self, keyframe: Keyframe, match: Match) -> None:
        self.without_add = 0
        self.active_frames[keyframe.t_us] = keyframe
        self._add_new_landmarks(keyframe, match)

    def _delete_keyframe(self) -> None:
        if len(self.active_frames) > self.params.num_active_frames:
            oldest = self.active_frames.pop(min(self.active_frames))
            self.stored_frames.append(oldest)
            self._delete_landmarks(oldest)

    def _add_new_landmarks(self, keyframe: Keyframe, match: Match) -> None:
        """Observations for the inliers; a track is triangulated on its 2nd
        observation. All of a keyframe's new landmarks that share the
        first-observation keyframe triangulate in one padded batch."""
        pending: dict[int, list[int]] = {}
        for track in match.inliers:
            self.map.observations.setdefault(track, []).append(keyframe.t_us)
            obs = self.map.observations[track]
            if len(obs) == 2 and obs[0] in self.active_frames:
                if obs[1] in self.active_frames and track in keyframe.landmarks:
                    pending.setdefault(obs[0], []).append(track)
        for t1, tracks in pending.items():
            k1 = self.active_frames[t1]
            tracks = [t for t in tracks if t in k1.landmarks]
            if not tracks:
                continue
            f1 = camera.unproject(
                self.intr, self._f32(np.stack([k1.landmarks[t] for t in tracks])))
            f2 = camera.unproject(
                self.intr, self._f32(np.stack([keyframe.landmarks[t] for t in tracks])))
            with self._timed("triangulate"):
                p_w, _ = triangulate.triangulate_landmarks(
                    f1, f2, self._f32(k1.pose), self._f32(keyframe.pose))
                p_w = self._pull(p_w)[0].astype(np.float64)
            # depth gate: near-parallel rays triangulate to ~1e6
            dist = np.linalg.norm(p_w - keyframe.pose[4:7], axis=-1)
            for i, t in enumerate(tracks):
                if np.all(np.isfinite(p_w[i])) and (
                    dist[i] <= self.params.max_landmark_depth
                ):
                    self.map.landmarks[t] = p_w[i]

    def _delete_landmarks(self, keyframe: Keyframe) -> None:
        for track in keyframe.landmarks:
            obs = self.map.observations.get(track)
            if obs and keyframe.t_us in obs:
                obs.remove(keyframe.t_us)
        dead = [t for t, obs in self.map.observations.items() if not obs]
        for t in dead:
            if t in self.map.landmarks:
                self.stored_landmarks.append((t, self.map.landmarks.pop(t)))
            del self.map.observations[t]

    # -- BA --------------------------------------------------------------
    def _optimize(self) -> None:
        frames_t = sorted(self.active_frames)
        F = len(frames_t)
        if F < 3:
            return
        frame_idx = {t: i for i, t in enumerate(frames_t)}
        lm_ids = [
            t for t, obs in self.map.observations.items()
            if len(obs) >= 2 and t in self.map.landmarks
        ]
        if not lm_ids:
            return
        lm_idx = {t: i for i, t in enumerate(lm_ids)}
        obs_f, obs_l, obs_p = [], [], []
        for t in lm_ids:
            for kt in self.map.observations[t]:
                kf = self.active_frames.get(kt)
                if kf is None or t not in kf.landmarks:
                    continue
                obs_f.append(frame_idx[kt])
                obs_l.append(lm_idx[t])
                obs_p.append(kf.landmarks[t])
        O = len(obs_f)
        if O < 10:
            return
        # fixed padded shapes: one more frame than the window holds, landmarks
        # to the next multiple of 64 (the dense Schur product is linear in
        # the padded L), observations to a power-of-two bucket
        Fb = self.params.num_active_frames + 1
        Lb = 64 * max(1, -(-len(lm_ids) // 64))
        Ob = _bucket(O, 256)

        poses = np.zeros((Fb, 7), np.float32)
        poses[:, 0] = 1.0
        for t, i in frame_idx.items():
            poses[i] = self.active_frames[t].pose
        lms = np.zeros((Lb, 3), np.float32)
        for t, i in lm_idx.items():
            lms[i] = self.map.landmarks[t]
        of = np.zeros(Ob, np.int64)
        ol = np.zeros(Ob, np.int64)
        op = np.zeros((Ob, 2), np.float32)
        om = np.zeros(Ob, bool)
        of[:O] = obs_f
        ol[:O] = obs_l
        op[:O] = obs_p
        om[:O] = True
        fixed = np.zeros(Fb, bool)
        fixed[: min(2, F)] = True
        fixed[F:] = True  # padding frames pinned

        with self._timed("ba"):
            # the inputs in one copy; the results (and the trips) in one read
            poses_t, lms_t, *obs = self._packed(poses, lms, of, ol, op, om, fixed)
            res = ba.ba_solve(
                poses_t, lms_t, self.intr, *obs, num_iters=self.params.max_iterations,
                huber=self.params.huber_loss, compensated=self.params.ba_compensated,
                tol=self.params.ba_tol,
            )
            self.solve_devices.add(res[0].device.type)
            new_poses, new_lms, cost, cost0, ba_iters = ba.result_to_host(res)
            costs = (cost0, cost)
        new_poses = new_poses.astype(np.float64)
        new_lms = new_lms.astype(np.float64)
        # post-solve sanity gates: a weakly constrained direction can let BA
        # run a pose or landmark to ~1e4-1e8 while still reducing the robust
        # cost; such an update is rejected (the pose keeps its prior value,
        # the landmark is archived)
        for t, i in frame_idx.items():
            p = new_poses[i]
            if np.all(np.isfinite(p)) and (
                np.linalg.norm(p[4:7]) <= self.params.max_pose_translation
            ):
                self.active_frames[t].pose = p
        newest_c = self.active_frames[frames_t[-1]].pose[4:7]
        for t, i in lm_idx.items():
            p = new_lms[i]
            if np.all(np.isfinite(p)) and (
                np.linalg.norm(p - newest_c) <= self.params.max_landmark_depth
            ):
                self.map.landmarks[t] = p
            else:
                self.stored_landmarks.append((t, self.map.landmarks.pop(t)))
                self.map.observations.pop(t, None)
        self.ba_log.append((int(ba_iters), float(costs[0]), float(costs[1]), O))
        _log.info("BA: cost %.4f -> %.4f over %d obs, %d iters",
                  costs[0], costs[1], O, ba_iters)

    # -- GT ---------------------------------------------------------------
    def _sync_gt(self, t_us: int):
        return interpolate_gt(self.gt_t_us, self.gt_poses, t_us)
