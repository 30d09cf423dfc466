"""Failure detection and recovery — counterpart of `evo_tpu/run/watchdog.py`.

`HealthMonitor` reads the host mirrors the pipeline pulls anyway, so its
checks add no device traffic:

- invariant checks on each post-frame mirror (finite centres, live count
  within the cap, allocated track ids, gradient slots in range, event budgets
  in range, solve times that never go backwards, no teleported centre) and
  on the VO state (finite poses and landmarks);
- on a failure: quarantine, which kills the offending rows on the device and
  leaves the rest of the table as it is, and the event logged;
- a periodic auto-checkpoint (`run.checkpoint`), so that a run that cannot
  go on, or a killed process, resumes from the last checkpoint
  (`auto_resume`).

Where the JAX package saves the auto-checkpoint from inside the hook, here
the evaluator saves it at the frame it falls due (`checkpoint_due`), and
`run.checkpoint.state_dict` first consumes the windows in flight: under the
pipelined drive the hook runs while newer windows are dispatched and not yet
logged. Its default path is `autockpt.npz` in the evaluator's `output_dir`,
which without one is a new temporary directory of the run's own (the JAX
package writes `/tmp/autockpt.npz`).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from evo_tpu_torch.tracker import patch_state as ps

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class WatchdogParams:
    check_every: int = 1  # windows between mirror checks
    auto_checkpoint_every: int = 0  # frames; 0 = disabled
    # None: autockpt.npz in the evaluator's output_dir
    checkpoint_path: str | None = None
    # finite-garbage detector: a live track whose centre moved more than
    # this many pixels between consecutive mirror checks is corrupted, not
    # tracking (the alignment solve caps its travel at a few px per solve,
    # and the lost filter kills fast-drifting tracks long before 50 px).
    # 0 disables the check.
    teleport_px: float = 50.0


@dataclasses.dataclass
class FailureEvent:
    window: int
    kind: str
    detail: str


class HealthMonitor:
    """Failure detector and recovery hooks of an Evaluator-driven pipeline."""

    def __init__(self, params: WatchdogParams | None = None):
        self.params = params or WatchdogParams()
        self.failures: list[FailureEvent] = []
        self.windows = 0
        self.recovered_patches = 0
        # per track: last solve time (monotonicity) and last centre (teleport)
        self._last_cur_t: dict[int, float] = {}
        self._last_center: dict[int, tuple[float, float]] = {}

    # -- detection ---------------------------------------------------------
    def check_mirror(self, mirror: dict, max_live: int | None = None) -> np.ndarray:
        """Validate a post-frame mirror of the patch table. Returns a [P]
        bool mask of the bad rows. Every invariant the mirror's keys allow is
        checked (the fused path's frame log carries a subset of the host
        mirror):

        - live centres finite;
        - live count within `max_live` (the tracker's max_patches);
        - live rows carry a track id (>= 0);
        - grad_slot of live rows in [0, P);
        - num_of_events of live rows in (0, MAX_NUM_EVENTS];
        - a track's solve time `cur_t` never goes backwards between checks;
        - a track's centre moves at most `teleport_px` between checks: a
          corrupted but finite centre keeps routing events and solving, so
          no NaN check sees it, but a jump no solve could make does.

        Not detectable by design: a finite budget inside (0, MAX_NUM_EVENTS]
        and a centre nudged by less than `teleport_px`, both inside the
        values healthy tracking produces; the lost filter bounds their harm."""
        alive = mirror["alive"]
        center = mirror["center"]
        bad = alive & ~np.all(np.isfinite(center), axis=-1)
        if bad.any():
            self._record("patch_nonfinite",
                         f"{int(bad.sum())} live patches with non-finite centers")
        if max_live is not None and int(alive.sum()) > max_live:
            self._record("capacity", f"live count {int(alive.sum())} exceeds cap {max_live}")
        if "track_id" in mirror:
            bad_tid = alive & (mirror["track_id"] < 0)
            if bad_tid.any():
                self._record("track_id", f"{int(bad_tid.sum())} live rows "
                             "with unallocated track ids")
                bad = bad | bad_tid
        if "grad_slot" in mirror:
            gs = mirror["grad_slot"]
            bad_slot = alive & ((gs < 0) | (gs >= alive.shape[0]))
            if bad_slot.any():
                self._record("grad_slot", f"{int(bad_slot.sum())} live rows "
                             "with out-of-range gradient slots")
                bad = bad | bad_slot
        if "num_of_events" in mirror:
            noe = mirror["num_of_events"]
            bad_noe = alive & ((noe <= 0) | (noe > ps.MAX_NUM_EVENTS))
            if bad_noe.any():
                self._record("event_budget", f"{int(bad_noe.sum())} live rows "
                             f"with budgets outside (0, {ps.MAX_NUM_EVENTS}]")
                bad = bad | bad_noe
        if "cur_t" in mirror and "track_id" in mirror:
            cur_t = mirror["cur_t"]
            tid = mirror["track_id"]
            regressed = np.zeros_like(alive)
            for i in np.flatnonzero(alive & (tid >= 0)):
                t_prev = self._last_cur_t.get(int(tid[i]))
                if t_prev is not None and cur_t[i] < t_prev - 1e-6:
                    regressed[i] = True
                self._last_cur_t[int(tid[i])] = float(cur_t[i])
            if regressed.any():
                self._record("time_regression", f"{int(regressed.sum())} "
                             "tracks with backwards solve timestamps")
                bad = bad | regressed
        if "track_id" in mirror and self.params.teleport_px > 0:
            tid = mirror["track_id"]
            jumped = np.zeros_like(alive)
            finite_row = np.all(np.isfinite(center), axis=-1)
            for i in np.flatnonzero(alive & (tid >= 0) & finite_row):
                prev = self._last_center.get(int(tid[i]))
                cx, cy = float(center[i, 0]), float(center[i, 1])
                if prev is not None and np.hypot(
                        cx - prev[0], cy - prev[1]) > self.params.teleport_px:
                    jumped[i] = True
                else:
                    # a flagged row's centre is not stored: the quarantine
                    # kills it, and a re-seeded track gets a new id
                    self._last_center[int(tid[i])] = (cx, cy)
            if jumped.any():
                self._record("teleport", f"{int(jumped.sum())} tracks "
                             f"jumped > {self.params.teleport_px:g} px "
                             "between checks (finite-garbage corruption)")
                bad = bad | jumped
        return bad

    def check_vo(self, vo) -> bool:
        """Validate the VO state: finite active poses and landmarks."""
        ok = True
        for t, kf in vo.active_frames.items():
            if not np.all(np.isfinite(kf.pose)):
                self._record("vo_pose_nonfinite", f"keyframe t={t}")
                ok = False
        for tid, p in vo.map.landmarks.items():
            if not np.all(np.isfinite(p)):
                self._record("vo_landmark_nonfinite", f"track {tid}")
                ok = False
        return ok

    def _record(self, kind: str, detail: str) -> None:
        ev = FailureEvent(self.windows, kind, detail)
        self.failures.append(ev)
        _log.error("watchdog: %s — %s (window %d)", kind, detail, ev.window)

    # -- recovery ----------------------------------------------------------
    def quarantine_patches(self, tracker, bad: np.ndarray,
                           track_id: np.ndarray | None = None) -> None:
        """Kill the bad rows on the device; the rest of the table is left as
        it is. The tracker's lifecycle detects new features on the next
        frame, so tracking degrades for one window instead of dying.

        `track_id` (the mirror's ids) gates the kill on identity: under the
        pipelined drive the mirror that flagged a row can be up to
        `pipeline_depth` windows old, and the row may since have been reused
        for a new, healthy detection; a row whose id on the device is no
        longer the mirror's is left alone."""
        if not bad.any():
            return
        # `bad` and `track_id` are global [P]; under a mesh the tracker's
        # table is this rank's block of rows, and the rank kills its rows
        table = tracker.table
        bad_dev = torch.as_tensor(tracker.local_rows(bad)).to(table.alive.device)
        if track_id is not None:
            bad_dev = bad_dev & (table.track_id == torch.as_tensor(
                tracker.local_rows(track_id)).to(table.track_id.device))
        tracker.table = table.replace(alive=table.alive & ~bad_dev)
        self.recovered_patches += int(bad.sum())

    def drop_bad_landmarks(self, vo) -> int:
        """Remove non-finite landmarks from the map (BA then treats their
        tracks as new observations)."""
        bad = [t for t, p in vo.map.landmarks.items() if not np.all(np.isfinite(p))]
        for t in bad:
            vo.map.landmarks.pop(t, None)
            vo.map.observations.pop(t, None)
        return len(bad)

    # -- evaluator hook ----------------------------------------------------
    def after_window(self, evaluator, mirror: dict | None = None,
                     check_vo: bool = True) -> None:
        """Call once per consumed frame window, on the main thread. With the
        VO worker running, pass `check_vo=False` and queue `vo_check_task` on
        the worker instead: it owns the VO state, and the check must follow
        the keyframes it guards. Under the pipelined drive a quarantine lands
        up to `pipeline_depth` windows after the fault; a NaN row routes no
        events and solves nothing meanwhile, so the delay costs detection
        latency, not spread."""
        self.windows += 1
        if mirror is not None and self.windows % self.params.check_every == 0:
            bad = self.check_mirror(mirror, max_live=evaluator.tracker.params.max_patches)
            if bad.any():
                self.quarantine_patches(evaluator.tracker, bad,
                                        track_id=mirror.get("track_id"))
            if check_vo and evaluator.vo is not None and not self.check_vo(evaluator.vo):
                self.drop_bad_landmarks(evaluator.vo)

    def checkpoint_due(self, frame: int) -> bool:
        """Whether the auto-checkpoint falls due at frame `frame`, counted
        from the dataset's start (so a resumed run keeps the cadence) and at
        dispatch (so the pipelined drive saves every N frames, as the
        synchronous one does)."""
        n = self.params.auto_checkpoint_every
        return n > 0 and frame % n == 0

    def vo_check_task(self, evaluator) -> None:
        """The VO half of `after_window`, run on the VO worker thread, queued
        after the keyframes it validates."""
        if evaluator.vo is not None and not self.check_vo(evaluator.vo):
            self.drop_bad_landmarks(evaluator.vo)

    def summary(self) -> dict:
        return dict(
            windows=self.windows,
            failures=[dataclasses.asdict(f) for f in self.failures],
            recovered_patches=self.recovered_patches,
        )


def auto_resume(path: str, dataset, params=None, device=None):
    """(evaluator, resumed): the state of the auto-checkpoint at `path` when
    there is one, else a new evaluator — the restart entry point."""
    from evo_tpu_torch.run import checkpoint
    from evo_tpu_torch.run.evaluator import Evaluator

    if os.path.exists(path):
        ev = checkpoint.load_checkpoint(path, dataset, params, device=device)
        _log.info("watchdog: resumed from %s at frame %d", path, ev.image_num)
        return ev, True
    return Evaluator(dataset, params, device=device), False
