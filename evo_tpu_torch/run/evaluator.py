"""Evaluator — the pipeline's drive loop wiring tracker -> VO, counterpart of
`evo_tpu/run/evaluator.py`.

Two drives produce the same artifacts:

- the synchronous one (`pipelined=False`, and every experiment mode): frame
  window by frame window, the window's events feed the tracker and a
  whole-image compensation runs every `compensation_time_us` or
  `compensation_events` events, warm-started from the previous window's
  field; then the frame runs detection, and from the 3rd frame on the live
  patch centres become a VO keyframe candidate, processed inline;
- the pipelined one (the default in the standard mode): one
  `EventTracker.process_frame_window` per frame window on the main thread,
  whose logs are consumed up to `pipeline_depth` windows later; contrast
  compensation on the `evo-comp` worker thread and VO keyframes on the
  `evo-vo` worker thread, each on a CUDA stream of its own. VO and the
  compensated image only consume tracker state, so deferring them changes
  nothing in the artifacts.

Experiment modes: `tracker_experiment` freezes detection after 2 frames and
runs no VO; `vo_experiment` bypasses the tracker and replays the dataset's
stored per-timestamp tracks into VO. Artifacts are written by `finish()`,
which first drains and stops the workers; an exception raised on a worker
thread is raised again by `run()` or `finish()`.

With `watchdog`, a `run.watchdog.HealthMonitor` checks each frame's mirror
(and the VO state, on the thread that owns it), and every
`auto_checkpoint_every` frames the evaluator saves a checkpoint. Under the
pipelined drive it is saved right after the frame's dispatch, and saving
first consumes every window in flight and reads every compensation window,
so that it holds the state of every frame it counts: the JAX package saves
it with up to `pipeline_depth` windows dispatched and not yet logged, and a
run resumed from it never writes their track entries. `run(start_frame=)`
resumes from a checkpoint (`run.checkpoint`). Without an `output_dir` the
artifacts and auto-checkpoints go to a new temporary directory of the run's
own, whose path is logged (the JAX package writes them to `/tmp`, which
every run of the machine shares).

With `temporal_batch` N > 0 the contrast windows are buffered and solved N
at a time, cold, on the evo-comp worker (`dist.temporal`, one fused splat
launch over all N windows' tiles per LM iteration), on either drive; the
remainder is solved at `flush_pending`. Each window's result is that of its
cold solve alone. Every batch's future is read, so a failed batch ends
`run()`.

With `mesh` (a `dist.mesh.make_mesh` mesh over the ranks of an initialised
process group, `dist.multihost.initialize`) every rank runs the same
evaluator over the same dataset: the tracker holds its block of the patch
table's rows (`EventTracker(mesh=)`), the contrast windows' tile columns are
solved over ``space`` (`compensate_window(mesh=)`) and temporal batches'
windows over ``batch`` (`compensate_windows_batched(mesh=)`), on either
drive, with the artifacts of the unmeshed run; each rank writes them into
its own `output_dir`. Compensation runs on a fork of the mesh
(`dist.mesh.fork_mesh`), process groups of its own, so the evo-comp thread's
collectives never share a communicator with the tracker's on the main
thread. The two threads still issue them concurrently, in an order that may
differ from rank to rank. That is shown safe on gloo ranks and on one NCCL
rank; over more than one NCCL rank, where NCCL documents that communicators
driven concurrently can deadlock, the evaluator refuses compensation on the
worker (`_check_collective_threads`): pass `pipelined=False` and
`temporal_batch=0` there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from evo_tpu_torch.core import device as _device
from evo_tpu_torch.io.replay import FrameWindowIterator
from evo_tpu_torch.run import artifacts
from evo_tpu_torch.run.metrics import Counters, nan_canary_scope, stream_sync
from evo_tpu_torch.tracker import compensate as comp
from evo_tpu_torch.tracker import motion_field as mf
from evo_tpu_torch.tracker.detector import EventTracker, TrackerParams
from evo_tpu_torch.vo.frontend import VisualOdometryFrontEnd, VoParams
from evo_tpu_torch.vo.keyframe import Keyframe

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class EvaluatorParams:
    """The JAX package's EvaluatorParams, with the same names and defaults,
    but for `output_dir`."""

    # the artifacts' directory; None: a new temporary directory of the run's
    # own (the JAX package's default is the shared /tmp)
    output_dir: str | None = None
    compensation_time_us: int = 300_000
    compensation_events: int = 15_000
    tracker_experiment: bool = False
    vo_experiment: bool = False
    run_compensation: bool = True
    # "contrast": per-tile edge maximization (tracker.compensate);
    # "tracks": dense field interpolated from the feature tracks
    # (tracker.motion_field)
    compensation_mode: str = "contrast"
    # a (space, batch) `dist.mesh.make_mesh` mesh: the patch table's rows
    # split over all its ranks, the contrast tile solve's columns over
    # ``space``, temporal batches' windows over ``batch`` (module docstring)
    mesh: object = None
    # the pipelined drive (standard mode only; see the module docstring)
    pipelined: bool = True
    # at most this many frame windows dispatched and not yet consumed: host
    # bookkeeping and VO lag the tracker by at most that many windows, and
    # consume them strictly in order
    pipeline_depth: int = 8
    # VO keyframes on a worker thread (pipelined drive only), in order, so
    # the result equals the inline one
    async_vo: bool = True
    # buffer this many contrast compensation windows and solve them together
    # (dist.temporal.compensate_windows_batched), cold, on the evo-comp
    # worker; 0: each window as it closes, warm-started from the one before
    temporal_batch: int = 0
    # failure detection and recovery (run.watchdog): invariant checks on the
    # mirrors the pipeline pulls anyway, quarantine, auto-checkpoints
    watchdog: bool = False
    watchdog_params: object = None  # run.watchdog.WatchdogParams
    tracker: TrackerParams = dataclasses.field(default_factory=TrackerParams)
    vo: VoParams = dataclasses.field(default_factory=VoParams)
    compensate: comp.CompensateParams = dataclasses.field(
        default_factory=comp.CompensateParams
    )


class Evaluator:
    @property
    def output_dir(self) -> str:
        """`params.output_dir`, or else a new temporary directory, made (and
        logged) when the run first writes there."""
        if self._output_dir is None:
            self._output_dir = tempfile.mkdtemp(prefix="evo_tpu_torch_")
            _log.info("no output_dir given: writing to %s", self._output_dir)
        return self._output_dir

    def __init__(self, dataset, params: EvaluatorParams | None = None, device=None):
        self.params = params or EvaluatorParams()
        if self.params.compensation_mode not in ("contrast", "tracks"):
            raise ValueError(f"unknown compensation mode {self.params.compensation_mode!r}")
        self.device = _device.resolve(device)
        self._output_dir = self.params.output_dir
        self.dataset = dataset
        self.height = dataset.calib.height if dataset.calib else 180
        self.width = dataset.calib.width if dataset.calib else 240
        self.pipelined = (self.params.pipelined and not self.params.vo_experiment
                          and not self.params.tracker_experiment)
        if self.params.mesh is not None:
            mesh = self.params.mesh
            _check_collective_threads(
                dist.get_backend(mesh.get_group(0)), mesh.mesh.numel(),
                self.params.run_compensation
                and self.params.compensation_mode == "contrast"
                and (self.pipelined or self.params.temporal_batch > 0))
        self.tracker = EventTracker(self.params.tracker, self.height, self.width,
                                    device=self.device, mesh=self.params.mesh)
        # compensation's own process groups (see the module docstring)
        self._comp_mesh = None
        if self.params.mesh is not None:
            from evo_tpu_torch.dist.mesh import fork_mesh

            self._comp_mesh = fork_mesh(self.params.mesh)
        self.vo = (
            VisualOdometryFrontEnd(dataset.calib, self.params.vo, device=self.device)
            if dataset.calib is not None
            else None
        )
        if self.vo is not None and len(dataset.gt_t_us):
            self.vo.set_ground_truth(dataset.gt_t_us, dataset.gt_poses)
        self.image_num = 0
        self.counters = Counters()
        self._sync = stream_sync(self.device)
        self.monitor = None
        if self.params.watchdog:
            from evo_tpu_torch.run.watchdog import HealthMonitor

            self.monitor = HealthMonitor(self.params.watchdog_params)
        self._buf: list[np.ndarray] = []
        self._buf_count = 0
        self._last_compensation_us: int | None = None
        self.compensated_image: np.ndarray | None = None
        self.motion_field: np.ndarray | None = None
        # the previous window's solved field: host numpy in the synchronous
        # drive, a device tensor owned by the evo-comp thread in the other
        self._comp_warm_vel = None
        # (cost, initial cost) of every contrast window solved and read back
        self.compensation_costs: list[tuple[float, float]] = []
        # pipelined drive: (frame number, t_us, handle) of the windows in
        # flight, and the futures of the compensation windows not yet read
        self._pending_frames: list = []
        self._pending_comp: list = []
        # temporal batching: the (x, y, t_us) windows waiting for their batch
        self._comp_windows: list = []
        self._comp_executor: ThreadPoolExecutor | None = None
        self._comp_stream = None
        self._vo_queue: queue.Queue | None = None
        self._vo_thread: threading.Thread | None = None
        self._vo_error: BaseException | None = None
        # VO-experiment replay store: t_us -> {track_id: (x, y)}
        self._stored_tracks: dict[int, dict[int, np.ndarray]] = {}
        if self.params.vo_experiment and dataset.trajectory:
            for tid, (t_us_arr, xy) in dataset.trajectory.items():
                for t, p in zip(t_us_arr, xy):
                    self._stored_tracks.setdefault(int(t), {})[tid] = p

    # -- event path ------------------------------------------------------
    def process_events(self, t_us: np.ndarray, x, y, pol) -> None:
        if len(t_us) == 0:
            return
        self.counters.add("events", len(t_us))
        if not self.params.vo_experiment:
            n0 = len(self.tracker.final_cost_log)
            with self.counters.timed("tracker_events", self._sync):
                self.tracker.process_events(t_us, x, y, pol)
            self.counters.add("solves", len(self.tracker.final_cost_log) - n0)
        if self.params.run_compensation:
            self._buffer_for_compensation(t_us, x, y, pol)

    def _buffer_for_compensation(self, t_us, x, y, pol, defer: bool = False) -> None:
        """Append a window's events to the compensation buffer and run (or,
        with `defer`, hand to the worker) every compensation window due."""
        stage, sync = ("compensation_dispatch", None) if defer else (
            "compensation", self._sync)
        if self._last_compensation_us is None:
            self._last_compensation_us = int(t_us[0])
        self._buf.append(np.stack([t_us, x, y, pol], axis=-1))
        self._buf_count += len(t_us)
        while self._buf_count and (
            int(t_us[-1]) - self._last_compensation_us >= self.params.compensation_time_us
            or self._buf_count >= self.params.compensation_events
        ):
            with self.counters.timed(stage, sync):
                self._run_compensation(defer=defer)

    def _run_compensation(self, defer: bool = False) -> None:
        buf = self._buf[0] if len(self._buf) == 1 else np.concatenate(self._buf, axis=0)
        ev = buf[: self.params.compensation_events]
        rest = buf[self.params.compensation_events:]
        self._buf = [rest] if len(rest) else []
        self._buf_count = len(rest)
        self._last_compensation_us = int(ev[-1, 0])
        if len(ev) < self.params.compensate.min_events:
            return
        xs = ev[:, 1].astype(np.float64)
        ys = ev[:, 2].astype(np.float64)
        ts = ev[:, 0].astype(np.int64)
        if self.params.compensation_mode == "tracks":
            self.motion_field, self.compensated_image = mf.compensate_from_tracks(
                self.tracker.trajectories, xs, ys, ts,
                height=self.height, width=self.width, device=self.device)
            self.counters.add("compensation_windows")
            _log.info("track-field compensated %d events", len(ev))
            return
        if self.params.temporal_batch > 0:
            self._comp_windows.append((xs, ys, ts))
            if len(self._comp_windows) >= self.params.temporal_batch:
                self._flush_temporal_batch()
            return
        if defer:
            self._submit_compensation(xs, ys, ts)
            return
        field, img, cost, cost0 = comp.compensate_window(
            xs, ys, ts, self.params.compensate, height=self.height,
            width=self.width, v_init=self._comp_warm_vel, device=self.device,
            mesh=self._comp_mesh)
        self._comp_warm_vel = field.reshape(-1, 2)
        self._take_compensation(field, img, cost, cost0)
        self.counters.add("compensation_windows")

    def _take_compensation(self, field, img, cost, cost0) -> None:
        self.motion_field = field
        self.compensated_image = img
        self.compensation_costs.append((cost, cost0))
        _log.info("compensated window (cost %.1f -> %.1f)", cost0, cost)

    def _flush_temporal_batch(self) -> None:
        """Hand the buffered windows to the evo-comp worker as one batch."""
        from evo_tpu_torch.dist import temporal

        wins, self._comp_windows = self._comp_windows, []

        def run_batch():
            with _on_stream(self._comp_stream), nan_canary_scope():
                with self.counters.timed("compensation_batched", stream_sync(self.device)):
                    results = temporal.compensate_windows_batched(
                        wins, self.params.compensate, height=self.height,
                        width=self.width, mesh=self._comp_mesh, device=self.device)
            self.counters.add("compensation_windows", len(results))
            return results

        self._submit(run_batch)

    def _submit(self, fn) -> None:
        """Run `fn` on the evo-comp worker thread. Its future resolves to a
        `DeferredWindow` or to a batch's list of results; finished ones are
        read as the run goes, all but the newest, so a failed solve surfaces
        at the next dispatch."""
        if self._comp_executor is None:
            self._comp_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="evo-comp",
                initializer=self._init_comp_worker)
        while len(self._pending_comp) > 1 and self._pending_comp[0].done():
            self._take_future(self._pending_comp.pop(0))
        self._pending_comp.append(self._comp_executor.submit(fn))

    def _take_future(self, fut) -> None:
        out = fut.result()
        for window in out if isinstance(out, list) else [out.get()]:
            self._take_compensation(*window)

    def _submit_compensation(self, xs, ys, ts) -> None:
        """Solve a window on the evo-comp worker thread: tile bucketing, the
        uploads and the LM's dispatch all leave the main thread, and nothing
        on the tracker's path reads the result (it is read at the flush)."""
        def run_deferred():
            # worker-only state: the previous window's field, still on the
            # device, is this solve's warm start (one worker thread, so
            # windows are solved in order and nothing races)
            with _on_stream(self._comp_stream), nan_canary_scope():
                with self.counters.timed("compensation_worker",
                                         stream_sync(self.device)):
                    out = comp.compensate_window(
                        xs, ys, ts, self.params.compensate, height=self.height,
                        width=self.width, v_init=self._comp_warm_vel,
                        device=self.device, defer=True, mesh=self._comp_mesh)
            self._comp_warm_vel = out.vel_dev
            self.counters.add("compensation_windows")
            return out

        self._submit(run_deferred)

    def _init_comp_worker(self) -> None:
        """Runs on the evo-comp thread at its start: its stream."""
        self._comp_stream = _worker_stream(self.device)

    # -- frame path ------------------------------------------------------
    def process_image(self, t_us: int, image: np.ndarray) -> None:
        self.image_num += 1
        self.counters.add("frames")
        # the tracker experiment freezes detection after 2 frames
        # (feature-age protocol) and runs no VO
        frozen = self.params.tracker_experiment and self.image_num > 2
        if not frozen and not self.params.vo_experiment:
            with self.counters.timed("frames", self._sync):
                self.tracker.new_image(t_us, image)
        if not frozen and self.image_num > 2 and self.vo is not None:
            lms = self._live_landmarks(t_us)
            if lms:
                with self.counters.timed("vo", self._sync):
                    self.vo.new_keyframe_candidate(
                        Keyframe(t_us=int(t_us), landmarks=lms))
        if self.monitor is not None and not self.params.vo_experiment:
            # as in the JAX package, the tracker experiment checks the
            # frame-2 mirror again from frame 3 on (ROADMAP §C)
            self.monitor.after_window(self, self.tracker.last_mirror)
            self._auto_checkpoint()

    def _live_landmarks(self, t_us: int) -> dict[int, np.ndarray]:
        """The keyframe's observations: the stored tracks at this timestamp
        in the VO experiment, else the live patch centres (float64) of the
        mirror `new_image` just read."""
        if self.params.vo_experiment:
            return dict(self._stored_tracks.get(int(t_us), {}))
        return _landmarks_of(self.tracker.last_mirror)

    # -- pipelined drive ---------------------------------------------------
    def _process_window_pipelined(self, win) -> None:
        """One frame window, dispatch first: this window's tracker step is
        queued before older windows' logs are consumed, so the device works
        on window k while the host does the bookkeeping and the VO hand-over
        of the windows before it."""
        ev = win.events
        x, y, pol = (a.astype(np.float64) for a in (ev.x, ev.y, ev.p))
        self.counters.add("events", len(ev.t_us))
        self.counters.add("frames")
        with self.counters.timed("tracker_window"):
            t_us, handle = self.tracker.process_frame_window(
                ev.t_us, x, y, pol, win.image_t_us, win.image)
        self.image_num += 1
        self._pending_frames.append((self.image_num, t_us, handle))
        depth = max(1, self.params.pipeline_depth)
        if len(self._pending_frames) > depth:
            self._consume_frames(len(self._pending_frames) - depth)
        if self.params.run_compensation and len(ev.t_us):
            self._buffer_for_compensation(ev.t_us, x, y, pol, defer=True)
        self._auto_checkpoint()

    def _auto_checkpoint(self) -> None:
        """Save the watchdog's auto-checkpoint when one falls due at this
        frame; saving consumes the windows in flight first
        (`run.checkpoint.state_dict`)."""
        if self.monitor is None or not self.monitor.checkpoint_due(self.image_num):
            return
        from evo_tpu_torch.run import checkpoint

        path = self.monitor.params.checkpoint_path or os.path.join(
            self.output_dir, "autockpt.npz")
        checkpoint.save_checkpoint(path, self)

    def flush_pending(self, comp: bool = True) -> None:
        """Consume what is in flight: with `comp`, the windows buffered for a
        temporal batch (handed to the worker as one) and every pending
        compensation window or batch (each future's result is read, so one
        that failed on the worker raises here; the newest window's field and
        image stay), then the frame windows not yet consumed."""
        if comp and self._comp_windows:
            self._flush_temporal_batch()
        if comp and self._pending_comp:
            pending, self._pending_comp = self._pending_comp, []
            with self.counters.timed("compensation_consume"):
                for fut in pending:
                    self._take_future(fut)
        if self._pending_frames:
            self._consume_frames(len(self._pending_frames))

    def _consume_frames(self, n: int) -> None:
        """Consume the n oldest frame windows in flight: the tracker's
        bookkeeping, then each window's VO keyframe, in order."""
        batch = self._pending_frames[:n]
        self._pending_frames = self._pending_frames[n:]
        n0 = len(self.tracker.final_cost_log)
        with self.counters.timed("frame_consume"):
            mirrors = self.tracker.consume_frames(
                [(t_us, handle) for (_, t_us, handle) in batch])
        # the solve log lands at consume time, not at dispatch time
        self.counters.add("solves", len(self.tracker.final_cost_log) - n0)
        vo_async = self.params.async_vo and self.vo is not None
        submitted = False
        for (frame_no, t_us, _), mirror in zip(batch, mirrors):
            if self.monitor is not None:
                # the tracker's checks here (this thread owns the table); the
                # VO checks follow the keyframes on the VO worker when async
                self.monitor.after_window(self, mirror, check_vo=not vo_async)
            if frame_no > 2 and self.vo is not None:
                lms = _landmarks_of(mirror)
                if lms:
                    self._vo_submit(int(t_us), lms)
                    submitted = True
        if self.monitor is not None and vo_async and submitted:
            self._vo_enqueue(("vo_check",))

    def _vo_submit(self, t_us: int, lms: dict) -> None:
        """Process a keyframe candidate inline, or hand it to the VO worker
        thread (`async_vo`), where VO's solves overlap the tracker's."""
        self._raise_vo_error()
        if not self.params.async_vo:
            with self.counters.timed("vo"):
                self.vo.new_keyframe_candidate(Keyframe(t_us=t_us, landmarks=lms))
            return
        self._vo_enqueue(("kf", t_us, lms))

    def _vo_enqueue(self, item: tuple) -> None:
        """Queue an item for the VO worker, starting it first if needed:
        ("kf", t_us, landmarks), a keyframe candidate, or ("vo_check",), the
        watchdog's VO check."""
        if self._vo_thread is None:
            self._vo_queue = queue.Queue()
            self._vo_thread = threading.Thread(
                target=self._vo_worker, args=(self._vo_queue,), daemon=True,
                name="evo-vo")
            self._vo_thread.start()
        self._vo_queue.put(item)

    def _vo_worker(self, q: queue.Queue) -> None:
        """The evo-vo thread: its items in FIFO order on its own stream, until
        a None arrives. The first exception is kept for the main thread."""
        with _on_stream(_worker_stream(self.device)), nan_canary_scope():
            while True:
                item = q.get()
                try:
                    if item is None:
                        return
                    if item[0] == "vo_check":
                        self.monitor.vo_check_task(self)
                        continue
                    with self.counters.timed("vo", stream_sync(self.device)):
                        self.vo.new_keyframe_candidate(
                            Keyframe(t_us=item[1], landmarks=item[2]))
                except Exception as e:  # raised again by _raise_vo_error
                    if self._vo_error is None:
                        self._vo_error = e
                finally:
                    q.task_done()

    def _raise_vo_error(self) -> None:
        if self._vo_error is not None:
            err, self._vo_error = self._vo_error, None
            raise err

    def sync_vo(self) -> None:
        """Wait until the VO worker has processed every keyframe handed to it
        (nothing to wait for inline). Comes before any read of VO state."""
        if self._vo_queue is not None:
            self._vo_queue.join()
        self._raise_vo_error()

    def stop_workers(self) -> None:
        """End both worker threads. Compensation windows not yet started are
        dropped; keyframes already queued are still processed."""
        if self._comp_executor is not None:
            self._comp_executor.shutdown(wait=True, cancel_futures=True)
            self._comp_executor = None
        if self._vo_thread is not None:
            self._vo_queue.put(None)
            self._vo_thread.join()
            self._vo_thread = None

    # -- drive -----------------------------------------------------------
    def run(self, max_frames: int | None = None, start_frame: int = 0) -> None:
        """Replay the dataset frame window by frame window, from window
        `start_frame` (a resumed run passes the restored `image_num`) up to
        `max_frames`."""
        try:
            for win in FrameWindowIterator(self.dataset):
                if win.frame_idx < start_frame:
                    continue
                if max_frames is not None and win.frame_idx >= max_frames:
                    break
                if self.pipelined:
                    self._process_window_pipelined(win)
                    continue
                ev = win.events
                self.process_events(
                    ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
                    ev.p.astype(np.float64),
                )
                self.process_image(win.image_t_us, win.image)
            if self.pipelined or self.params.temporal_batch > 0:
                # (the synchronous drive has something in flight only with
                # temporal batching)
                self.flush_pending()
                self.sync_vo()
        except BaseException:
            self.stop_workers()
            raise

    def finish(self) -> dict[str, str]:
        """Drain and stop the workers, then write the artifacts; returns
        {name: path}."""
        try:
            self.flush_pending()
            self.sync_vo()
        finally:
            self.stop_workers()
        out = {"trajectory": artifacts.save_features_trajectory(
            self.output_dir, self.tracker.trajectories)}
        if self.vo is not None:
            out["vo_trajectory"] = artifacts.save_poses(self.output_dir, self.vo.poses())
        out["final_cost"] = artifacts.save_final_costs(
            self.output_dir, self.tracker.final_cost_log)
        return out


def _check_collective_threads(backend: str, n_ranks: int, comp_on_worker: bool) -> None:
    """Refuse contrast compensation on the evo-comp thread over more than one
    NCCL rank: its collectives and the tracker's on the main thread run on
    two communicators at once, in an order that may differ between ranks,
    which NCCL documents can deadlock. Gloo ranks and one NCCL rank run it."""
    if comp_on_worker and backend == "nccl" and n_ranks > 1:
        raise ValueError(
            f"a mesh of {n_ranks} NCCL ranks runs compensation on the main thread "
            "only: pass EvaluatorParams(pipelined=False, temporal_batch=0)")


def _landmarks_of(mirror: dict) -> dict[int, np.ndarray]:
    """{track id: centre (float64)} of a mirror's live patches whose centre
    is finite (a corrupted row is no observation)."""
    centers64 = mirror["center"].astype(np.float64)
    tids = mirror["track_id"]
    ok = mirror["alive"] & np.isfinite(centers64).all(-1)
    return {int(tids[i]): centers64[i] for i in np.flatnonzero(ok)}


def _worker_stream(device):
    """A new CUDA stream for the calling worker thread, ordered after the work
    already queued on the device's default stream; None on the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.default_stream(device))
    return stream


def _on_stream(stream):
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)
