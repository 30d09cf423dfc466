"""Command-line entry point of the port.

    python -m evo_tpu_torch.run.cli --dataset D --output-dir O

Runs the pipeline on a DAVIS240C dataset directory: the tracker with
compensation (unless --no-compensation) feeding the VO back end, on the
pipelined drive (compensation and VO on worker threads), and writes
trajectory.txt, vo_trajectory.txt and final_cost.txt.
--tracker-experiment freezes detection after 2 frames and runs no VO;
--vo-experiment replays the dataset's trajectory.txt into VO without the
tracker; both take the synchronous drive.

Run-time extras: --checkpoint P writes the state at the end, --resume P
continues from one; --watchdog checks every frame and quarantines corrupted
patches, --auto-checkpoint-every N also saves O/autockpt.npz every N
frames (without --output-dir, O is a new temporary directory, whose path
is logged); --profile-dir D writes a profiler trace of the run; --viz
writes the debug views and --dump-images the compensated event image as
PNGs. --temporal-batch N solves the compensation windows N at a time
(`dist.temporal`).
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="evo_tpu_torch event-based visual odometry")
    ap.add_argument("--dataset", required=True, help="DAVIS240C dataset directory")
    ap.add_argument("--output-dir", default=None,
                    help="artifact directory (default: a new temporary directory)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--tracker-experiment", action="store_true",
                    help="freeze detection after 2 frames (feature-age study)")
    ap.add_argument("--vo-experiment", action="store_true",
                    help="bypass the tracker and replay trajectory.txt into VO")
    ap.add_argument("--no-compensation", action="store_true",
                    help="skip whole-image contrast compensation")
    ap.add_argument("--dump-images", action="store_true",
                    help="write the compensated event image as a PNG to the output dir")
    ap.add_argument("--compensation-mode", choices=("contrast", "tracks"),
                    default="contrast",
                    help="contrast: per-tile edge maximization; tracks: dense "
                         "field interpolated from the feature tracks")
    ap.add_argument("--checkpoint", default=None,
                    help="write a checkpoint .npz here when done")
    ap.add_argument("--resume", default=None, help="resume from a checkpoint .npz")
    ap.add_argument("--viz", action="store_true",
                    help="render the trajectory plot, the 3D scene and the patch debug views")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the run into this directory")
    ap.add_argument("--watchdog", action="store_true",
                    help="failure detection and recovery (run.watchdog)")
    ap.add_argument("--auto-checkpoint-every", type=int, default=0,
                    help="frames between the watchdog's auto-checkpoints (0: off)")
    ap.add_argument("--no-async-vo", action="store_true",
                    help="process VO keyframes inline instead of on the VO "
                         "worker thread")
    ap.add_argument("--temporal-batch", type=int, default=0,
                    help="solve this many compensation windows together on the "
                         "compensation worker (0: each window as it closes)")
    ap.add_argument("--pipeline-depth", type=int, default=8,
                    help="frame windows in flight before the host consumes the "
                         "oldest")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when present, else cpu)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname).1s %(name)s: %(message)s",
    )
    out_dir = args.output_dir
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="evo_tpu_torch_")
        logging.getLogger(__name__).info("no --output-dir given: writing to %s", out_dir)

    from evo_tpu_torch.io.davis import Davis240cDataset
    from evo_tpu_torch.io.png import write_png
    from evo_tpu_torch.run import checkpoint, metrics, viz
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.run.watchdog import WatchdogParams

    t0 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    dataset = Davis240cDataset(args.dataset)
    params = EvaluatorParams(
        output_dir=out_dir,
        tracker_experiment=args.tracker_experiment,
        vo_experiment=args.vo_experiment,
        run_compensation=not args.no_compensation,
        compensation_mode=args.compensation_mode,
        watchdog=args.watchdog or args.auto_checkpoint_every > 0,
        pipeline_depth=args.pipeline_depth,
        async_vo=not args.no_async_vo,
        temporal_batch=args.temporal_batch,
    )
    if args.auto_checkpoint_every > 0:
        # saved as autockpt.npz in the output dir
        params.watchdog_params = WatchdogParams(
            auto_checkpoint_every=args.auto_checkpoint_every)
    if args.resume:
        ev = checkpoint.load_checkpoint(args.resume, dataset, params, device=args.device)
    else:
        ev = Evaluator(dataset, params, device=args.device)
    start = ev.image_num
    prof = (metrics.profile_trace(args.profile_dir) if args.profile_dir
            else contextlib.nullcontext())
    with prof:
        ev.run(max_frames=args.max_frames, start_frame=start)
    paths = ev.finish()
    if args.profile_dir:
        paths["profile"] = os.path.join(args.profile_dir, "trace.json")
    if args.checkpoint:
        paths["checkpoint"] = checkpoint.save_checkpoint(args.checkpoint, ev)
    if args.viz:
        if ev.vo is not None:
            for name, fn in (("trajectory_plot", viz.plot_trajectories),
                             ("scene_3d", viz.render_scene_3d)):
                p = fn(os.path.join(out_dir, f"{name}.png"), ev.vo)
                if p:
                    paths[name] = p
        if ev.tracker.host_mirror()["alive"].any():
            paths.update(viz.save_patch_views(out_dir, ev.tracker))
    dt = time.perf_counter() - t0
    if args.dump_images and ev.compensated_image is not None:
        img = ev.compensated_image
        norm = (255 * img / max(1e-9, img.max())).astype("uint8")
        paths["compensated_image"] = write_png(
            os.path.join(out_dir, "compensated_event_image.png"), norm)

    n_ev = len(dataset.events)
    print(f"processed {n_ev} events, {ev.image_num} frames in {dt:.1f}s "
          f"on {ev.device} ({n_ev / max(dt, 1e-9) / 1e6:.2f} Mev/s end-to-end)")
    for name, path in paths.items():
        print(f"  {name}: {path}")
    if ev.vo is not None and ev.vo.last_ate is not None:
        a = ev.vo.last_ate
        print(f"  ATE rmse={a.rmse:.4f} mean={a.mean:.4f} max={a.max:.4f} (n={a.count})")
    if ev.monitor is not None:
        print(f"  watchdog: {ev.monitor.summary()}")
    print(f"  metrics: {ev.counters.summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
