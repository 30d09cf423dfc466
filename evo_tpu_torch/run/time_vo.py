"""VO's seconds on one CUDA card and whether it repeats itself, for one tree.

    python evo_tpu_torch/run/time_vo.py [--root DIR] [--frames N] [--reps R]

Simulates `chip_smoke.py`'s scene (`3walls`, 1.2 s at 20 fps, seed 3) with
the `evo_tpu_torch` package found under DIR (default: the tree this file is
in), runs the standard mode's synchronous drive on the card over its first N
frames once, keeping the keyframe candidates the tracker hands to VO, and
then feeds those candidates to R new front ends on the card, one after
another. For each run it prints VO's wall seconds (ending in a
synchronize), the BA calls and iterations, the ATE, and whether the
keyframe poses equal the first run's bit for bit (else the largest
difference). It also runs VO once more under
`torch.use_deterministic_algorithms(True, warn_only=True)` and lists the
warnings PyTorch gives there for operations without a deterministic
implementation (a `torch.histc` on the card goes first, to show that a
warning is caught), and sums [2048, 6, 6] blocks into 21 slots 30 times with
`index_add_`, with `index_put_(accumulate=True)` and, where the tree has it,
with `vo.ba.observation_sums`: how many distinct results each gave, and
whether they equal the CPU's `index_add_`. Only
names that every version of the port since VO has are used otherwise, so
two trees can be compared in one call on one card: unpack the other commit
somewhere and run this file once per tree, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SCENE = dict(duration_s=1.2, fps=20.0, seed=3, scene="3walls", contrast_threshold=0.05)


def record_candidates(dataset, frames: int, dev) -> list:
    """The synchronous standard mode over `frames` frames on `dev`; the
    (t_us, {track: (x, y)}) candidates VO was handed, in order."""
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    with tempfile.TemporaryDirectory() as tmp:
        ev = Evaluator(dataset, EvaluatorParams(pipelined=False, output_dir=tmp), device=dev)
        kept = []
        inner = ev.vo.new_keyframe_candidate

        def recording(kf):
            kept.append((int(kf.t_us), {int(t): np.array(p) for t, p in kf.landmarks.items()}))
            return inner(kf)

        ev.vo.new_keyframe_candidate = recording
        ev.run(max_frames=frames)
        ev.finish()
    return kept


def run_vo(dataset, candidates: list, dev) -> dict:
    """A new front end on `dev` fed `candidates`: its poses, ATE, BA log
    and wall seconds."""
    from evo_tpu_torch.vo.frontend import VisualOdometryFrontEnd
    from evo_tpu_torch.vo.keyframe import Keyframe

    vo = VisualOdometryFrontEnd(dataset.calib, device=dev)
    vo.set_ground_truth(dataset.gt_t_us, dataset.gt_poses)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t_us, lms in candidates:
        vo.new_keyframe_candidate(Keyframe(t_us=t_us, landmarks={
            t: p.copy() for t, p in lms.items()}))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    iters = [it for it, *_ in vo.ba_log]
    return dict(poses=np.stack(vo.poses()), vo_s=wall, ba_calls=len(iters),
                ba_iterations=int(sum(iters)),
                ate=None if vo.last_ate is None else float(vo.last_ate.rmse))


def sum_repeats(dev, reps: int = 30) -> dict:
    """[2048, 6, 6] blocks summed into 21 slots `reps` times on `dev` by
    `index_add_`, by `index_put_(accumulate=True)` and by the tree's
    `observation_sums` (where it has one): distinct results, and whether the
    first equals the CPU's `index_add_`."""
    from evo_tpu_torch.vo import ba

    rng = np.random.default_rng(0)
    n, slots = 2048, 21
    idx = torch.tensor(np.sort(rng.integers(0, slots, n)))
    vals = torch.tensor((rng.standard_normal((n, 6, 6))
                         * 10.0 ** rng.uniform(-3, 3, (n, 1, 1))).astype(np.float32))
    want = torch.zeros(slots, 6, 6).index_add_(0, idx, vals)
    i_d, v_d = idx.to(dev), vals.to(dev)
    ways = {"index_add_": lambda: torch.zeros(slots, 6, 6, device=dev).index_add_(0, i_d, v_d),
            "index_put_": lambda: torch.zeros(slots, 6, 6, device=dev).index_put_(
                (i_d,), v_d, accumulate=True)}
    if hasattr(ba, "observation_sums"):
        by_frame = ba.observation_sums(i_d, torch.zeros_like(i_d), slots, 1)[0]
        ways["observation_sums"] = lambda: by_frame(v_d)
    out = {}
    for name, fn in ways.items():
        got = [fn().cpu() for _ in range(reps)]
        out[name] = dict(distinct=len({g.numpy().tobytes() for g in got}),
                         equal_to_cpu=bool(torch.equal(got[0], want)),
                         max_diff_to_cpu=max(float((g - want).abs().max()) for g in got))
    return out


def deterministic_listing(dataset, candidates: list, dev) -> dict:
    """One VO run under `torch.use_deterministic_algorithms(True,
    warn_only=True)`: the first line of every warning, a `torch.histc` on
    the card first (an operation PyTorch has no deterministic form of)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            torch.histc(torch.rand(64, device=dev))
            run_vo(dataset, candidates, dev)
        finally:
            torch.use_deterministic_algorithms(False)
    return dict(warnings=sorted({str(w.message).splitlines()[0][:200] for w in caught}))


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="directory that holds the evo_tpu_torch package to time")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_vo: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.time_splat import card

    dev = torch.device("cuda")
    dataset = sim.to_dataset(sim.EventCameraSimulator(sim.SimParams(**SCENE),
                                                      device=dev).generate())
    candidates = record_candidates(dataset, args.frames, dev)
    runs = [run_vo(dataset, candidates, dev) for _ in range(args.reps + 1)][1:]  # 1 warm-up
    first = runs[0]["poses"]

    def apart(p):
        return float(np.abs(p - first).max()) if p.shape == first.shape else float("inf")

    rows = [dict(vo_s=r["vo_s"], ba_calls=r["ba_calls"], ba_iterations=r["ba_iterations"],
                 ate=r["ate"], keyframes=len(r["poses"]),
                 bitwise=bool(r["poses"].shape == first.shape and (r["poses"] == first).all()),
                 max_pose_diff=apart(r["poses"])) for r in runs]
    out = dict(card=card(), frames=args.frames, candidates=len(candidates), runs=rows,
               sums=sum_repeats(dev),
               deterministic_mode=deterministic_listing(dataset, candidates, dev))
    print(f"time_vo {args.root}: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
