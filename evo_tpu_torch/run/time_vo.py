"""VO's seconds on one CUDA card and whether it repeats itself, for one tree;
and VO's two kernels held to their plain versions and timed.

    python evo_tpu_torch/run/time_vo.py [--root DIR] [--frames N] [--reps R]
    python evo_tpu_torch/run/time_vo.py [--root DIR] --kernels [--frames N]
    python evo_tpu_torch/run/time_vo.py --drive-clusters C [C ...] [--reps R]
        [--drive-modes default sync]

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
somewhere and run this file once per tree, in turns. Each run's row carries
VO's seconds by geometric stage (`stage_s`) and, where the tree has them,
the launches of VO's kernels.

`--kernels` records the arguments of every localization and BA call of the
synchronous standard mode over the first N frames (`record_solves`) and
holds `kernels.localize` and `kernels.ba_solve` to their plain versions on
the card on the largest recorded call of each (`check_localize`,
`check_ba`, which `chip_smoke.py` phase 3 runs too): device ms a launch over
many launches between one pair of CUDA events behind a busy queue, host µs
a launch, the bound (`time_comp.bound`: the floating-point operations the
call's data needs, counted by `localize_flops` and `ba_flops`, over 67
TFLOP/s, against its bytes over 3.35 TB/s), the plain version's time and,
for the BA, that of `torch.linalg.cholesky_ex` + `torch.cholesky_solve` on
the call's first reduced system (the port never calls them), and, where the
tree has the kernels' clock builds, each one's split by stage
(`clock_localize`, `clock_ba`: the cycles of one launch after 200). Each kernel's
result is held to a float64 witness, the plain version run in float64 from
the same start (`witness_bar`), and `decision_ties` finds the plain BA's
decisions that lie within 2 % of `tol` of their thresholds, the only place
where kernel and plain version may take other trips. Where the tree's BA
runs in a thread-block cluster, it times the largest BA at each cluster
size and checks that every size gives the same bits (`cluster_sizes`).
Last it prints a
SHA-256 of the inputs and outputs of every recorded call run once more
through the tree's kernels (`call_digests`): two trees give equal lists
where their kernels give the same bits.

`--drive-clusters` runs the standard mode's default drive
(`time_comp.run_mode(dataset, "default")`: compensation's kernels on their
own streams beside VO's), and with `--drive-modes default sync` the
synchronous drive too, with the BA launched in clusters of each size C,
after one warm-up run, R rounds of the sizes in turns, each round in the
order of the last reversed (`drives_by_cluster`): one JSON line a run with
its wall, stage and VO stage seconds, so that a cluster that waits for its
SMs behind the concurrent work shows in the `ba` stage.
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
    for m in _vo_kernels():
        m.reset_counts()
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
                ate=None if vo.last_ate is None else float(vo.last_ate.rmse),
                stage_s=dict(vo.stage_s), launches=vo_launches())


def _vo_kernels() -> list:
    """The tree's VO kernel wrappers (none before they were written)."""
    mods = []
    for name in ("localize", "ba_solve"):
        try:
            mods.append(__import__(f"evo_tpu_torch.kernels.{name}", fromlist=[name]))
        except ImportError:
            pass
    return mods


def vo_launches() -> dict:
    """The launches each VO kernel of the tree counts."""
    return {k: v for m in _vo_kernels() for k, v in vars(m).items()
            if k.startswith("launches") and isinstance(v, int)}


# -- the kernels against their plain versions -----------------------------------
R_ULP = 4 * 2.0 ** -24  # a residual 1 - cos near 0 is good to a few ulp of 1
P3P_FLOPS = 6800  # one minimal sample: the grid, 4 roots, back-substitution, triads


def record_solves(dataset, frames: int, dev) -> dict:
    """The synchronous standard mode over `frames` frames on `dev`, keeping a
    copy of the arguments of every localization and BA call VO made:
    {"localize": [(args, kwargs)], "ba": [(args, kwargs)]}."""
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.solve import ransac
    from evo_tpu_torch.vo import ba

    calls = {"localize": [], "ba": []}

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def recording(kind, fn):
        def call(*args, **kw):
            calls[kind].append(([copy(a) for a in args], {k: copy(v) for k, v in kw.items()}))
            return fn(*args, **kw)
        return call

    inner = ransac.localize_camera_fused, ba.ba_solve
    ransac.localize_camera_fused = recording("localize", inner[0])
    ba.ba_solve = recording("ba", inner[1])
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ev = Evaluator(dataset, EvaluatorParams(pipelined=False, output_dir=tmp), device=dev)
            ev.run(max_frames=frames)
            ev.finish()
    finally:
        ransac.localize_camera_fused, ba.ba_solve = inner
    return calls


def localize_flops(n: int, h: int, trips: int) -> float:
    """Floating-point operations of one localization of n points and h
    samples whose refinement took `trips` LM trips: the unprojection (10
    undistortion steps), P3P, each candidate's residual at each point
    (~45), the refinement's linearizations (~126 a point with J^T J) and the
    reselection."""
    return n * 250 + h * P3P_FLOPS + 4 * h * n * 45 + (trips + 1) * n * 126 + n * 45


def ba_flops(obs_frame, obs_lm, mask, F: int, L: int, trips: int, compensated: bool) -> float:
    """Floating-point operations of one BA call of `trips` trips on these
    observations: per trip the linearization and the candidate's float32
    cost (~220 an observation), its float64 cost (~100, counted twice: the
    card's float64 rate is half its float32 rate), the slots' sums (4 for each of the 72 entries an
    observation feeds), T (90 a pair), the Schur product (6 a landmark that
    both frames of an entry see), v, the Cholesky (n^3 / 3) and the solves
    (2 n^2), the back-substitution and the retractions."""
    of, ol = obs_frame.cpu().numpy(), obs_lm.cpu().numpy()
    keep = np.ones(len(of), bool) if compensated else mask.cpu().numpy().astype(bool)
    seen = np.zeros((L, F), bool)
    seen[ol[keep], of[keep]] = True
    pairs = int(seen.sum())
    covis = seen.T.astype(np.int64) @ seen.astype(np.int64)  # [F, F] landmarks seen by both
    n = 6 * F
    schur = 6 * (36 * np.tril(covis, -1).sum() + 21 * np.trace(covis)) + 36 * pairs
    per_trip = (len(of) * (220 + 200 + 72 * 4) + pairs * (90 + 36) + schur + n ** 3 / 3
                + 2 * n ** 2 + L * 30 + F * 120)
    return float(trips * per_trip + len(of) * 60)


# a decision of the BA within 2 % of `tol` of its threshold (relative to the
# cost) may go either way between two solves whose states part by rounding
TIE_SHARE = 0.02


def decision_ties(trace: list, tol: float) -> list:
    """The plain BA's trips (`vo.ba.ba_solve_ref`'s trace, float64 costs)
    whose accept test (the candidate's cost against the current one) or stop
    test (the relative decrease against `tol`) lies within `TIE_SHARE` of
    `tol` of its threshold, relative to the cost, as (trip, what, margin)."""
    ties = []
    for trip, t in enumerate(trace, 1):
        accept = (t["cost"] - t["cost_new"]) / abs(t["cost"])
        if abs(accept) <= TIE_SHARE * tol:
            ties.append((trip, "accept", accept))
        if t["accept"] and abs(t["rel_decrease"] - tol) <= TIE_SHARE * tol:
            ties.append((trip, "stop", t["rel_decrease"] - tol))
    return ties


NUDGES = 8  # the plain version's reruns from nudged inputs that measure its spread


def nudged(x, k: int):
    """x with each entry moved by about one float32 rounding (2^-23 of
    itself), up or down as the k-th draw says."""
    g = torch.Generator(device="cpu").manual_seed(k)
    sign = torch.randint(0, 2, x.shape, generator=g).to(x.device, x.dtype) * 2 - 1
    return x * (1 + sign * 2.0 ** -23)


def witness_bar(plain_spread: float) -> float:
    """How far a kernel's float32 result may lie from the float64 witness:
    twice the plain version's float32 spread about it (the farthest of its
    results, from the inputs and from `NUDGES` nudged copies of them), and
    never less than 1e-4."""
    return max(2.0 * plain_spread, 1e-4)


def _same_sign(a, b):
    """a's quaternions [..., 0:4] turned to b's side of the double cover."""
    s = torch.where((a[..., :4] * b[..., :4]).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.cat([a[..., :4] * s, a[..., 4:]], -1)


def localize_agreement(got, intr, pix, pts, n: int, valid, thr: float, idx) -> dict:
    """A localization kernel's result `got` (`kernels.localize.LocalizeResult`)
    held to the plain version on the same inputs on the CPU, whose sums run
    in the kernel's order. Grunert's quartic in float32 has near-double
    roots whose Newton polish jumps under any change of arithmetic, so a
    candidate that the plain P3P itself does not give to 1e-4 (against its
    float64 evaluation: 1 to 4 % of them) is ill-conditioned. The bars: the
    candidates' validity equal; every other valid candidate within 1e-4
    relative (the quaternion up to its sign); each count equal but on an
    ill-conditioned candidate or by residuals at the threshold (within
    R_ULP of it: a residual 1 - cos is good to 4 ulp of 1, 2e-3 of the
    threshold); the same best candidate (unless the plain one is
    ill-conditioned or has a residual at the threshold), within 1e-4. The
    refined pose against a float64 witness, `ransac.refine_absolute_pose`
    in float64 from the same start and inliers (its 10 trips): the kernel's
    pose within `witness_bar` of the plain version's float32 spread about
    it (its refinement from the start and from `NUDGES` starts nudged by one
    rounding). The translation is weakly held (at the map's scale its
    normal equations' condition is ~1e6), so float32 rounding moves a
    trip's step there by some per cent, and float32 refinements part from
    the witness by up to ~0.5 on the main path while the rotation agrees;
    an early stop or a wrong step would leave the kernel farther. The
    reselected inliers equal the plain reselection at the kernel's own
    refined pose, up to residuals at the threshold. Raises AssertionError
    otherwise; returns what it compared, with the kernel's pose minus the
    plain version's by component, the refinement's normal matrix's
    eigenvalues at the witness and the inliers' depths there."""
    from evo_tpu_torch.core import camera, lie
    from evo_tpu_torch.kernels import localize
    from evo_tpu_torch.solve import p3p, ransac

    intr, pix, pts, valid, idx = (a.cpu() for a in (intr, pix, pts, valid, idx))
    want, want_inl = ransac.localize_camera_fused_ref(intr, pix, pts, n, valid, thr, indices=idx)
    bear = camera.unproject(intr, pix)
    cands, ok = p3p.p3p_grunert(bear[idx], pts[idx])
    cands, ok = cands.reshape(-1, 7), ok.reshape(-1)
    exact = p3p.p3p_grunert(bear[idx].double(), pts[idx].double())[0].reshape(-1, 7).float()

    def rel(a):
        return ((_same_sign(a, cands) - cands).abs() / cands.abs().clamp_min(1.0)).amax(-1)

    off = rel(got.candidates.cpu())
    ill = ok & (rel(exact) > 1e-4)
    thr32 = float(np.float32(thr))
    r = p3p.reprojection_angle_residual(cands, bear, pts)
    near = ((r - thr32).abs() <= R_ULP) & ok[:, None] & valid
    counts = ((r < thr32) & ok[:, None] & valid).sum(-1)
    res = ransac.absolute_pose_ransac(bear, pts, n, threshold=thr, valid_mask=valid,
                                      indices=idx)[1]
    best, got_best = int(res.best_idx), int(got.best_idx)
    best_err = float((_same_sign(got.ransac_pose.cpu(), res.model) - res.model).abs().max())
    err = float((_same_sign(got.pose.cpu(), want) - want).abs().max())
    # each refinement against its float64 witness from its own start
    bear64, pts64 = camera.unproject(intr.double(), pix.double()), pts.double()

    def witness(start):
        inliers = (p3p.reprojection_angle_residual(start, bear, pts) < thr32) & valid
        return ransac.refine_absolute_pose(start.double(), bear64, pts64, inliers), inliers

    def apart(pose, opt):
        return float((_same_sign(pose.double(), opt) - opt).abs().max())

    opt, inliers = witness(res.model)
    plain_spread = max([apart(want, opt)] + [apart(ransac.refine_absolute_pose(
        nudged(res.model, k), bear, pts, inliers), opt) for k in range(NUDGES)])
    got_err = apart(got.pose.cpu(), witness(got.ransac_pose.cpu())[0])
    r_fin = p3p.reprojection_angle_residual(got.pose.cpu(), bear, pts)
    at_thr = ((r_fin - thr32).abs() <= R_ULP) & valid
    inl_off = int(((got.inliers.cpu() != ((r_fin < thr32) & valid)) & ~at_thr).sum())
    got_counts = got.counts.cpu()
    # where the refinement is weakly held: its normal matrix's eigenvalues at
    # the witness (tangent (v, omega)) and the inliers' depths there
    _, jac = localize.angle_residual_jacobian(opt, bear64[inliers], pts64[inliers])
    depth = lie.se3_apply(lie.se3_inverse(opt), pts64[inliers])[:, 2]
    row = dict(max_abs_err=err, valid_candidates=int(ok.sum()), ill_conditioned=int(ill.sum()),
               candidates_apart=int((ok & (off > 1e-4)).sum()),
               candidate_rel_err=float(off[ok & ~ill].max()) if bool((ok & ~ill).any()) else 0.0,
               best_err=best_err, best_idx=[got_best, best],
               counts_off=int((got_counts != counts).sum()), near_threshold=int(near.sum()),
               witness_err=[got_err, plain_spread], inliers_off=inl_off, trips=int(got.trips),
               kernel_minus_plain=(_same_sign(got.pose.cpu(), want) - want).tolist(),
               normal_eigenvalues=torch.linalg.eigvalsh(jac.T @ jac).tolist(),
               inlier_depths=[float(depth.min()), float(depth.max())])
    loose = ill | near.any(-1)
    if not (torch.equal(got.candidate_valid.cpu().bool(), ok)
            and row["candidate_rel_err"] <= 1e-4
            and bool((((got_counts - counts).abs() <= near.sum(-1)) | ill).all())
            and (got_best == best or bool(loose[best]))
            and (got_best != best or best_err <= 1e-4)
            and got_err <= witness_bar(plain_spread) and inl_off == 0):
        raise AssertionError(f"localize disagrees with its plain version: {row}")
    return row


def check_localize(timer, dev, call, reps: int = 200) -> dict:
    """`kernels.localize` on the card on one recorded call, held to the plain
    version on the same inputs on the CPU (`localize_agreement`; the card's
    plain version sums its norms and products in other orders than the
    kernel, which parts ill-conditioned candidates more often) and timed
    against the plain version on the card. Raises if they disagree; returns
    the row with its times."""
    from evo_tpu_torch.kernels import localize
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.solve import ransac

    (intr, pix, pts, n, valid, thr), kw = call
    idx = kw["indices"].to(dev, torch.int64)
    intr, pix, pts, valid = (a.to(dev) for a in (intr, pix, pts, valid))
    got = localize.localize(intr, pix, pts, valid, thr, idx)
    row = dict(kernel="localize", shape=f"N {pix.shape[0]} (n {n}), H {idx.shape[0]}",
               **localize_agreement(got, intr, pix, pts, n, valid, thr, idx))
    b_ms, by = bound(4 * (pix.numel() + pts.numel() + 9 + 7) + 8 * idx.numel()
                     + 2 * pix.shape[0], localize_flops(pix.shape[0], idx.shape[0], row["trips"]))
    row.update(
        ms=timer.device_ms(lambda: localize.localize(intr, pix, pts, valid, thr, idx), reps),
        host_us=timer.host_us(lambda: localize.localize(intr, pix, pts, valid, thr, idx), 50),
        plain_ms=timer.device_ms(lambda: ransac.localize_camera_fused_ref(
            intr, pix, pts, n, valid, thr, indices=idx), 5),
        bound_ms=b_ms, bound_by=by, library_ms=None)
    return row


def check_ba(timer, dev, call, reps: int = 200) -> dict:
    """`kernels.ba_solve` against `vo.ba.ba_solve_ref` on the card, on one
    recorded call: the initial and final costs within 1e-5 relative, the
    same trips unless a decision of the plain solve lies within 2 % of `tol`
    of its threshold (`decision_ties`), and poses and landmarks within
    `witness_bar` of the float64 witness (`ba_solve_ref` in float64 from the
    same start): a window of 21 frames has directions so weak that float32
    solves of equal cost lie up to a few 1e-3 from it, so the plain
    version's spread is measured (its result and its results from `NUDGES`
    copies of the landmarks nudged by one rounding) and the kernel may lie
    twice as far, never less than 1e-4. The row's
    `max_abs_err` is the kernel's distance to the plain version. Raises
    otherwise; returns the row with its times and that of `cholesky_ex` +
    `cholesky_solve` on the call's first reduced system."""
    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.vo import ba

    args, kw = call
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    poses, lms, intr, of, ol, op, om, fixed = args
    of, ol, om, fixed = of.long(), ol.long(), om.bool(), fixed.bool()
    args = [poses, lms, intr, of, ol, op, om, fixed]
    F, L, O = poses.shape[0], lms.shape[0], of.shape[0]
    orders = ba.observation_orders(of, ol, F, L, kw["compensated"], om)
    got = kba.ba_solve(*args, orders, **kw)
    trace = []
    want = ba.ba_solve_ref(*args, **kw, trace=trace)
    witness = ba.ba_solve_ref(*[a.double() if a.is_floating_point() else a for a in args], **kw)
    ties = decision_ties(trace, kw["tol"])
    trips = int(got[4])

    def apart(x, y):
        return max(float((x[0].double() - y[0].double()).abs().max()),
                   float((x[1].double() - y[1].double()).abs().max()))

    cost_err = abs(float(got[2]) - float(want[2])) / abs(float(want[2]))
    cost0_err = abs(float(got[3]) - float(want[3])) / abs(float(want[3]))
    got_w = apart(got, witness)
    plain_w = max([apart(want, witness)] + [apart(ba.ba_solve_ref(
        poses, nudged(lms, k), *args[2:], **kw), witness) for k in range(NUDGES)])
    row = dict(kernel="ba_solve", shape=f"F {F}, L {L}, O {O}", max_abs_err=apart(got, want),
               cluster=getattr(kba, "CLUSTER", 1),
               cost_rel_err=cost_err, cost0_rel_err=cost0_err, trips=[trips, want[4], witness[4]],
               decision_ties=ties, witness_err=[got_w, plain_w], compensated=kw["compensated"])
    if not (cost_err <= 1e-5 and cost0_err <= 1e-5 and got_w <= witness_bar(plain_w)
            and (trips == want[4] or bool(ties))):
        raise AssertionError(f"ba_solve disagrees with its plain version: {row}")
    # the library yardstick: the first trip's reduced system, factored and solved
    sums = ba.observation_sums(of, ol, F, L, kw["compensated"], om)
    wmask = om.float()
    blocks = ba.normal_equations(poses, lms, intr, of, ol, op, wmask, fixed, sums, kw["huber"])
    pin_lm = (~(sums[1](wmask[:, None])[:, 0] > 0)).float()[:, None, None] * torch.eye(3, device=dev)
    S, v, _, _ = ba.reduced_system(*blocks, torch.tensor(1e-4, device=dev),
                                   fixed.float()[:, None, None] * torch.eye(6, device=dev), pin_lm)
    rhs = -v.reshape(-1, 1)

    def library():
        c, _ = torch.linalg.cholesky_ex(S)
        return torch.cholesky_solve(rhs, c)

    b_ms, by = bound(4 * (poses.numel() * 2 + lms.numel() * 2 + 9 + op.numel() + 2 + 1)
                     + 8 * (of.numel() + ol.numel() + 3 * O + F + L + L * F + 6) + om.numel()
                     + fixed.numel(),
                     ba_flops(of, ol, om, F, L, trips, kw["compensated"]))
    row.update(
        ms=timer.device_ms(lambda: kba.ba_solve(*args, orders, **kw), reps),
        # the launch's fixed part: the landmarks seen and the initial cost,
        # with no LM trip
        setup_ms=timer.device_ms(lambda: kba.ba_solve(*args, orders, **dict(kw, num_iters=0)),
                                 reps),
        # the orders' sorts, made once a call on the main path
        orders_ms=timer.device_ms(lambda: ba.observation_orders(of, ol, F, L, kw["compensated"],
                                                                om), reps),
        host_us=timer.host_us(lambda: kba.ba_solve(*args, orders, **kw), 50),
        plain_ms=timer.device_ms(lambda: ba.ba_solve_ref(*args, **kw), 3),
        bound_ms=b_ms, bound_by=by, library_ms=None,
        cholesky_library_ms=timer.device_ms(library, reps), system=list(S.shape))
    return row


def clock_split(stages, clocks) -> dict:
    """A clock build's cycles by stage, with the card's SM clock at the read."""
    from evo_tpu_torch.run.time_align import sm_clock_mhz

    cur, top = sm_clock_mhz()
    return dict(stages=list(stages), cycles=[int(v) for v in clocks.cpu()], sm_mhz=[cur, top])


def split_text(c: dict) -> str:
    """A clock split as one line: each stage's cycles and share of the total."""
    total = max(c["cycles"][-1], 1)
    return "  ".join(f"{s} {v} ({100.0 * v / total:.1f} %)"
                     for s, v in zip(c["stages"], c["cycles"]))


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def ba_call(dev, call) -> tuple:
    """A recorded BA call's eight tensors on `dev` as the kernel takes them,
    its keywords, and its orders (`vo.ba.observation_orders`)."""
    from evo_tpu_torch.vo import ba

    args, kw = call
    poses, lms, intr, of, ol, op, om, fixed = [a.to(dev) for a in args]
    args = [poses, lms, intr, of.long(), ol.long(), op, om.bool(), fixed.bool()]
    return args, kw, ba.observation_orders(args[3], args[4], poses.shape[0], lms.shape[0],
                                           kw["compensated"], args[6])


def clock_ba(timer, dev, call, reps: int = 200) -> dict:
    """`kernels.ba_solve`'s clock build on one recorded call: its results the
    plain build's bits and its stages adding up to the total (raises
    otherwise); its device ms over `reps` launches (`clock_build_ms`) and
    the split of one launch after them (`clock`)."""
    from evo_tpu_torch.kernels import ba_solve as kba

    args, kw, orders = ba_call(dev, call)
    plain = kba.ba_solve(*args, orders, **kw)
    *got, clocks = kba.ba_solve(*args, orders, **kw, clocks=True)
    torch.cuda.synchronize(dev)
    c = clocks.cpu()
    if not _same_bits(plain, got) or int(c[:-1].sum()) != int(c[-1]) or not bool((c >= 0).all()):
        raise AssertionError(f"ba_solve's clock build is off: bits {_same_bits(plain, got)}, "
                             f"cycles {c.tolist()}")
    ms = timer.device_ms(lambda: kba.ba_solve(*args, orders, **kw, clocks=True), reps)
    clocks = kba.ba_solve(*args, orders, **kw, clocks=True)[-1]
    torch.cuda.synchronize(dev)
    return dict(clock_build_ms=ms, clock=clock_split(kba.STAGES, clocks))


LOCALIZE_FIELDS = ("pose", "inliers", "best_idx", "num_inliers", "ransac_pose", "candidates",
                   "candidate_valid", "counts", "trips")


def clock_localize(timer, dev, call, reps: int = 200) -> dict:
    """`kernels.localize`'s clock build on one recorded call, as `clock_ba`."""
    from evo_tpu_torch.kernels import localize

    (intr, pix, pts, n, valid, thr), kw = call
    idx = kw["indices"].to(dev, torch.int64)
    intr, pix, pts, valid = (a.to(dev) for a in (intr, pix, pts, valid))
    plain = localize.localize(intr, pix, pts, valid, thr, idx)
    got = localize.localize(intr, pix, pts, valid, thr, idx, clocks=True)
    torch.cuda.synchronize(dev)
    c = got.clocks.cpu()
    same = _same_bits([getattr(plain, f) for f in LOCALIZE_FIELDS],
                      [getattr(got, f) for f in LOCALIZE_FIELDS])
    if not same or int(c[:-1].sum()) != int(c[-1]) or not bool((c >= 0).all()):
        raise AssertionError(f"localize's clock build is off: bits {same}, cycles {c.tolist()}")
    ms = timer.device_ms(lambda: localize.localize(intr, pix, pts, valid, thr, idx, clocks=True),
                         reps)
    clocks = localize.localize(intr, pix, pts, valid, thr, idx, clocks=True).clocks
    torch.cuda.synchronize(dev)
    return dict(clock_build_ms=ms, clock=clock_split(localize.STAGES, clocks))


def cluster_sizes(timer, dev, calls: dict, sizes=(1, 2, 4, 8, 16), reps: int = 50) -> dict:
    """The largest recorded BA in clusters of each of `sizes` blocks: whether
    every size gives the bits of the default size, and each one's device µs
    a launch over `reps` launches (None where the card cannot place such a
    cluster, or the launch fails: 16 blocks is beyond the portable 8)."""
    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import nvcc

    args, kw, orders = ba_call(dev, largest(calls["ba"], lambda a: (a[3].shape[0],
                                                                      int(a[6].sum()))))
    lib = kba._lib()

    def solve(c):
        return kba.run(lib, lambda *a: nvcc.launch(lib.evo_ba_solve, args[0], *a), *args, orders,
                       **kw, cluster=c)

    want = solve(kba.CLUSTER)
    same, device_us, failed = True, [], {}
    for c in sizes:
        try:
            got = solve(c)
            torch.cuda.synchronize(dev)
        except RuntimeError as e:
            if c <= 8:
                raise
            failed[c] = str(e)
            device_us.append(None)
            continue
        same = same and _same_bits(got, want)
        device_us.append(timer.device_ms(lambda: solve(c), reps) * 1e3)
    return dict(sizes=list(sizes), same_bits=same, device_us=device_us, failed=failed)


def drives_by_cluster(dataset, sizes, rounds: int, modes=("default",)) -> list:
    """Each of `modes` (`time_comp.run_mode`'s: default, sync) with
    `kernels.ba_solve.CLUSTER` set to each of `sizes` in turns (restored
    after), after one warm-up run: `rounds` rounds, each in the order of the
    last reversed; a row a run, with its `ba_cluster`."""
    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.run.time_comp import run_mode

    default, order, rows = kba.CLUSTER, [(m, c) for c in sizes for m in modes], []
    try:
        run_mode(dataset, modes[0])
        for _ in range(rounds):
            for m, c in order:
                kba.CLUSTER = c
                rows.append(dict(run_mode(dataset, m), ba_cluster=c))
            order.reverse()
    finally:
        kba.CLUSTER = default
    return rows


def call_digests(dev, calls: dict) -> dict:
    """Every recorded call run once more through the tree's kernel on `dev`:
    a SHA-256 of its inputs and its outputs a call, by kind. Two trees whose
    kernels give the same bits give the same lists."""
    import hashlib

    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import localize

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for x in tensors:
            h.update(x.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    out = {"localize": [], "ba": []}
    for (intr, pix, pts, n, valid, thr), kw in calls["localize"]:
        idx = kw["indices"].to(dev, torch.int64)
        ins = [a.to(dev) for a in (intr, pix, pts, valid)]
        got = localize.localize(*ins, thr, idx)
        out["localize"].append(digest(ins + [idx] + [getattr(got, f) for f in LOCALIZE_FIELDS]))
    for call in calls["ba"]:
        args, kw, orders = ba_call(dev, call)
        out["ba"].append(digest(args + list(kba.ba_solve(*args, orders, **kw))))
    return out


def largest(calls: list, size) -> tuple:
    """The recorded call with the largest `size(args)`, the last of ties."""
    return max(reversed(calls), key=lambda c: size(c[0]))


def check_kernels(timer, dev, calls: dict, reps: int = 200) -> list:
    """`check_localize` on the largest recorded localization (by N, then
    valid points) and `check_ba` on the largest recorded BA (by O, then
    observations), each with its clock build's split (`clock_localize`,
    `clock_ba`) where the tree has one."""
    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import localize

    loc = largest(calls["localize"], lambda a: (a[1].shape[0], a[3]))
    bac = largest(calls["ba"], lambda a: (a[3].shape[0], int(a[6].sum())))
    rows = [check_localize(timer, dev, loc, reps), check_ba(timer, dev, bac, reps)]
    if hasattr(localize, "STAGES"):  # the tree has the clock builds
        rows[0].update(clock_localize(timer, dev, loc, reps))
    if hasattr(kba, "STAGES"):
        rows[1].update(clock_ba(timer, dev, bac, reps))
    return rows


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
    ap.add_argument("--kernels", action="store_true",
                    help="hold VO's kernels to their plain versions and time them instead")
    ap.add_argument("--drive-clusters", type=int, nargs="+", metavar="C",
                    help="time the standard mode with the BA in clusters of these sizes "
                         "instead, in --reps rounds")
    ap.add_argument("--drive-modes", nargs="+", default=["default"], choices=["default", "sync"],
                    help="the drives --drive-clusters runs")
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
    if args.drive_clusters:
        for row in drives_by_cluster(dataset, args.drive_clusters, args.reps,
                                     args.drive_modes):
            print(f"time_vo {args.root}: drive " + json.dumps(dict(row, card=card())),
                  flush=True)
        return 0
    if args.kernels:
        from evo_tpu_torch.kernels import nvcc
        from evo_tpu_torch.run.time_splat import Timer

        calls = record_solves(dataset, args.frames, dev)
        for row in check_kernels(Timer(dev), dev, calls):
            print(f"time_vo {args.root}: kernel " + json.dumps(dict(row, card=card()),
                                                               default=str), flush=True)
            if "clock" in row:
                print(f"time_vo {args.root}: {row['kernel']} clock split ({row['shape']}; "
                      f"cycles at {row['clock']['sm_mhz']} MHz): "
                      f"{split_text(row['clock'])}", flush=True)
        from evo_tpu_torch.kernels import ba_solve as kba

        if hasattr(kba, "CLUSTER"):  # the tree's BA runs in a cluster
            print(f"time_vo {args.root}: ba_solve by cluster size "
                  + json.dumps(cluster_sizes(Timer(dev), dev, calls)), flush=True)
        print(f"time_vo {args.root}: digests " + json.dumps(call_digests(dev, calls)),
              flush=True)
        for name, log in sorted(nvcc.build_logs.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"time_vo {args.root}: ptxas ({name}): {line.strip()}", flush=True)
        return 0
    candidates = record_candidates(dataset, args.frames, dev)
    runs = [run_vo(dataset, candidates, dev) for _ in range(args.reps + 1)][1:]  # 1 warm-up
    first = runs[0]["poses"]

    def apart(p):
        return float(np.abs(p - first).max()) if p.shape == first.shape else float("inf")

    rows = [dict(vo_s=r["vo_s"], ba_calls=r["ba_calls"], ba_iterations=r["ba_iterations"],
                 ate=r["ate"], keyframes=len(r["poses"]), stage_s=r["stage_s"],
                 launches=r["launches"],
                 bitwise=bool(r["poses"].shape == first.shape and (r["poses"] == first).all()),
                 max_pose_diff=apart(r["poses"])) for r in runs]
    out = dict(card=card(), frames=args.frames, candidates=len(candidates), runs=rows,
               sums=sum_repeats(dev),
               deterministic_mode=deterministic_listing(dataset, candidates, dev))
    print(f"time_vo {args.root}: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
