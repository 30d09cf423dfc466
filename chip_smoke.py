"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. environment: a CUDA card is required; prints the torch and CUDA versions
   and the card's name and power limit;
2. build: compiles the hand-written CUDA kernels from evo_tpu_torch/csrc
   (splat.cu, align_step.cu, comp_tile.cu, comp_step.cu, localize.cu,
   ba_solve.cu, frame_maps.cu, corner_select.cu, frame_rows.cu,
   frame_policy.cu, route_events.cu), one nvcc
   for each source (and one for each clock build: the alignment kernel's,
   compensation's two, VO's two, corner_select's, frame_rows', the
   policy's and the routing's), all started together,
   and prints ptxas's register, spill and shared-memory lines;
3. kernels: the alignment step (`kernels/align_step.py`, one block per
   table row: integration, the whole LM, the post-solve update and the
   re-budget) against its plain version `align.solve_step_ref` on the
   window scan's 128 ready rows: ran, lost and alive equal, the integrated
   event images exact, costs within 1e-4 relative, centres and the warps'
   rect pixels within 1e-3 px, the rotation within 1e-4, flow within 1e-4
   rad, budgets within 1; timed as the splat is, its bound counted from the
   run's LM trips (no PyTorch call computes it: library none). Its clock
   build (-DEVO_ALIGN_CLOCKS) must give the same bits, with each ready
   row's stage cycles adding up to its total; then `run/time_align.py`'s
   sweep over 1, 16 and 128 ready rows prints device and host µs and the
   clock's split by stage (`kernels.align_step.STAGES`). Then
   compensation's kernels (`run/time_comp.py`): kernel A (`comp_tile`, the
   tile residual and its forward-mode Jacobian, a block a tile row) against
   autograd through the plain splat at [108, 256], [108, 1024] (edge and
   variance losses), [864, 1024] (W = 8) and [24, 1024] on the 40 px
   window's 120x120 tiles (the loss in strips): the score (the loss; r =
   maxRes - score holds it to 6e-5 alone) within 1e-4 relative of the plain
   score, printed beside the smallest plain score, r within 1e-4 relative
   where no loss is taken, J within 1e-3, `escaped` equal; kernel B
   (`comp_step`, a warp a window's pivots) at 108 tiles with W = 1 and 8, at
   the 40 px grid's 24 and at the 15 px grid's 192 (band 32: the block-wide
   factorisation that phase 12 (c) runs): its solve entry against `tile_system_ref` (ok
   equal, backward error 1e-6, its forward error against a float64 solve
   printed beside LAPACK's) and its loop entry (INIT | HEAD, then TAIL |
   HEAD) against `lm_step_ref` on a copy of its state: decisions equal,
   costs 1e-5 relative, the candidate the solve entry's; the library
   yardstick `cholesky_ex` + `cholesky_solve` timed beside. Each has a clock
   build (-DEVO_COMP_CLOCKS), held at every shape to its plain build bit for
   bit with its stages adding up to the total, timed, and its split by stage
   printed (`kernels.comp_tile.STAGES`, `kernels.comp_step.STAGES`). Then the
   generic splat (forward and backward) and the fused
   warp-and-splat entries against their plain PyTorch versions on the card,
   at the shapes the main path gives them ([108, 256] and [108, 1024] events
   into 60x60 tiles, [1, 15000] into 180x240, [24, 1024] into 120x120, the
   40 px tiles' shape, on no path since kernel A took them), the fused
   entries also
   against the unfused kernel (positions must agree exactly). Each is timed
   as many launches between one pair of CUDA events behind work already
   queued on the card, so the time is the device's and not the host's; the
   wrapper's host time per call, the bound, the floor (an empty kernel), the
   plain version and, where one PyTorch call computes the same function, that
   call are printed beside it. Last, VO's two kernels (`run/time_vo.py`) at
   the run's shapes: the scene of phase 5 is simulated here, the synchronous
   standard mode runs its 24 frames once with every localization's and BA's
   arguments recorded, and `kernels.localize` (one launch: unprojection, P3P
   RANSAC over the front end's minimal samples, the LM refinement, the
   reselection) and `kernels.ba_solve` (one launch: the whole windowed BA,
   F 21) are held on the largest recorded call of each to their plain
   versions: `localize_camera_fused_ref` on the same inputs on the CPU
   (`time_vo.localize_agreement`: the candidates' validity equal, each
   candidate 1e-4 relative but the ill-conditioned ones, counts equal up to
   those and residuals at the threshold, the same best candidate, the
   refined pose no farther from its float64 witness than twice the plain
   version's distance, never less than 1e-4) and `ba_solve_ref` on the card
   (`time_vo.check_ba`: costs 1e-5 relative, the same trips unless a
   decision lies within 2 % of tol of its threshold, poses and landmarks
   held to the float64 witness the same way); each timed as above, with
   `cholesky_ex` + `cholesky_solve` on the BA's reduced system beside it.
   The BA runs as one thread-block cluster (`kernels.ba_solve.CLUSTER`
   blocks) and must give the same bits in clusters of 1, 2, 4, 8 and 16
   blocks; each VO kernel's clock build (-DEVO_LOC_CLOCKS, -DEVO_BA_CLOCKS)
   must give its kernel's bits with its stages adding up to its total, and
   its split by stage (`kernels.localize.STAGES`, `kernels.ba_solve.STAGES`,
   cycles of one launch after 200) is printed. Then the frame path's three
   kernels (`run/time_frames.py`'s `check_kernels`): `frame_maps` (gradient
   pair, Harris response, pyramid levels 1 and 2) within 1e-5 of its plain
   version on the scene's first 3 frames; `corner_select` with the plain
   version's corners, order and scores on their responses, and the
   kernels' corner sets equal to the plain path's (cuDNN's response) on all
   24 frames, or apart only between responses within 1e-5, each case
   printed; `frame_rows` on every call of the synchronous run's 24 frames:
   LK's status and flow (1e-3 px), the table's fields and budgets as the
   plain version's, or apart only at an LK stop-test tie, each printed;
   each timed as above, beside its bound, plain version and library
   (`F.conv2d`'s stacked chain; `torch.topk` and the host greedy pass;
   none), with ptxas's registers and spills of each; `frame_rows` also on
   each of the 24 calls and their sum, with a digest of its outputs; the
   clock splits of `corner_select` (cycles of one launch by stage) and of
   `frame_rows` (the slowest row of the heaviest call), each clock build
   held to its plain build's outputs; the policy's kernel
   (`kernels.frame_policy`, one block a frame, the association in conflict
   waves) on every policy call of the default drive's 24 frames and the
   event routing's (`kernels.route_events`, a block a patch in clusters of
   8 that read the sub-batch once) on every sub-batch of the tracker
   experiment (`run/time_route.py`), each bit for bit against its plain
   version on the card (decisions, state and `new_center`; rings,
   `ev_count`, `counter`), timed on each call and in full on the heaviest,
   beside its bound and plain version (no PyTorch call computes either:
   library none), with ptxas's lines, and each clock build
   (-DEVO_FP_CLOCKS, -DEVO_RE_CLOCKS) held to its plain build's bits and
   split by stage (the policy on each call, the routing's slowest block on
   the heaviest call); the ATen operations the policy dispatches a frame through
   the plain version (the parent's path) and through the kernel, and the
   CUDA kernels, copies and operations of one frame window of the default
   drive (`time_frames.window_launches`); then the card tests of the frame
   path, the policy and the routing (`tests/test_torch_gpu.py -k "frame or
   corner or refuses or route"`, radius 15, more than 256 corners, every
   policy and routing case, the refusals at construction and a whole frame
   window that reads nothing back among them) in a pytest process of their
   own;
4. sweep: the forward tile kernel with 1, 2, 4 and 8 private copies of the
   image at 256 threads (8 copies: one per warp, no atomics), and at 384 and
   512 threads; the backward at 256 and 512 threads;
5. main path: simulates the 3walls scene (1.2 s at 20 fps, contrast 0.05,
   seed 3: DAVIS density, about 1.1 Mev/s) on the card and runs the tracker
   experiment with contrast compensation through `Evaluator`, checks its
   artifacts, and checks that the run went through the kernels
   (compensation: kernels A and B launched, no fused splat),
   printing compensation seconds and its host reads a window; one
   compensation window is also solved on the CPU with the plain versions
   and held against the card's solve;
6. large tiles: one compensation window with 40 px tiles, whose 120x120
   padded images kernel A takes too (the loss in strips), with kernel B's
   loop, held against the CPU's solve; no fused or generic Gaussian splat
   runs;
7. standard mode: the same scene through the standard mode (tracker ->
   VO, compensation on, default parameters, no device given), first on the
   synchronous drive (`pipelined=False`). Every pose of vo_trajectory.txt
   must be finite, at least 6 keyframes accepted, the VO solves found on the
   card, each localization one launch of `kernels.localize` and each BA one
   of `kernels.ba_solve` (launches equal to the front end's calls, no plain
   version on a card tensor), every analysed frame one launch of each of
   `frame_maps`, `corner_select` and `frame_rows` (no plain version of
   theirs on a card tensor), compensation on kernels A and B, and the
   Sim(3)-aligned ATE over the scene's depth under its limit. The first 12 frames are run once more with
   the VO geometry on the host CPU, and the `vo` stage seconds of both are
   printed side by side. Before it, the batched SVDs of the two RANSACs are
   timed with each cuSOLVER method. Then VO's repeatability: the 12-frame
   synchronous run once more, which must give the same tracks and every
   keyframe pose and the ATE bit for bit (a `vo repeats itself` line with
   the largest pose difference, 0, and both runs' `vo` seconds): VO's sums
   run in one order on the card (ROADMAP §C item 5);
8. pipelined path: the same scene in the same call through the default
   drive (`pipelined=True`, `async_vo=True`: compensation on the evo-comp
   thread and VO on the evo-vo thread, each on its own stream) over all 24
   frames, then over the first 12 frames with VO inline and with the frame
   policy on the host. Each must reproduce the synchronous run of as many
   frames: trajectory.txt with the same track ids and timestamps and
   positions within 1e-3 px, the last motion field within 1e-4 px/ms, as many
   compensation windows, keyframes within 1, the ATE under its limit, VO on
   the card, compensation's kernels (and the count splat) launched from the
   evo-comp thread on another stream than the default, VO's kernels (on the
   default drive) from the evo-vo thread on one stream of its own (inline:
   from the main thread), both workers ended
   and nothing left in flight
   after `finish()`; every standard-mode run launches `route_events` once a
   sub-batch (as often as `align_step`) and, on the default drive (the
   device policy), `frame_policy` once a frame (none on the synchronous
   drive and with the host policy), and no plain version of either runs on
   a card tensor. Wall and stage seconds of all four runs go into one
   `pipelined path` JSON line, beside the largest and the sum of the
   synchronous run's stages;
9. tracks window: `compensate_from_tracks` on the tracker experiment's
   trajectories and the first 15,000 events: a finite field, a count image
   whose sum is the number of events warped to a pixel inside the image, the
   nearest splat launched;
10. run-time extras, on the same scene, no device given: (a) frames 0-11 of
   the standard mode on the synchronous drive, `save_checkpoint`,
   `load_checkpoint` into a new evaluator, frames 12-23: trajectory.txt as
   phase 7's run (ids, timestamps, positions within 1e-3 px), the last
   motion field within 1e-4, the splat launched after the resume, finite
   poses, the ATE under its limit; (b) the watchdog on the default drive, 12
   frames, an auto-checkpoint every 4 frames, a NaN centre injected into a
   live row at window 3: the row quarantined, finite artifacts, the VO check
   run on the evo-vo thread, the first auto-checkpoint taken at frame 4 with
   windows in flight, and the run resumed from it through frames 4-11
   writing the same trajectory.txt; (c) `profile_trace`
   around two frame windows of the default drive: the trace names
   compensation's kernels (`comp_tile_kernel`, `comp_lm_step_kernel`); (d)
   the patch views,
   the feature overlay and the compensated image written as PNGs by the
   port's own writer (signature and size checked), `predicted_nabla` and
   `cost_map` finite and on the card; (e) `evaluate_tracker` on phase 5's
   tracks against the scene's ground truth, and the BA precision report with
   one timed solve per variant;
11. temporal batching: (a) the 83 compensation windows of the scene (its
   events in blocks of 15,000, as the evaluator cuts them) solved cold one
   by one (W = 1) and in batches of W = 4 and 8 (`dist.temporal`, one launch
   of kernel A over the W·108 tiles and one of kernel B a trip): each
   window's field and costs equal to its W = 1 solve bit for bit, its count
   image within 1e-3, and the seconds, launches and host reads of each W
   printed; the fused splat entries also timed at [W·108, 1024] against
   their plain versions; (b) the default drive
   with `temporal_batch=8` over the first 12 frames, timed beside the same
   drive without it: trajectory.txt as phase 7's 12-frame run (ids, timestamps, positions within 1e-3 px),
   compensation launched from the evo-comp thread on a stream of its own, nothing
   left in flight after `finish()`; (c) a (space, batch) mesh of one rank
   over NCCL on the card: `sharded_splat`, `sharded_tile_solve_data` and
   `sharded_normal_equations` each against its one-device computation on
   the card; then two ranks on the one card over gloo, the port's
   all_reduce, all_gather and broadcast tried on CUDA tensors and what gloo
   did with each printed;
12. the meshed path: (a) `multihost.initialize` with one NCCL rank, then the
   standard mode on the default drive over all 24 frames with
   `EvaluatorParams(mesh=make_mesh())`: trajectory.txt as phase 8's
   unmeshed default-drive run (ids, timestamps, positions within 1e-3 px),
   the ATE under its limit and within 1e-4 of that run's, the last motion
   field within 1e-4 px/ms, keyframes within 1, and as many launches of
   the splat, alignment and kernel A (the meshed tile solve keeps its host
   loop and calls kernel B's solve entry); wall and stage seconds beside the
   unmeshed run's;
   (b) two gloo ranks on the one card (`multihost.launch`, a (1, 2) mesh:
   gloo moves no point to point on CUDA tensors, and with one ``space``
   rank the tile solve exchanges no halo), the standard mode on the
   default drive over the first 12 frames: both ranks' trajectory.txt
   byte-identical, each rank on the card with its splat, alignment and
   compensation launches counted, its ATE under the limit, within twice that of phase
   7's 12-frame synchronous run and its keyframes within 1 of that run's;
   a 128-row table scanned on the card as one block and as two blocks of
   64 gives the same bits (`block_split_check`), and against that run's
   tracks no row is unmatched and every matched row is within 1e-3 px;
   (c) `parity_worker` on the NCCL rank of (a), and
   `measure_scaling_pipeline(counts=(1,))` in a rank of its own: the
   sharded window scan's and tile solve's cost on one card beside the
   unsharded calls; (d) `write_scaling_artifact` into a temporary path,
   SCALING.json's bytes unchanged.

ATE_OVER_MAX_DEPTH_LIMIT is 0.035, the upper end of the band the quality
report quotes (0.0036-0.035), unless the JAX package's own standard mode on
this dataset lies above 0.023 (then 1.5 times its value):
tests/test_torch_reference_ate.py measures that on the CPU and holds the
constant to the rule.

The second-to-last line of output is a JSON object describing each kernel;
the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

FPS = 20.0
SCENE = dict(duration_s=1.2, fps=FPS, seed=3, scene="3walls", contrast_threshold=0.05)
TOL = 1e-5  # Gaussian splat: the kernel sums in another order than the plain version
REPS = 200  # launches between one pair of events
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores, published
SOURCE = "evo_tpu_torch/csrc/splat.cu"
REPLACES = "evo_tpu/kernels/splat_pallas.py:67"
ALIGN_SOURCE = "evo_tpu_torch/csrc/align_step.cu"
ALIGN_REPLACES = "evo_tpu/tracker/align.py:494"  # optimize_ready_patches, then :396
COMP_TILE_SOURCE = "evo_tpu_torch/csrc/comp_tile.cu"
COMP_TILE_REPLACES = "evo_tpu/tracker/compensate.py:138"  # tile_residual under jacfwd (:207)
COMP_STEP_SOURCE = "evo_tpu_torch/csrc/comp_step.cu"
COMP_STEP_REPLACES = "evo_tpu/tracker/compensate.py:227"  # solve_motion_field's step
LOCALIZE_SOURCE = "evo_tpu_torch/csrc/localize.cu"
LOCALIZE_REPLACES = "evo_tpu/solve/ransac.py:223"  # localize_camera_fused, one jitted program
BA_SOURCE = "evo_tpu_torch/csrc/ba_solve.cu"
BA_REPLACES = "evo_tpu/vo/ba.py:98"  # ba_solve, a lax.while_loop of LM trips
VO_LAUNCHES = ("evo_localize", "evo_ba_solve")
# the frame path's kernels: (name, source, what each replaces)
FRAME_KERNELS = (
    ("frame_maps", "evo_tpu_torch/csrc/frame_maps.cu",
     "evo_tpu/kernels/harris.py:25"),  # with gradients.py:21, :44, :80 (detector.py:143)
    ("corner_select", "evo_tpu_torch/csrc/corner_select.cu",
     "evo_tpu/kernels/harris.py:49"),  # its selection: top_k and the fixpoint (:119)
    ("frame_rows", "evo_tpu_torch/csrc/frame_rows.cu",
     "evo_tpu/tracker/detector.py:230"),  # _lk_init_cond over lk.py:121, :248, align.py:461
)
# the policy's and the routing's kernels (ROADMAP §B items 13 and 2)
POLICY_KERNEL = ("frame_policy", "evo_tpu_torch/csrc/frame_policy.cu",
                 "evo_tpu/tracker/policy.py:125")  # frame_policy, its fori_loop :160-166
ROUTE_KERNEL = ("route_events", "evo_tpu_torch/csrc/route_events.cu",
                "evo_tpu/tracker/patch_state.py:102")  # route_events (:102-187)
# compensation's kernels' names as `nvcc.launch` sees them, and the splat's
COMP_LAUNCHES = ("evo_comp_tile", "evo_comp_lm_step", "evo_comp_solve", "evo_splat_", "evo_warp_")
# operations of the alignment kernel, counted from its code: a linearization
# costs about 480 a rect pixel (two Catmull-Rom tap sets with derivatives, 32
# gathered taps contracted three ways, cos and sin, the residual and its
# Jacobian, 20 reduced products), the re-budget about 60
ALIGN_FLOPS_PER_LIN_PIXEL = 480
ALIGN_FLOPS_PER_BUDGET_PIXEL = 60
WINDOW_EVENTS = 15_000  # EvaluatorParams.compensation_events
BATCHES = (4, 8)
TILES = 108  # 12 x 9 tiles of 20 px on DAVIS240C
TILE = 20
ATE_OVER_MAX_DEPTH_LIMIT = 0.035
MAX_DEPTH_M = 2.0  # the scene's far plane, as the JAX package's quality suite divides


def bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_inputs(e: int, gen, dev, tile: int = TILE):
    """Events of the DAVIS240C tiles of `tile` px, E slots each, about 70 %
    filled: (vel, ex, ey, dt_us, valid, tlx, tly) as `build_tile_data` lays
    them out."""
    tx = 240 // tile
    t = torch.arange(tx * (180 // tile))
    tlx = (t % tx * tile).float()
    tly = (t // tx * tile).float()
    ex = tlx[:, None] + torch.randint(0, tile, (len(t), e), generator=gen).float()
    ey = tly[:, None] + torch.randint(0, tile, (len(t), e), generator=gen).float()
    dt_us = torch.rand(len(t), e, generator=gen) * 30_000 - 15_000
    valid = torch.rand(len(t), e, generator=gen) < 0.7
    vel = torch.randn(len(t), 2, generator=gen) * 0.05
    vel[0] = 0.0  # integer positions: every outer tap sits exactly at |d| == radius
    return tuple(a.contiguous().to(dev) for a in (vel, ex, ey, dt_us, valid, tlx, tly))


def gauss_flops(n_events: float) -> float:
    # 2 axes x 8 candidate taps (subtract, compare, scale, square, exp ~ 10
    # operations each), then up to 7 x 7 multiply-adds
    return n_events * (2 * 8 * 10 + 49 * 2)


def phase_kernels(splat, timer, dev, label: str) -> list[dict]:
    """Every kernel against its plain version at the main path's shapes.
    Returns one row per (entry, shape)."""
    from evo_tpu_torch.tracker.compensate import GAUSS_NORM

    gen = torch.Generator(device="cpu").manual_seed(0)
    rows = []
    side = 3 * TILE
    kw = dict(mode="gaussian", sigma=1.0, radius=3)
    wkw = dict(scale=1e-3, tile=TILE, weight=GAUSS_NORM, sigma=1.0, radius=3)

    def add(name, shape, err, fn, plain, n_bytes, n_flops, library=None):
        b_ms, by = bound(n_bytes, n_flops)
        rows.append(dict(
            kernel=name, shape=shape, max_abs_err=err,
            ms=timer.device_ms(fn, REPS), host_us=timer.host_us(fn, REPS),
            plain_ms=timer.device_ms(plain, 20), bound_ms=b_ms, bound_by=by,
            library_ms=None if library is None else timer.device_ms(library, 50)))

    for e in (256, 1024):
        vel, ex, ey, dt_us, valid, tlx, tly = tile_inputs(e, gen, dev)
        events = (ex, ey, dt_us, valid, tlx, tly)
        n_valid = float(valid.sum())
        shape = f"gaussian [{TILES}, {e}] -> [{side}, {side}]"
        g = torch.randn(TILES, side, side, generator=gen).to(dev)

        # the generic entry on explicitly warped coordinates
        px, py, w = (a.contiguous() for a in splat._warp_events(
            vel, *events, 1e-3, TILE, GAUSS_NORM))
        out = splat.splat_image(px, py, w, side, side, **kw)
        ref = splat.splat_image_ref(px, py, w, side, side, **kw)
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        img_bytes = TILES * side * side * 4
        add("splat_fwd", shape, (out - ref).abs().max().item(),
            lambda: splat.splat_image(px, py, w, side, side, **kw),
            lambda: splat.splat_image_ref(px, py, w, side, side, **kw),
            3 * TILES * e * 4 + img_bytes, gauss_flops(n_valid))

        got = splat._backward(px, py, w, g, side, side, "gaussian", 1.0, 3)
        want = splat.splat_bwd_ref(px, py, w, g, side, side, **kw)
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, rtol=TOL, atol=TOL)
        add("splat_bwd", shape, max((a - c).abs().max().item() for a, c in zip(got, want)),
            lambda: splat._backward(px, py, w, g, side, side, "gaussian", 1.0, 3),
            lambda: splat.splat_bwd_ref(px, py, w, g, side, side, **kw),
            6 * TILES * e * 4 + img_bytes, gauss_flops(TILES * e) * 2)

        # the fused entry: positions must equal the unfused ones bit for bit
        # (nearest mode: one ulp would move a count), values within TOL
        near = splat.warp_splat(vel, *events, **{**wkw, "mode": "nearest", "weight": 1.0})
        px1, py1, w1 = (a.contiguous() for a in splat._warp_events(
            vel, *events, 1e-3, TILE, 1.0))
        near_unfused = splat.splat_image(px1, py1, w1, side, side, mode="nearest")
        near_plain = splat.splat_image_ref(px1, py1, w1, side, side, mode="nearest")
        if not (torch.equal(near, near_unfused) and torch.equal(near, near_plain)):
            raise AssertionError(
                "fused and unfused positions differ: nearest counts off by "
                f"{(near - near_unfused).abs().max().item()}")
        fused = splat.warp_splat(vel, *events, **wkw)
        torch.testing.assert_close(fused, ref, rtol=TOL, atol=TOL)
        # no atomics, a fixed order of adds: the same positions give the same
        # bits, fused or unfused, and from one launch to the next
        if not (torch.equal(fused, out)
                and torch.equal(fused, splat.warp_splat(vel, *events, **wkw))):
            raise AssertionError(
                "fused and unfused Gaussian images differ by "
                f"{(fused - out).abs().max().item()}")
        ev_bytes = TILES * e * 13 + TILES * 4 * 4
        add("warp_splat_fwd", shape, (fused - ref).abs().max().item(),
            lambda: splat.warp_splat(vel, *events, **wkw),
            lambda: splat.warp_splat_ref(vel, *events, **wkw),
            ev_bytes + img_bytes, gauss_flops(n_valid) + 8 * TILES * e)

        # d sum(g * image) / d vel: fused kernel, plain autograd, and the
        # unfused kernel's per-event gradients reduced in PyTorch. The sum
        # over a tile's events cancels, so the upstream gradient is scaled to
        # make the largest entry of the result 1: errors are relative to it
        cfg = (1e-3, TILE, GAUSS_NORM, "gaussian", 1.0, 3)
        v = vel.clone().requires_grad_(True)
        (splat.warp_splat_ref(v, *events, **wkw) * g).sum().backward()
        g = g / v.grad.abs().max()
        want_vel = v.grad / v.grad.abs().max()
        gvel = splat._warp_backward(vel, events, cfg, g)
        unfused = splat._backward(px, py, w, g, side, side, "gaussian", 1.0, 3)
        shift = dt_us * 1e-3
        gvel_unfused = torch.stack([(shift * unfused[0]).sum(1),
                                    (shift * unfused[1]).sum(1)], 1)
        torch.testing.assert_close(gvel, want_vel, rtol=TOL, atol=TOL)
        torch.testing.assert_close(gvel, gvel_unfused, rtol=TOL, atol=TOL)

        def plain_bwd():
            v_ = vel.clone().requires_grad_(True)
            (splat.warp_splat_ref(v_, *events, **wkw) * g).sum().backward()

        add("warp_splat_bwd", shape, (gvel - want_vel).abs().max().item(),
            lambda: splat._warp_backward(vel, events, cfg, g),
            plain_bwd, ev_bytes + img_bytes + TILES * 2 * 4,
            gauss_flops(n_valid) * 2 + 12 * TILES * e)

    # 40 px tiles: 24 padded images of 120x120 take the one-thread-per-event
    # kernels, forward and backward
    vel, *events = tile_inputs(1024, gen, dev, tile=40)
    px, py, w = (a.contiguous() for a in splat._warp_events(
        vel, *events, 1e-3, 40, GAUSS_NORM))
    g = torch.randn(24, 120, 120, generator=gen).to(dev)
    n_valid = float(events[3].sum())
    shape = "gaussian [24, 1024] -> [120, 120]"
    out = splat.splat_image(px, py, w, 120, 120, **kw)
    ref = splat.splat_image_ref(px, py, w, 120, 120, **kw)
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    add("splat_fwd", shape, (out - ref).abs().max().item(),
        lambda: splat.splat_image(px, py, w, 120, 120, **kw),
        lambda: splat.splat_image_ref(px, py, w, 120, 120, **kw),
        3 * 24 * 1024 * 4 + 24 * 120 * 120 * 4, gauss_flops(n_valid))
    got = splat._backward(px, py, w, g, 120, 120, "gaussian", 1.0, 3)
    want = splat.splat_bwd_ref(px, py, w, g, 120, 120, **kw)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=TOL, atol=TOL)
    add("splat_bwd", shape, max((a - c).abs().max().item() for a, c in zip(got, want)),
        lambda: splat._backward(px, py, w, g, 120, 120, "gaussian", 1.0, 3),
        lambda: splat.splat_bwd_ref(px, py, w, g, 120, 120, **kw),
        6 * 24 * 1024 * 4 + 24 * 120 * 120 * 4, gauss_flops(24 * 1024) * 2)

    # the compensated count image: one window of 15 k events, rounded
    # coordinates, unit weights
    n, h, wd = 15_000, 180, 240
    x = torch.round(torch.rand(1, n, generator=gen) * 250 - 5).to(dev)
    y = torch.round(torch.rand(1, n, generator=gen) * 190 - 5).to(dev)
    ones = torch.ones(1, n, device=dev)
    out = splat.splat_image(x, y, ones, h, wd, mode="nearest")
    ref = splat.splat_image_ref(x, y, ones, h, wd, mode="nearest")
    if not torch.equal(out, ref):
        raise AssertionError(
            f"nearest splat differs from the plain version by {(out - ref).abs().max().item()}")
    # the one PyTorch call that computes the same function on these inputs
    inside = ((x >= 0) & (x < wd) & (y >= 0) & (y < h)).reshape(-1)
    index = (y.reshape(-1) * wd + x.reshape(-1))[inside].long()
    lib_out = torch.zeros(h * wd, device=dev)

    def library():
        lib_out.zero_()
        lib_out.index_put_((index,), ones.reshape(-1)[: index.numel()], accumulate=True)

    library()
    if not torch.equal(lib_out.reshape(1, h, wd), ref):
        raise AssertionError("index_put_ disagrees with the plain nearest splat")
    add("splat_fwd", f"nearest [1, {n}] -> [{h}, {wd}]", (out - ref).abs().max().item(),
        lambda: splat.splat_image(x, y, ones, h, wd, mode="nearest"),
        lambda: splat.splat_image_ref(x, y, ones, h, wd, mode="nearest"),
        3 * n * 4 + h * wd * 4, n * (2 * 2 * 3 + 4), library)

    floor_ms = timer.device_ms(lambda: splat._launch("evo_empty_launches", x, REPS), 5) / REPS
    for r in rows:
        r["floor_ms"] = floor_ms
        lib = "-" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f}"
        print(f"kernel {r['kernel']:14s} {r['shape']:34s} max_abs_err {r['max_abs_err']:.3e}  "
              f"device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host {r['host_us']:.2f} us  "
              f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})  empty-kernel floor "
              f"{floor_ms * 1e3:.2f} us  plain {r['plain_ms'] * 1e3:.2f} us  library {lib} us  "
              f"({label})", flush=True)
    return rows


def rect_displacement(wa, wb, center):
    """[P] largest distance (float64) between where the warps wa and wb put
    a row's 625 rect pixels."""
    r = torch.arange(-12, 13, dtype=torch.float64, device=center.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    px = center[:, 0:1].double() + gx.reshape(1, -1)
    py = center[:, 1:2].double() + gy.reshape(1, -1)

    def apply(w):
        w = w.double()
        return (w[:, 0:1] * px - w[:, 1:2] * py + w[:, 2:3],
                w[:, 1:2] * px + w[:, 0:1] * py + w[:, 3:4])

    (ax, ay), (bx, by) = apply(wa), apply(wb)
    return torch.sqrt((ax - bx) ** 2 + (ay - by) ** 2).amax(1)


def align_errors(table, got: dict, ran, cost, lost, integrated, ref, ref_ran, ref_cost,
                 ref_lost) -> dict:
    """The kernel's step against the plain version's on one table, with the
    bars each is held to."""
    from evo_tpu_torch.tracker import align

    r = ran
    med = ref.final_costs.median(1).values
    sure = (med - align.LOST_COST_THRESHOLD).abs() > 1e-5
    dflow = torch.remainder(got["flow"].double() - ref.flow.double() + np.pi,
                            2 * np.pi) - np.pi
    out = dict(
        rows_ran=int(r.sum()),
        ran_equal=bool(torch.equal(ran, ref_ran)),
        lost_equal=bool(torch.equal(lost[sure], ref_lost[sure])),
        integrated_exact=bool(torch.equal(integrated[r], align.integrate_events(table)[r])),
        cost_rel=((cost[r] - ref_cost[r]).abs() / ref_cost[r].abs()).max().item(),
        center_px=(got["center"] - ref.center).abs().max().item(),
        warp_rect_px=rect_displacement(got["warp"], ref.warp, table.center).max().item(),
        warp_rotation=(got["warp"][:, :2] - ref.warp[:, :2]).abs().max().item(),
        warp_entry_rel=((got["warp"] - ref.warp).abs()
                        / ref.warp.abs().clamp_min(1e-3)).max().item(),
        flow_rad=dflow.abs().max().item(),
        num_of_events=(got["num_of_events"] - ref.num_of_events).abs().max().item(),
        exact_fields=[k for k in ("counter", "n_costs", "cur_t", "last_update_t")
                      if torch.equal(got[k], getattr(ref, k))],
        alive_equal=bool(torch.equal(got["alive"][sure], ref.alive[sure])),
    )
    out["ok"] = bool(
        out["ran_equal"] and out["lost_equal"] and out["integrated_exact"]
        and out["alive_equal"] and len(out["exact_fields"]) == 4
        and out["cost_rel"] <= 1e-4 and out["center_px"] <= 1e-3
        and out["warp_rect_px"] <= 1e-3 and out["warp_rotation"] <= 1e-4
        and out["flow_rad"] <= 1e-4 and out["num_of_events"] <= 1)
    return out


def phase_align_step(timer, dev, label: str, floor_ms: float) -> dict:
    """The alignment step's kernel against its plain version on the card at
    the window scan's 128 ready rows, timed; its bound counted from this
    run's LM trips."""
    from evo_tpu_torch.kernels import align_step as kalign
    from evo_tpu_torch.run.time_align import align_inputs
    from evo_tpu_torch.tracker import align

    table, g = align_inputs(dev)
    got, ran, cost, lost, extra = kalign.align_step(table, g, g[0], integrated=True,
                                                    trips=True)
    ref, ref_ran, ref_cost, ref_lost = align.solve_step_ref(table, g, g[0])
    torch.cuda.synchronize()
    errors = align_errors(table, got, ran, cost, lost, extra["integrated"], ref, ref_ran,
                          ref_cost, ref_lost)
    print("align_step against its plain version: " + json.dumps(errors), flush=True)
    if not errors["ok"]:
        raise AssertionError(f"the alignment kernel disagrees with its plain version: {errors}")
    trips = extra["trips"][ran]
    ready = int(ran.sum())
    pixels = 25 * 25
    n_flops = (float((trips + 1).sum()) * pixels * ALIGN_FLOPS_PER_LIN_PIXEL
               + ready * pixels * ALIGN_FLOPS_PER_BUDGET_PIXEL)
    table_bytes = sum(getattr(table, k).nbytes for k, _ in kalign.IN_FIELDS) + sum(
        v.nbytes for v in got.values()) + ran.nbytes + lost.nbytes + cost.nbytes
    windows = min(ready * 2 * 2 * 64 * 64 * 4, g.nbytes + g[0].nbytes)
    b_ms, by = bound(table_bytes + windows, n_flops)
    row = dict(
        kernel="align_step", shape=f"{table.capacity} ready rows, E {table.ev_t.shape[1]}, "
                                   f"grads {list(g.shape)}",
        max_abs_err=errors["center_px"], errors=errors,
        trips=dict(mean=float(trips.float().mean()), max=int(trips.max()),
                   linearizations=int((trips + 1).sum())),
        ms=timer.device_ms(lambda: kalign.align_step(table, g, g[0]), REPS),
        host_us=timer.host_us(lambda: kalign.align_step(table, g, g[0]), REPS),
        plain_ms=timer.device_ms(lambda: align.solve_step_ref(table, g, g[0]), 20),
        bound_ms=b_ms, bound_by=by, bound_bytes=table_bytes + windows, bound_flops=n_flops,
        library_ms=None, floor_ms=floor_ms)
    print(f"kernel align_step {row['shape']}: device {row['ms'] * 1e3:.2f} us/launch over "
          f"{REPS}  wrapper host {row['host_us']:.2f} us  bound {b_ms * 1e3:.3f} us ({by}: "
          f"{n_flops / 1e9:.4f} GFLOP, {(table_bytes + windows) / 1e6:.3f} MB)  plain "
          f"{row['plain_ms'] * 1e3:.2f} us  library none  LM trips {row['trips']}  "
          f"({label})", flush=True)
    row.update(phase_align_clock(kalign, timer, dev, label, table, g, got, ran, cost, lost,
                                 extra))
    return row


def phase_align_clock(kalign, timer, dev, label: str, table, g, got, ran, cost, lost,
                      extra) -> dict:
    """The alignment kernel's clock build against the plain build on the
    same table (the same bits; each ready row's stage cycles add up to its
    total), then `time_align`'s sweep over ready rows with the split."""
    from evo_tpu_torch.run.time_align import sm_clock_mhz, split_text, sweep

    got_c, ran_c, cost_c, lost_c, extra_c = kalign.align_step(
        table, g, g[0], integrated=True, trips=True, clocks=True)
    torch.cuda.synchronize()
    mine = {**got, "ran": ran, "cost": cost, "lost": lost, **extra}
    theirs = {**got_c, "ran": ran_c, "cost": cost_c, "lost": lost_c, **extra_c}
    differ = [k for k, v in mine.items()
              if not torch.equal(torch.nan_to_num(v), torch.nan_to_num(theirs[k]))
              or not torch.equal(torch.isnan(v), torch.isnan(theirs[k]))]
    clocks = extra_c["clocks"]
    stages = clocks[ran][:, :-1].sum(1)
    if differ or not torch.equal(stages, clocks[ran][:, -1]) or (clocks[ran] < 0).any() \
            or (clocks[~ran] != 0).any():
        raise AssertionError(f"the alignment kernel's clock build is off: fields {differ}, "
                             f"stage sums {stages.tolist()[:4]} against totals "
                             f"{clocks[ran][:4, -1].tolist()}")
    rows = sweep(kalign, timer, dev, REPS)
    cur, top = sm_clock_mhz()
    for n, r in rows.items():
        print(f"align_step at {n} ready rows: device {r['device_us']:.2f} us/launch over "
              f"{REPS} (clock build {r['clock_build_device_us']:.2f})  wrapper host "
              f"{r['host_us']:.2f} us  LM trips at most {r['max_trips']} ({label})",
              flush=True)
    for n, r in rows.items():
        c = r["clock"]
        print(f"align_step clock split at {n} ready rows (cycles at {cur:.0f} of {top:.0f} "
              f"MHz; mean over rows | longest row, {c['longest_row_trips']} trips): "
              f"{split_text(c)}", flush=True)
    return dict(sweep={str(n): dict(device_us=r["device_us"], host_us=r["host_us"],
                                    clock_build_device_us=r["clock_build_device_us"],
                                    mean_cycles=dict(zip(r["clock"]["stages"],
                                                         r["clock"]["mean_cycles"])))
                       for n, r in rows.items()},
                sm_clock_mhz=cur)


def phase_comp_kernels(timer, dev, label: str, floor_ms: float) -> list[dict]:
    """Compensation's kernels against their plain versions on the card, at
    the main path's shapes (`run/time_comp.py`): kernel A at [108, 256],
    [108, 1024] (both losses), [864, 1024] (W = 8) and the 40 px grid's
    [24, 1024]; kernel B at 108 tiles with W = 1 and 8, at the 40 px
    grid's 24 tiles (these in one warp's registers) and at the 15 px grid's
    192 (band 32, the block-wide factorisation)."""
    from evo_tpu_torch.run.time_align import split_text
    from evo_tpu_torch.run.time_comp import (STEP_SHAPES, TILE_SHAPES, check_comp_step,
                                             check_comp_tile, clock_comp_step, clock_comp_tile)

    rows = [dict(check_comp_tile(timer, dev, nw, e, loss, REPS, tile),
                 **clock_comp_tile(timer, dev, nw, e, loss, REPS, tile))
            for nw, e, loss, tile in TILE_SHAPES]
    rows += [dict(check_comp_step(timer, dev, nw, tile, REPS),
                  **clock_comp_step(timer, dev, nw, tile, REPS))
             for nw, tile in STEP_SHAPES]
    for r in rows:
        r["floor_ms"] = floor_ms
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        extra = (f"score rel {r['score_rel_err']:.2e} of scores from {r['score_min']:.3e}, "
                 f"r rel {r['r_rel_err']:.2e} where no loss is taken"
                 if r["kernel"] == "comp_tile" else
                 f"solve entry {r['solve_ms'] * 1e3:.2f} us, off a float64 solve by "
                 f"{r['solve_of_step']:.2e} of the step (plain {r['plain_solve_of_step']:.2e})")
        print(f"kernel {r['kernel']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} ({extra})  "
              f"device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host "
              f"{r['host_us']:.2f} us  bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})  "
              f"plain {r['plain_ms'] * 1e3:.2f} us  library {lib} ({label})", flush=True)
    for r in rows:
        print(f"{r['kernel']} clock split {r['shape']} (clock build {r['clock_build_ms'] * 1e3:.2f}"
              f" us; cycles, mean over rows | longest row): {split_text(r['clock'])}", flush=True)
    return rows


def phase_sweep(splat, timer, dev, label: str) -> None:
    """The forward tile kernel with private copies of the image in shared
    memory (as many as warps: plain adds; fewer: atomics) and the backward,
    at several block sizes."""
    from evo_tpu_torch.tracker.compensate import GAUSS_NORM

    gen = torch.Generator(device="cpu").manual_seed(1)
    side = 3 * TILE
    for e in (256, 1024):
        vel, *events = tile_inputs(e, gen, dev)
        events = tuple(events)
        cfg = (1e-3, TILE, GAUSS_NORM, "gaussian", 1.0, 3)
        ref = splat.warp_splat_ref(vel, *events, scale=1e-3, tile=TILE, weight=GAUSS_NORM)
        for threads, copies in ((256, 1), (256, 2), (256, 4), (256, 8), (384, 12),
                                (512, 12), (1024, 8), (1024, 12)):
            out = splat._warp_forward(vel, events, cfg, copies, threads)
            torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
            ms = timer.device_ms(
                lambda: splat._warp_forward(vel, events, cfg, copies, threads), REPS)
            print(f"sweep warp_splat_fwd [{TILES}, {e}] -> [{side}, {side}] copies {copies} "
                  f"threads {threads}: {ms * 1e3:.2f} us/launch ({label})", flush=True)
        for threads in (256, 512, 1024):
            ms = timer.device_ms(lambda: splat._warp_backward(
                vel, events, cfg, ref, threads), REPS)
            print(f"sweep warp_splat_bwd [{TILES}, {e}] threads {threads}: "
                  f"{ms * 1e3:.2f} us/launch ({label})", flush=True)


def counts(splat) -> dict:
    """Launches of every kernel since the last `reset_counts` (comp_step:
    both of its entries; comp_step_solve: the solve entry alone; localize and
    ba_solve: VO's), and compensation's host reads of its stop flag."""
    from evo_tpu_torch.kernels import (align_step, ba_solve, comp_step, comp_tile, corner_select,
                                       frame_maps, frame_policy, frame_rows, localize,
                                       route_events)
    from evo_tpu_torch.tracker import compensate

    return {"splat_fwd": splat.launches_fwd, "splat_bwd": splat.launches_bwd,
            "frame_maps": frame_maps.launches_frame_maps,
            "frame_policy": frame_policy.launches_frame_policy,
            "route_events": route_events.launches_route_events,
            "corner_select": corner_select.launches_corner_select,
            "frame_rows": frame_rows.launches_frame_rows,
            "localize": localize.launches_localize, "ba_solve": ba_solve.launches_ba,
            "warp_splat_fwd": splat.launches_warp_fwd,
            "warp_splat_bwd": splat.launches_warp_bwd,
            "align_step": align_step.launches_align,
            "comp_tile": comp_tile.launches_comp_tile,
            "comp_step": comp_step.launches_step + comp_step.launches_solve,
            "comp_step_solve": comp_step.launches_solve,
            "comp_host_reads": compensate.host_reads}


def reset_counts(splat) -> None:
    from evo_tpu_torch.kernels import (align_step, ba_solve, comp_step, comp_tile, corner_select,
                                       frame_maps, frame_policy, frame_rows, localize,
                                       route_events)
    from evo_tpu_torch.tracker import compensate

    for module in (splat, align_step, comp_step, comp_tile, compensate, localize, ba_solve,
                   frame_maps, corner_select, frame_rows, frame_policy, route_events):
        module.reset_counts()


def check_compensation_kernels(launches: dict, what: str) -> None:
    """Compensation ran on kernels A and B alone: no fused splat (the plain
    version's)."""
    if launches["comp_tile"] <= 0 or launches["comp_step"] <= 0:
        raise AssertionError(f"{what} never launched comp_tile or comp_step: {launches}")
    if launches["warp_splat_fwd"] or launches["warp_splat_bwd"]:
        raise AssertionError(f"{what}: compensation took the plain version: {launches}")


def check_window(comp, args, dev, what: str) -> None:
    """One compensation window solved on the card against the CPU's solve
    with the plain splat."""
    f_gpu, img_gpu, c_gpu, _ = comp.compensate_window(*args, device=dev)
    f_cpu, img_cpu, c_cpu, _ = comp.compensate_window(*args, device="cpu")
    field_err = float(np.abs(f_gpu - f_cpu).max())
    same_px = float(np.mean(img_gpu == img_cpu))
    print(f"{what}, card vs CPU: field max diff {field_err:.3e} px/ms, cost "
          f"{c_gpu:.6g} vs {c_cpu:.6g}, identical count pixels {same_px:.4f}", flush=True)
    if field_err > 1e-2 or abs(c_gpu - c_cpu) > 1e-3 * abs(c_cpu) or same_px < 0.995:
        raise AssertionError(f"{what}: the card's compensation disagrees with the CPU reference")
    if img_gpu.sum() != img_cpu.sum():
        raise AssertionError(f"{what}: count images differ in mass")


def simulate(dev, label: str):
    """The 3walls scene of every later phase, simulated on the card."""
    from evo_tpu_torch.io import sim

    t0 = time.perf_counter()
    dataset = sim.to_dataset(sim.EventCameraSimulator(sim.SimParams(**SCENE),
                                                      device=dev).generate())
    print(f"simulated 3walls: {len(dataset.events)} events, {dataset.num_images} frames "
          f"in {time.perf_counter() - t0:.2f} s ({label})", flush=True)
    return dataset


def phase_vo_kernels(timer, dev, label: str, dataset) -> list[dict]:
    """VO's kernels against their plain versions on the card, on the largest
    localization and BA of the synchronous standard mode's 24 frames
    (`run/time_vo.py`'s `record_solves`, `check_kernels`)."""
    from evo_tpu_torch.run import time_vo

    t0 = time.perf_counter()
    calls = time_vo.record_solves(dataset, 24, dev)
    rows = time_vo.check_kernels(timer, dev, calls, REPS)
    for r in rows:
        extra = (f"of {r['valid_candidates']} valid candidates {r['candidates_apart']} beyond 1e-4 "
                 f"({r['ill_conditioned']} ill-conditioned; the others within "
                 f"{r['candidate_rel_err']:.2e}), best {r['best_idx']} off by "
                 f"{r['best_err']:.2e}, refined pose from the float64 witness "
                 f"{r['witness_err'][0]:.2e} (plain {r['witness_err'][1]:.2e}), "
                 f"counts off {r['counts_off']} ({r['near_threshold']} residuals at the "
                 f"threshold), {r['trips']} LM trips; kernel - plain by component "
                 f"{[float(f'{x:.2e}') for x in r['kernel_minus_plain']]}, the refinement's "
                 f"normal eigenvalues {[float(f'{x:.1e}') for x in r['normal_eigenvalues']]} "
                 f"at inlier depths {[round(x, 1) for x in r['inlier_depths']]}"
                 if r["kernel"] == "localize" else
                 f"cost rel {r['cost_rel_err']:.2e}, cost0 rel {r['cost0_rel_err']:.2e}, trips "
                 f"{r['trips']} (kernel, plain, float64 witness), decisions within 2 % of tol "
                 f"{r['decision_ties']}, poses and landmarks from the witness "
                 f"{r['witness_err'][0]:.2e} (plain {r['witness_err'][1]:.2e}); "
                 f"{r['setup_ms'] * 1e3:.2f} us of each launch before its first trip, the "
                 f"orders' sorts {r['orders_ms'] * 1e3:.2f} us; cholesky_ex + cholesky_solve on "
                 f"its {r['system']} system {r['cholesky_library_ms'] * 1e3:.2f} us")
        print(f"kernel {r['kernel']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} ({extra})  "
              f"device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host "
              f"{r['host_us']:.2f} us  bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})  "
              f"plain {r['plain_ms'] * 1e3:.2f} us  library none ({label})", flush=True)
        print(f"{r['kernel']} clock split {r['shape']} (clock build "
              f"{r['clock_build_ms'] * 1e3:.2f} us; cycles at {r['clock']['sm_mhz']} MHz): "
              f"{time_vo.split_text(r['clock'])}", flush=True)
    sizes = time_vo.cluster_sizes(timer, dev, calls)
    print(f"ba_solve in clusters of {sizes['sizes']} blocks: the same bits "
          f"{sizes['same_bits']}, device us {sizes['device_us']}", flush=True)
    if not sizes["same_bits"]:
        raise AssertionError(f"ba_solve's bits depend on its cluster's size: {sizes}")
    print(f"VO kernels recorded {len(calls['localize'])} localizations and {len(calls['ba'])} "
          f"BAs, checked in {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


def phase_frame_kernels(timer, dev, label: str, dataset) -> list[dict]:
    """The frame path's three kernels against their plain versions on the
    card at the run's shapes (`run/time_frames.py`'s `check_kernels`): the
    scene's first frames and responses, and every `frame_rows` call of the
    synchronous standard mode's 24 frames, each call timed; the clock splits
    of `corner_select` and of `frame_rows` (its slowest row on the heaviest
    call) and ptxas's registers and spills of each."""
    from evo_tpu_torch.run import time_frames

    t0 = time.perf_counter()
    rows = time_frames.check_kernels(timer, dev, dataset)
    for r in rows:
        extra = dict(frame_maps=lambda: f"library within {r['library_abs_err']:.1e}",
                     corner_select=lambda: f"{r['candidates']} candidates, {r['accepted']} "
                     f"accepted, {r['compared']} responses the same corners; against the "
                     f"plain path's on {r['corner_sets']['frames']} frames, sets apart "
                     f"{r['corner_sets']['apart']} (each between responses within 1e-5)",
                     frame_rows=lambda: f"{r['compared']} calls, rows apart {r['rows_apart']}, "
                     f"LK stop-test ties {r['ties']}",
                     frame_policy=lambda: f"{r['compared']} calls of the default drive bit for "
                     f"bit, digest {r['digest']}")[r["kernel"]]()
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"kernel {r['kernel']} {r['shape']}: max_abs_err {r['max_abs_err']:.3e} ({extra})  "
              f"device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host "
              f"{r['host_us']:.2f} us  bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})  "
              f"plain {r['plain_ms'] * 1e3:.2f} us  library {lib} ({label})", flush=True)
        for name, entries in r["ptxas"].items():
            for entry, rep in entries.items():
                print(f"  {r['kernel']} registers ({name}, {entry}): {rep}", flush=True)
    cs, fr = rows[1], rows[2]
    print(f"corner_select clock split, cycles of one launch (rank 0): {cs['clock']}", flush=True)
    print(f"frame_rows clock split, cycles of the slowest row (row {fr['clock']['row']}, "
          f"{fr['clock']['trips']} trips) on the heaviest call: {fr['clock']['cycles']}; "
          f"each stage's largest over the rows {fr['clock']['largest']}", flush=True)
    print(f"frame_rows on each of the {fr['compared']} calls, device us a launch "
          f"(LK rows): " + ", ".join(f"{u:.2f} ({n})" for u, n in zip(
              fr["calls_us"], fr["calls_lk_rows"]))
          + f"; together {fr['calls_sum_us']:.2f} us; outputs' digest {fr['digest']} ({label})",
          flush=True)
    fp = rows[3]
    print(f"frame_policy on each of the default drive's {fp['compared']} calls, device us a "
          f"launch: " + ", ".join(f"{u:.2f}" for u in fp["calls_us"])
          + f"; together {fp['calls_sum_us']:.2f} us ({label})", flush=True)
    print(f"frame_policy clock split of the heaviest call (call {fp['heaviest_call']}), "
          f"cycles of the block and its waves: {fp['clock']}; each call's total: "
          f"{fp['calls_clock']}; each call's waves: {fp['calls_waves']} ({label})", flush=True)
    print(f"frame_policy dispatches a frame: plain version (the parent's path) "
          f"{fp['dispatches']['plain']} ATen operations, the kernel's path "
          f"{fp['dispatches']['kernel']} ({label})", flush=True)
    print(f"frame kernels checked in {time.perf_counter() - t0:.2f} s", flush=True)
    return rows


def phase_route_kernel(timer, dev, label: str, dataset) -> dict:
    """The routing kernel against its plain version on the card on every
    sub-batch of the tracker experiment (`run/time_route.py`), each call
    timed; then one frame window of the default drive counted
    (`time_frames.window_launches`)."""
    from evo_tpu_torch.run import time_frames, time_route

    t0 = time.perf_counter()
    r = time_route.check_route_events(timer, time_route.record_routes(dataset))
    print(f"kernel route_events {r['shape']}: max_abs_err {r['max_abs_err']:.3e} "
          f"({r['compared']} calls bit for bit, {r['routed']} events routed, digest "
          f"{r['digest']})  device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host "
          f"{r['host_us']:.2f} us  bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})  "
          f"plain {r['plain_ms'] * 1e3:.2f} us  library none ({label})", flush=True)
    us = r["calls_us"]
    print(f"route_events on each of the {len(us)} sub-batches: device us a launch min "
          f"{min(us):.2f}, median {float(np.median(us)):.2f}, max {max(us):.2f}; together "
          f"{r['calls_sum_us']:.2f} us ({label})", flush=True)
    print(f"route_events clock split of the heaviest call (call {r['heaviest_call']}), the "
          f"slowest block's cycles: {r['clock']} ({label})", flush=True)
    r["ptxas"] = {name: time_frames.ptxas(name) for name in (
        "evo_route_events", "evo_route_events_clock") if time_frames.ptxas(name)}
    for name, entries in r["ptxas"].items():
        for entry, rep in entries.items():
            print(f"  route_events registers ({name}, {entry}): {rep}", flush=True)
    window = time_frames.window_launches(dataset)
    print(f"default drive, one frame window (window {window['window']}, {window['sub_batches']} "
          f"sub-batches): {window['kernels']} CUDA kernels, {window['copies']} copies, "
          f"{window['dispatches']} ATen operations ({label})", flush=True)
    print(f"routing kernel checked in {time.perf_counter() - t0:.2f} s", flush=True)
    r["window"] = window
    return r


def phase_frame_card_tests(label: str) -> None:
    """The frame kernels' card tests (`tests/test_torch_gpu.py -k "frame or
    corner or refuses"`: each kernel against its plain version on the card,
    `frame_rows` at radius 15, `corner_select` above 256 corners, the
    tracker's refusals at construction) in a pytest process of their own,
    on the libraries this run built; every one must pass."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q", "-m",
         "gpu", os.path.join("tests", "test_torch_gpu.py"), "-k",
         "frame or corner or refuses or route"],
        cwd=here, capture_output=True, text=True, timeout=600)
    last = (res.stdout.strip().splitlines() or [""])[-1]
    print(f"frame kernels' card tests: {last} in {time.perf_counter() - t0:.2f} s ({label})",
          flush=True)
    if res.returncode != 0 or " passed" not in last or "skipped" in last:
        print(res.stdout[-6000:], res.stderr[-2000:], flush=True)
        raise AssertionError(f"the frame kernels' card tests failed (rc {res.returncode})")


def phase_main_path(splat, dev, label: str, dataset):
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.tracker import compensate as comp

    # the card's first solves pay one-time library set-up: warm up on a prefix
    with tempfile.TemporaryDirectory() as tmp:
        Evaluator(dataset, EvaluatorParams(tracker_experiment=True, output_dir=tmp),
                  device=dev).run(max_frames=3)

    with tempfile.TemporaryDirectory() as tmp:
        ev = Evaluator(dataset, EvaluatorParams(tracker_experiment=True, output_dir=tmp),
                       device=dev)
        reset_counts(splat)
        t0 = time.perf_counter()
        ev.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(splat)
        paths = ev.finish()
        traj = np.loadtxt(paths["trajectory"], ndmin=2)
        costs = np.loadtxt(paths["final_cost"], ndmin=2)

    c = ev.counters.counts
    stream_s = c["frames"] / FPS
    windows = c["compensation_windows"]
    improved = sum(cost < cost0 for cost, cost0 in ev.compensation_costs)
    stats = dict(
        events=int(c["events"]), frames=int(c["frames"]),
        tracks=len(ev.tracker.trajectories), solves=int(c["solves"]),
        compensation_windows=int(windows), windows_cost_below_initial=int(improved),
        stream_s=stream_s, wall_s=wall, rt_multiple=stream_s / wall,
        events_per_s=c["events"] / wall,
        stage_s={k: v for k, v in ev.counters.times.items()},
        launches=launches,
        compensation_s=ev.counters.times.get("compensation"),
        host_reads_per_window=launches["comp_host_reads"] / max(int(windows), 1),
    )
    print(f"main path ({label}): " + json.dumps(stats), flush=True)

    if traj.shape[1] != 4 or not np.isfinite(traj).all() or len(traj) == 0:
        raise AssertionError("trajectory.txt is empty or not finite")
    if costs.shape[1] != 3 or not np.isfinite(costs).all() or len(costs) == 0:
        raise AssertionError("final_cost.txt is empty or not finite")
    if stats["tracks"] <= 0 or stats["solves"] <= 0:
        raise AssertionError(f"no tracks or no solves: {stats}")
    if windows < 80:
        raise AssertionError(f"only {windows} compensation windows, expected >= 80")
    # the LM never accepts an ascent; the cold-started first window must
    # descend. A warm-started window often cannot: its cost (~1e8, dominated
    # by the constant maxRes term) has a float32 ulp of 8, below the change
    # a converged field can still make, so cost == cost0 there (the JAX
    # package behaves the same)
    if any(cost > cost0 for cost, cost0 in ev.compensation_costs):
        raise AssertionError("a compensation solve ended above its initial cost")
    if not ev.compensation_costs[0][0] < ev.compensation_costs[0][1]:
        raise AssertionError("the first compensation window did not lower its cost")
    if ev.motion_field is None or not np.isfinite(ev.motion_field).all():
        raise AssertionError("motion field missing or not finite")
    # compensation goes through kernels A and B, the count image through the
    # generic forward; the generic backward belongs to the next phase
    for name in ("splat_fwd", "align_step"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["route_events"] != launches["align_step"] or launches["frame_policy"]:
        raise AssertionError(f"the tracker experiment did not route each sub-batch through the "
                             f"kernel once, or ran the device policy: {launches}")
    check_compensation_kernels(launches, "the main path")
    if launches["splat_bwd"] != 0:
        raise AssertionError("compensation took the unfused backward")

    ev0 = dataset.events.slice(0, 15_000)
    window = (ev0.x.astype(np.float64), ev0.y.astype(np.float64), ev0.t_us.astype(np.int64))
    check_window(comp, (*window, comp.CompensateParams(max_iters=8)), dev, "first window")
    return stats, window, dataset, ev.tracker.trajectories


def phase_svd_methods(timer, dev, label: str) -> None:
    """The two batched SVDs of the bootstrap RANSAC (256 hypotheses: the
    [8, 9] null-vector problem with the full decomposition, and the [3, 3]
    projection) with each cuSOLVER method PyTorch offers, against the CPU."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    for shape in ((256, 8, 9), (256, 3, 3)):
        a_cpu = torch.randn(*shape, generator=gen)
        a = a_cpu.to(dev)
        ref = torch.linalg.svdvals(a_cpu.double()).float()
        for method in (None, "gesvdj", "gesvda", "gesvd"):
            u, sv, vt = torch.linalg.svd(a, full_matrices=True, driver=method)
            k = sv.shape[-1]
            err = (sv.cpu() - ref).abs().max().item()
            rec = ((u[..., :, :k] * sv[..., None, :]) @ vt[..., :k, :] - a).abs().max().item()
            # the last right vector is what the 8-point solve reads: a unit
            # vector that A maps to its singular value (0 for the ninth)
            last = vt[..., -1, :]
            s_last = sv[..., -1] if k == a.shape[-1] else torch.zeros_like(sv[..., -1])
            null = ((a @ last[..., None]).norm(dim=(-2, -1)) - s_last).abs().max().item()
            ms = timer.device_ms(
                lambda: torch.linalg.svd(a, full_matrices=True, driver=method), 10)
            print(f"svd {list(shape)} method {method}: {ms:.4f} ms/call, singular values "
                  f"off by {err:.2e}, reconstruction by {rec:.2e}, last right vector by "
                  f"{null:.2e} ({label})", flush=True)
        t0 = time.perf_counter()
        for _ in range(10):
            torch.linalg.svd(a_cpu, full_matrices=True)
        print(f"svd {list(shape)} on the host CPU: "
              f"{(time.perf_counter() - t0) * 100:.4f} ms/call", flush=True)


def check_same_tracks(ref: dict, run: dict, what: str, fields: bool = True) -> dict:
    """trajectory.txt with the reference run's track ids and timestamps,
    positions within 1e-3 px, and (with `fields`) the last motion field
    within 1e-4 where both runs solved one."""
    a, b = ref["traj"], run["traj"]
    if a.shape != b.shape or not np.array_equal(a[:, :2], b[:, :2]):
        raise AssertionError(f"{what}: trajectory.txt differs from the reference run's "
                             f"in its track ids or timestamps ({a.shape}, {b.shape})")
    out = dict(trajectory_max_diff_px=float(np.abs(a[:, 2:] - b[:, 2:]).max()))
    if fields and ref["ev"].motion_field is not None and run["ev"].motion_field is not None:
        out["motion_field_max_diff"] = float(
            np.abs(run["ev"].motion_field - ref["ev"].motion_field).max())
        if out["motion_field_max_diff"] > 1e-4:
            raise AssertionError(f"{what}: the last motion field differs from the "
                                 f"reference run's by {out['motion_field_max_diff']}")
    if out["trajectory_max_diff_px"] > 1e-3:
        raise AssertionError(f"{what}: positions differ from the reference run's by "
                             f"{out['trajectory_max_diff_px']} px")
    return out


def run_standard(splat, dataset, params, max_frames=None) -> dict:
    """One run of the standard mode, no device given. Returns the evaluator,
    its wall seconds, launch counts, (kernel, thread, stream) of every launch
    of compensation's and the splat's kernels (`seen`) and of VO's
    (`vo_seen`), the plain VO solves that ran on a card tensor, the rows of
    trajectory.txt and vo_trajectory.txt, and what `finish()` left alive."""
    from evo_tpu_torch.kernels import nvcc
    from evo_tpu_torch.run.evaluator import Evaluator

    from evo_tpu_torch.kernels import corner_select, frame_maps, lk
    from evo_tpu_torch.solve import ransac
    from evo_tpu_torch.tracker import align, detector, patch_state, policy
    from evo_tpu_torch.vo import ba

    seen, vo_seen, plain_on_card = set(), set(), []
    inner = nvcc.launch

    def recording(fn, on, *args):
        where = (fn.__name__, threading.current_thread().name,
                 torch.cuda.current_stream(on.device).cuda_stream)
        if fn.__name__.startswith(COMP_LAUNCHES):
            seen.add(where)
        if fn.__name__.startswith(VO_LAUNCHES):
            vo_seen.add(where)
        return inner(fn, on, *args)

    # the plain versions of VO's and the frame path's kernels: none may run on
    # a card tensor
    plain = ((ransac, "localize_camera_fused_ref"), (ba, "ba_solve_ref"),
             (frame_maps, "frame_maps_ref"), (corner_select, "corner_select_ref"),
             (detector, "frame_rows_ref"), (align, "update_num_of_events_ref"),
             (lk, "track_pyramids_ref"), (policy, "frame_policy_ref"),
             (patch_state, "route_events_ref"))
    inner_plain = [getattr(m, n) for m, n in plain]

    def watching(name, fn):
        def call(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                plain_on_card.append(name)
            return fn(*args, **kw)
        return call

    with tempfile.TemporaryDirectory() as tmp:
        params.output_dir = tmp
        ev = Evaluator(dataset, params)
        reset_counts(splat)
        nvcc.launch = recording
        for (m, n), fn in zip(plain, inner_plain):
            setattr(m, n, watching(n, fn))
        try:
            t0 = time.perf_counter()
            ev.run(max_frames=max_frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            nvcc.launch = inner
            for (m, n), fn in zip(plain, inner_plain):
                setattr(m, n, fn)
        launches = counts(splat)
        paths = ev.finish()
        poses = np.loadtxt(paths["vo_trajectory"], ndmin=2)
        traj = np.loadtxt(paths["trajectory"], ndmin=2)
    left = [t.name for t in threading.enumerate() if t.name.startswith("evo-")]
    if (left or ev._pending_frames or ev._pending_comp or ev._vo_thread is not None
            or ev._comp_executor is not None
            or (ev._vo_queue is not None and not ev._vo_queue.empty())):
        raise AssertionError(f"finish() left work or workers behind: {left}")
    return dict(ev=ev, wall=wall, launches=launches, seen=seen, vo_seen=vo_seen,
                plain_on_card=plain_on_card, poses=poses, traj=traj)


def check_standard(run: dict, what: str) -> dict:
    """The checks every standard-mode run must pass; returns its numbers."""
    ev, poses, launches = run["ev"], run["poses"], run["launches"]
    if ev.device.type != "cuda":
        raise AssertionError(f"no device given, and the evaluator chose {ev.device}")
    vo = ev.vo
    c = ev.counters.counts
    stream_s = c["frames"] / FPS
    iters = [it for it, *_ in vo.ba_log]
    ate = vo.last_ate
    stats = dict(
        drive="pipelined" if ev.params.pipelined else "synchronous",
        async_vo=ev.params.async_vo if ev.params.pipelined else None,
        device_policy=ev.params.tracker.device_policy if ev.params.pipelined else None,
        events=int(c["events"]), frames=int(c["frames"]), stream_s=stream_s,
        wall_s=run["wall"], rt_multiple=stream_s / run["wall"],
        stage_s=dict(ev.counters.times), solves=int(c["solves"]),
        compensation_windows=int(c["compensation_windows"]),
        vo_stage_s=dict(vo.stage_s), vo_stage_calls=dict(vo.stage_calls), keyframes=len(poses),
        landmarks=len(vo.map.landmarks), ba_calls=len(iters),
        ba_mean_iterations=float(np.mean(iters)) if iters else None,
        ba_max_iterations=max(iters, default=None),
        ate_rmse_m=None if ate is None else ate.rmse,
        ate_over_max_depth=None if ate is None else ate.rmse / MAX_DEPTH_M,
        ate_limit=ATE_OVER_MAX_DEPTH_LIMIT,
        geometry_on=sorted(vo.solve_devices), launches=launches,
    )
    if poses.shape[1:] != (12,) or not np.isfinite(poses).all():
        raise AssertionError(f"{what}: vo_trajectory.txt holds a pose that is not finite")
    if len(poses) < 6 or ate is None:
        raise AssertionError(f"{what}: {len(poses)} keyframes accepted: no ATE exists below 6")
    if vo.solve_devices != {"cuda"} or not vo.intr.is_cuda:
        raise AssertionError(f"{what}: VO geometry ran on {vo.solve_devices}, not on the card")
    # one launch a solve: each localization and each BA went through its kernel
    calls = vo.stage_calls
    if (launches["localize"] != calls["localize"] or launches["localize"] <= 0
            or launches["ba_solve"] != calls["ba"] or calls["ba"] != len(vo.ba_log)
            or launches["ba_solve"] <= 0 or run["plain_on_card"]):
        raise AssertionError(f"{what}: VO's solves did not each launch their kernel: "
                             f"launches {launches}, calls {dict(calls)}, BA log "
                             f"{len(vo.ba_log)}, plain versions on the card "
                             f"{run['plain_on_card']}")
    for name in ("splat_fwd", "align_step"):
        if launches[name] <= 0:
            raise AssertionError(f"{what} never launched {name}")
    # the frame path: each analysed frame launched each frame kernel once
    frame_launches = {name: launches[name] for name, _, _ in FRAME_KERNELS}
    if set(frame_launches.values()) != {stats["frames"]}:
        raise AssertionError(f"{what}: {stats['frames']} frames analysed, but the frame "
                             f"kernels launched {frame_launches}")
    # the event path: one routing launch a sub-batch, as the alignment step;
    # the frame policy: one launch a frame on the device policy's drive
    device_policy = ev.params.pipelined and ev.params.tracker.device_policy
    if (launches["route_events"] != launches["align_step"]
            or launches["frame_policy"] != (stats["frames"] if device_policy else 0)):
        raise AssertionError(f"{what}: {stats['frames']} frames (device policy "
                             f"{device_policy}), {launches['align_step']} sub-batches, but "
                             f"route_events launched {launches['route_events']} times and "
                             f"frame_policy {launches['frame_policy']}")
    check_compensation_kernels(launches, what)
    stats["compensation_s"] = stats["stage_s"].get(
        "compensation", stats["stage_s"].get("compensation_worker"))
    stats["host_reads_per_window"] = launches["comp_host_reads"] / max(
        stats["compensation_windows"], 1)
    if not stats["ate_over_max_depth"] < ATE_OVER_MAX_DEPTH_LIMIT:
        raise AssertionError(
            f"{what}: ate_over_max_depth {stats['ate_over_max_depth']:.4f} is not under "
            f"{ATE_OVER_MAX_DEPTH_LIMIT}")
    return stats


def phase_standard_mode(splat, dataset, dev, label: str):
    """The standard mode at full size on the synchronous drive: tracker with
    compensation feeding VO, every other parameter at its default, no device
    given. Returns (its numbers, the run)."""
    from evo_tpu_torch.run.evaluator import EvaluatorParams
    from evo_tpu_torch.vo.frontend import VoParams

    # the card's first SVDs, Cholesky and forward-mode Jacobians pay one-time
    # set-up: warm up on the first keyframes (bootstrap, localization, BA)
    run_standard(splat, dataset, EvaluatorParams(pipelined=False), max_frames=5)
    sync = run_standard(splat, dataset, EvaluatorParams(pipelined=False))
    stats = check_standard(sync, "the synchronous standard mode")
    print(f"vo path, synchronous drive ({label}): " + json.dumps(stats), flush=True)
    both = sync["seen"] | sync["vo_seen"]
    if ({st for _, _, st in both} != {torch.cuda.default_stream(dev).cuda_stream}
            or any(t != "MainThread" for _, t, _ in both)
            or {k for k, _, _ in sync["vo_seen"]} != set(VO_LAUNCHES)):
        raise AssertionError(f"the synchronous drive launched off its thread or stream: {both}")

    # the VO geometry on the host instead, over the first 12 frames of both:
    # which of the two should do it?
    half = 12
    card = run_standard(splat, dataset, EvaluatorParams(pipelined=False), max_frames=half)
    host = run_standard(splat, dataset, EvaluatorParams(
        pipelined=False, vo=VoParams(geometry_backend="cpu")), max_frames=half)
    if host["ev"].vo.solve_devices != {"cpu"} or host["ev"].device.type != "cuda":
        raise AssertionError("geometry_backend='cpu' did not keep VO on the host")

    def side(r):
        vo = r["ev"].vo
        it = [i for i, *_ in vo.ba_log]
        return dict(vo_s=r["ev"].counters.times["vo"], vo_stage_s=dict(vo.stage_s),
                    keyframes=len(r["poses"]),
                    ba_mean_iterations=float(np.mean(it)) if it else None,
                    ate_over_max_depth=None if vo.last_ate is None
                    else vo.last_ate.rmse / MAX_DEPTH_M, wall_s=r["wall"])

    print(f"vo geometry, card against host, first {half} frames, synchronous drive "
          f"({label}): " + json.dumps(dict(card=side(card), host_cpu=side(host))), flush=True)
    return stats, sync, card


def phase_vo_repeats(splat, dataset, label: str, sync12: dict) -> dict:
    """The 12-frame synchronous standard mode once more, held to phase 7's
    12-frame run bit for bit: tracks, every keyframe pose and the ATE."""
    from evo_tpu_torch.run.evaluator import EvaluatorParams

    again = run_standard(splat, dataset, EvaluatorParams(pipelined=False), max_frames=12)
    check_standard(again, "the 12-frame synchronous run, again")
    if not np.array_equal(sync12["traj"], again["traj"]):
        raise AssertionError("the 12-frame synchronous run gave other tracks the second time")
    a, b = (np.stack(r["ev"].vo.poses()) for r in (sync12, again))
    ates = [r["ev"].vo.last_ate.rmse for r in (sync12, again)]
    out = dict(keyframes=[len(a), len(b)], ate_rmse_m=ates,
               max_pose_diff=float(np.abs(a - b).max()) if a.shape == b.shape else None,
               vo_s=[r["ev"].counters.times["vo"] for r in (sync12, again)])
    print(f"vo repeats itself, 12 frames, synchronous drive ({label}): " + json.dumps(out),
          flush=True)
    if a.shape != b.shape or not np.array_equal(a, b) or ates[0] != ates[1]:
        raise AssertionError(f"VO gave other poses on the same input: {out}")
    return out


def phase_pipelined(splat, dataset, dev, label: str, sync_stats: dict, sync: dict,
                    sync12: dict) -> dict:
    """The default drive against the synchronous run of the same call, and
    its two variants over the first 12 frames against the synchronous run of
    those frames."""
    from evo_tpu_torch.run.evaluator import EvaluatorParams
    from evo_tpu_torch.tracker.detector import TrackerParams

    default_stream = torch.cuda.default_stream(dev).cuda_stream
    if not (EvaluatorParams().pipelined and EvaluatorParams().async_vo
            and TrackerParams().device_policy):
        raise AssertionError("the defaults are not the pipelined drive")
    # the policy on the device and the workers' streams pay their set-up once
    run_standard(splat, dataset, EvaluatorParams(), max_frames=4)
    out = {"synchronous": sync_stats}
    sync12_stats = check_standard(sync12, "the synchronous standard mode, 12 frames")
    out["synchronous_12_frames"] = sync12_stats
    variants = {
        "pipelined": (EvaluatorParams(), None, sync, sync_stats),
        "pipelined_inline_vo": (EvaluatorParams(async_vo=False), 12, sync12, sync12_stats),
        "pipelined_host_policy": (EvaluatorParams(tracker=TrackerParams(device_policy=False)),
                                  12, sync12, sync12_stats),
    }
    for name, (params, frames, ref, ref_stats) in variants.items():
        r = run_standard(splat, dataset, params, max_frames=frames)
        stats = check_standard(r, name)
        stats["frames_run"] = frames or "all"
        stats.update(check_same_tracks(ref, r, name))
        stats["poses_max_diff"] = (float(np.abs(r["poses"] - ref["poses"]).max())
                                   if r["poses"].shape == ref["poses"].shape else None)
        out[name] = stats
        if stats["compensation_windows"] != ref_stats["compensation_windows"]:
            raise AssertionError(f"{name}: {stats['compensation_windows']} compensation "
                                 f"windows, {ref_stats['compensation_windows']} synchronous")
        if abs(stats["keyframes"] - ref_stats["keyframes"]) > 1:
            raise AssertionError(f"{name}: {stats['keyframes']} keyframes, "
                                 f"{ref_stats['keyframes']} synchronous")
        # every launch of compensation's kernels and of the splat belongs to
        # compensation: from the evo-comp thread, on its own stream
        streams = {st for _, _, st in r["seen"]}
        if (len(streams) != 1 or default_stream in streams
                or not all(t.startswith("evo-comp") for _, t, _ in r["seen"])
                or not any(k == "evo_comp_lm_step" for k, _, _ in r["seen"])):
            raise AssertionError(f"{name}: compensation was launched from {r['seen']}, not "
                                 "from the evo-comp thread on one stream of its own")
        # VO's kernels: on the default drive from the evo-vo thread on one
        # stream of its own, inline from the main thread
        vo_threads = {t for _, t, _ in r["vo_seen"]}
        vo_streams = {st for _, _, st in r["vo_seen"]}
        if name == "pipelined":
            if (vo_threads != {"evo-vo"} or len(vo_streams) != 1 or default_stream in vo_streams
                    or {k for k, _, _ in r["vo_seen"]} != set(VO_LAUNCHES)):
                raise AssertionError(f"{name}: VO's kernels were launched from {r['vo_seen']}, "
                                     "not from the evo-vo thread on one stream of its own")
            default_run = r
        elif name == "pipelined_inline_vo" and vo_threads != {"MainThread"}:
            raise AssertionError(f"{name}: VO's kernels were launched from {r['vo_seen']}")
    stages = sync_stats["stage_s"]
    out["synchronous_max_stage_s"] = max(stages.values())
    out["synchronous_sum_stage_s"] = sum(stages.values())
    print(f"pipelined path ({label}): " + json.dumps(out), flush=True)
    return out, default_run


def phase_tracks_window(splat, trajectories, window, dev, label: str) -> None:
    """One window of track-field compensation on the card."""
    from evo_tpu_torch.tracker import motion_field as mf

    x, y, t_us = window
    t_mid = 0.5 * (float(t_us[0]) + float(t_us[-1]))
    n_samples = len(mf.velocities_from_trajectories(trajectories, int(t_mid))[0])
    mf.compensate_from_tracks(trajectories, x, y, t_us)  # the stencils' first launches
    reset_counts(splat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field, img = mf.compensate_from_tracks(trajectories, x, y, t_us)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(splat)
    # every launch of the window, the stencils' included, from the profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mf.compensate_from_tracks(trajectories, x, y, t_us)
        torch.cuda.synchronize()
    all_launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    # the warp of `compensate_events_field`, on the host
    xi = np.clip(np.round(x).astype(np.int64), 0, 239)
    yi = np.clip(np.round(y).astype(np.int64), 0, 179)
    dt = (t_mid - t_us.astype(np.float64)) * mf.COMPENSATE_SCALE
    cx = np.round(x + dt * field[yi, xi, 0])
    cy = np.round(y + dt * field[yi, xi, 1])
    inside = int(((cx >= 0) & (cx < 240) & (cy >= 0) & (cy < 180)).sum())
    print(f"tracks window ({label}): " + json.dumps(dict(
        events=len(x), velocity_samples=n_samples, seconds=seconds, launches=launches,
        launches_of_any_kernel=all_launches,
        field_abs_max=float(np.abs(field).max()), image_sum=float(img.sum()),
        events_inside=inside)), flush=True)
    if n_samples < 1:
        raise AssertionError("no track gives a velocity at the first window's mid time")
    if field.shape != (180, 240, 2) or not np.isfinite(field).all():
        raise AssertionError("the track field is not finite")
    if img.sum() != inside:
        raise AssertionError(f"count image sums to {img.sum()}, {inside} events lie inside")
    if launches["splat_fwd"] != 1:
        raise AssertionError(f"the tracks window launched splat_fwd {launches['splat_fwd']} times")


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR; raises unless the file starts with
    the PNG signature and an IHDR chunk."""
    import struct

    from evo_tpu_torch.io.png import SIGNATURE

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def phase_runtime_extras(splat, dataset, dev, label: str, sync: dict, trajectories) -> dict:
    """Checkpoint and resume, the watchdog, the profiler, the debug views
    and the quality and precision reports on the card (phase 10, (a)-(e))."""
    import os
    import shutil

    from evo_tpu_torch.io.replay import FrameWindowIterator
    from evo_tpu_torch.run import checkpoint, metrics, precision_report, quality, viz
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.run.watchdog import WatchdogParams
    from evo_tpu_torch.tracker import align

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) resume on the synchronous drive, compensation on
        t0 = time.perf_counter()
        first = Evaluator(dataset, EvaluatorParams(pipelined=False, output_dir=tmp))
        first.run(max_frames=12)
        path = checkpoint.save_checkpoint(os.path.join(tmp, "ckpt"), first)
        resumed = checkpoint.load_checkpoint(path, dataset, EvaluatorParams(
            pipelined=False, output_dir=os.path.join(tmp, "resumed")))
        if resumed.image_num != 12 or resumed.device.type != "cuda":
            raise AssertionError(f"restored at frame {resumed.image_num} on {resumed.device}")
        reset_counts(splat)
        resumed.run(start_frame=resumed.image_num)
        launches = counts(splat)
        paths = resumed.finish()
        run = dict(ev=resumed, traj=np.loadtxt(paths["trajectory"], ndmin=2),
                   poses=np.loadtxt(paths["vo_trajectory"], ndmin=2))
        res = dict(seconds=time.perf_counter() - t0, launches_after_resume=launches,
                   **check_same_tracks(sync, run, "the resumed run"))
        ate = resumed.vo.last_ate
        res["keyframes"] = len(run["poses"])
        res["ate_over_max_depth"] = None if ate is None else ate.rmse / MAX_DEPTH_M
        if not np.isfinite(run["poses"]).all() or ate is None:
            raise AssertionError("the resumed run's VO poses are not finite, or it has no ATE")
        if not res["ate_over_max_depth"] < ATE_OVER_MAX_DEPTH_LIMIT:
            raise AssertionError(f"the resumed run's ate_over_max_depth "
                                 f"{res['ate_over_max_depth']} is not under the limit")
        check_compensation_kernels(launches, "the resumed run")
        if "motion_field_max_diff" not in res:
            raise AssertionError("the resumed run solved no compensation window")
        out["resume"] = res

        # (d) the debug views of the resumed run's state, on the card
        t0 = time.perf_counter()
        live = torch.nonzero(resumed.tracker.table.alive).flatten()
        row = int(live[0])
        nabla = align.predicted_nabla(resumed.tracker.table, resumed.tracker.grads)
        cmap = align.cost_map(resumed.tracker.table, resumed.tracker.grads, row)
        if not (nabla.is_cuda and cmap.is_cuda and bool(torch.isfinite(nabla).all())
                and bool(torch.isfinite(cmap).all()) and tuple(cmap.shape) == (11, 11)):
            raise AssertionError("predicted_nabla / cost_map not finite or not on the card")
        views = viz.save_patch_views(os.path.join(tmp, "views"), resumed.tracker, row)
        frame = dataset.image_u8(dataset.num_images - 1).astype(np.float32) / 255.0
        views["overlay"] = viz.save_rgb(os.path.join(tmp, "views", "overlay.png"),
                                        viz.render_feature_overlay(frame, resumed.tracker))
        views["compensated"] = viz.save_gray(os.path.join(tmp, "views", "compensated.png"),
                                             resumed.compensated_image)
        sizes = {k: png_size(v) for k, v in views.items()}
        want = {"integrated_nabla": (25, 25), "predicted_nabla": (25, 25),
                "cost_map": (11, 11), "overlay": (240, 180), "compensated": (240, 180)}
        if sizes != want:
            raise AssertionError(f"PNG sizes {sizes}, expected {want}")
        out["views"] = dict(seconds=time.perf_counter() - t0, png_sizes=sizes, patch_row=row)

        # (b) the watchdog on the default drive, a NaN centre injected
        t0 = time.perf_counter()
        params = EvaluatorParams(output_dir=os.path.join(tmp, "wd"), watchdog=True,
                                 watchdog_params=WatchdogParams(
                                     auto_checkpoint_every=4,
                                     checkpoint_path=os.path.join(tmp, "auto.npz")))
        ev = Evaluator(dataset, params)
        check_threads = []
        vo_check = ev.monitor.vo_check_task

        def recording_check(e):
            check_threads.append(threading.current_thread().name)
            vo_check(e)

        ev.monitor.vo_check_task = recording_check
        check_s = []
        after_window = ev.monitor.after_window

        def timed_window(*args, **kwargs):
            t = time.perf_counter()
            after_window(*args, **kwargs)
            check_s.append(time.perf_counter() - t)

        ev.monitor.after_window = timed_window
        saved = []
        save = checkpoint.save_checkpoint

        def keeping(path, e):
            in_flight = len(e._pending_frames)
            written = save(path, e)
            keep = os.path.join(tmp, f"auto_{len(saved)}.npz")
            shutil.copy(written, keep)
            saved.append((keep, e.image_num, in_flight))
            return written

        checkpoint.save_checkpoint = keeping
        reset_counts(splat)
        try:
            for win in FrameWindowIterator(dataset):
                if win.frame_idx >= 12:
                    break
                ev._process_window_pipelined(win)
                if win.frame_idx == 2:  # the third window: a NaN centre in a live row
                    t = ev.tracker.table
                    live = torch.nonzero(t.alive).flatten()
                    center = t.center.clone()
                    center[live[0]] = float("nan")
                    ev.tracker.table = t.replace(center=center)
            paths = ev.finish()
        finally:
            checkpoint.save_checkpoint = save
        launches = counts(splat)
        wd = dict(run=dict(ev=ev, traj=np.loadtxt(paths["trajectory"], ndmin=2),
                           poses=np.loadtxt(paths["vo_trajectory"], ndmin=2)))
        kinds = sorted({f.kind for f in ev.monitor.failures})
        surviving = ev.tracker.table.center[ev.tracker.table.alive]
        if ev.monitor.recovered_patches < 1 or "patch_nonfinite" not in kinds:
            raise AssertionError(f"the NaN row was not quarantined: {ev.monitor.summary()}")
        if not (bool(torch.isfinite(surviving).all()) and np.isfinite(wd["run"]["traj"]).all()
                and np.isfinite(wd["run"]["poses"]).all()):
            raise AssertionError("the watchdog run left a non-finite centre or artifact")
        if not check_threads or set(check_threads) != {"evo-vo"}:
            raise AssertionError(f"the VO check ran on {check_threads}, not on evo-vo")
        if [(n, k > 0) for _, n, k in saved] != [(4, True), (8, True), (12, True)]:
            raise AssertionError(f"auto-checkpoints at (frame, windows in flight) "
                                 f"{[(n, k) for _, n, k in saved]}, expected frames 4, 8 "
                                 "and 12, each with windows in flight")
        back = checkpoint.load_checkpoint(saved[0][0], dataset, EvaluatorParams(
            output_dir=os.path.join(tmp, "wd_resumed")))
        reset_counts(splat)
        back.run(max_frames=12, start_frame=back.image_num)
        paths = back.finish()
        resumed_launches = counts(splat)
        if back.image_num != 12 or resumed_launches["comp_tile"] <= 0:
            raise AssertionError(f"the resume from frame {saved[0][1]} ended at frame "
                                 f"{back.image_num} with launches {resumed_launches}")
        same = check_same_tracks(wd["run"], dict(
            ev=back, traj=np.loadtxt(paths["trajectory"], ndmin=2)), "the watchdog resume")
        out["watchdog"] = dict(
            seconds=time.perf_counter() - t0, failures=kinds,
            recovered_patches=ev.monitor.recovered_patches, windows=ev.monitor.windows,
            vo_checks=len(check_threads),
            checkpoints_at_frame=[n for _, n, _ in saved],
            windows_in_flight_at_checkpoint=[k for _, _, k in saved],
            frames_after_resume=back.image_num - saved[0][1],
            check_ms_per_window=1e3 * float(np.mean(check_s)),
            check_ms_max=1e3 * max(check_s),
            launches=launches, launches_after_resume=resumed_launches, **same)

        # (c) the profiler around two frame windows of the default drive
        t0 = time.perf_counter()
        ev = Evaluator(dataset, EvaluatorParams(output_dir=os.path.join(tmp, "prof")))
        reset_counts(splat)
        with metrics.profile_trace(os.path.join(tmp, "trace")):
            ev.run(max_frames=2)
        launches = counts(splat)
        ev.finish()
        trace_path = os.path.join(tmp, "trace", "trace.json")
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        comps = [e for e in kernels if "comp_" in e.get("name", "")]
        streams = sorted({e.get("args", {}).get("stream") for e in comps}, key=str)
        out["profile"] = dict(
            seconds=time.perf_counter() - t0, trace_mb=os.path.getsize(trace_path) / 1e6,
            kernels=len(kernels), compensation_kernels=len(comps),
            compensation_streams=streams, launches=launches,
            device_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
            compensation_device_ms=sum(e.get("dur", 0) for e in comps) / 1e3)
        if not any("comp_tile_kernel" in e["name"] for e in comps) or not any(
                "comp_lm_step_kernel" in e["name"] for e in comps):
            raise AssertionError("the trace does not name compensation's kernels")

    # (e) the tracker's quality on phase 5's tracks, and the precision report
    t0 = time.perf_counter()
    q = quality.evaluate_tracker(trajectories, dataset.gt_t_us, dataset.gt_poses,
                                 dataset.calib, plane_depth=2.0, scene="3walls")
    out["quality"] = dict(seconds=time.perf_counter() - t0,
                          tracker_err_px=q.mean_distance_error_px,
                          tracker_err_median_px=q.median_distance_error_px,
                          feature_age_s=q.mean_feature_age_s, num_tracks=q.num_tracks)
    print(f"quality of the tracker experiment's tracks ({label}): "
          + json.dumps(out["quality"]), flush=True)
    if not (q.num_tracks > 0 and np.isfinite(q.mean_distance_error_px)):
        raise AssertionError("evaluate_tracker scored no track")
    t0 = time.perf_counter()
    rep = precision_report.build_report(reps=1)
    rep["seconds"] = time.perf_counter() - t0
    print(f"precision report ({label}): " + json.dumps(rep), flush=True)
    if rep["backend"] != "cuda" or max(
            e["plain_f32_max_rel_err"] for e in rep["assembly_vs_f64_oracle"].values()) > 1e-5:
        raise AssertionError("the precision report did not run on the card, or its "
                             "assembly is off by more than 1e-5")
    out["precision_seconds"] = rep["seconds"]
    print(f"run-time extras ({label}): " + json.dumps(out), flush=True)
    return out


def phase_large_tiles(splat, window, dev) -> dict:
    """`compensate_window` with 40 px tiles (6 x 4 on DAVIS240C): kernel A
    takes their 120x120 padded images (the loss in strips of pool rows),
    kernel B the loop."""
    from evo_tpu_torch.tracker import compensate as comp

    params = comp.CompensateParams(tile=40, max_iters=8)
    reset_counts(splat)
    check_window(comp, (*window, params), dev, "first window, 40 px tiles")
    launches = counts(splat)
    print("large tiles (40 px): " + json.dumps(launches), flush=True)
    check_compensation_kernels(launches, "the 40 px tiles")
    if launches["splat_bwd"]:  # autograd through the generic splat: the plain version
        raise AssertionError(f"the 40 px tiles took the plain version: {launches}")
    return launches


def phase_batched_kernels(splat, timer, dev, label: str) -> list[dict]:
    """The fused entries at the batched solve's shapes [W·108, 1024], against
    their plain versions."""
    from evo_tpu_torch.tracker.compensate import GAUSS_NORM

    gen = torch.Generator(device="cpu").manual_seed(4)
    side = 3 * TILE
    wkw = dict(scale=1e-3, tile=TILE, weight=GAUSS_NORM, sigma=1.0, radius=3)
    cfg = (1e-3, TILE, GAUSS_NORM, "gaussian", 1.0, 3)
    rows = []
    for w in BATCHES:
        parts = [tile_inputs(1024, gen, dev) for _ in range(w)]
        vel, ex, ey, dt_us, valid, tlx, tly = (torch.cat(a).contiguous() for a in zip(*parts))
        events = (ex, ey, dt_us, valid, tlx, tly)
        t, e = ex.shape
        n_valid = float(valid.sum())
        img_bytes = t * side * side * 4
        ev_bytes = t * e * 13 + t * 4 * 4
        out = splat.warp_splat(vel, *events, **wkw)
        ref = splat.warp_splat_ref(vel, *events, **wkw)
        torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
        g = torch.randn(t, side, side, generator=gen).to(dev)
        v = vel.clone().requires_grad_(True)
        (splat.warp_splat_ref(v, *events, **wkw) * g).sum().backward()
        g = g / v.grad.abs().max()
        want = v.grad / v.grad.abs().max()
        got = splat._warp_backward(vel, events, cfg, g)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)

        def plain_bwd():
            v_ = vel.clone().requires_grad_(True)
            (splat.warp_splat_ref(v_, *events, **wkw) * g).sum().backward()

        for name, err, fn, plain, n_bytes, n_flops in (
                ("warp_splat_fwd", (out - ref).abs().max().item(),
                 lambda: splat.warp_splat(vel, *events, **wkw),
                 lambda: splat.warp_splat_ref(vel, *events, **wkw),
                 ev_bytes + img_bytes, gauss_flops(n_valid) + 8 * t * e),
                ("warp_splat_bwd", (got - want).abs().max().item(),
                 lambda: splat._warp_backward(vel, events, cfg, g), plain_bwd,
                 ev_bytes + img_bytes + t * 2 * 4, gauss_flops(n_valid) * 2 + 12 * t * e)):
            b_ms, by = bound(n_bytes, n_flops)
            rows.append(dict(kernel=name, shape=f"gaussian [{t}, {e}] -> [{side}, {side}]",
                             max_abs_err=err, ms=timer.device_ms(fn, REPS),
                             host_us=timer.host_us(fn, REPS), plain_ms=timer.device_ms(plain, 5),
                             bound_ms=b_ms, bound_by=by, w=w))
    for r in rows:
        print(f"kernel {r['kernel']:14s} {r['shape']:34s} max_abs_err {r['max_abs_err']:.3e}  "
              f"device {r['ms'] * 1e3:.2f} us/launch over {REPS}  wrapper host "
              f"{r['host_us']:.2f} us  bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})  "
              f"plain {r['plain_ms'] * 1e3:.2f} us ({label})", flush=True)
    return rows


def compensation_windows(dataset) -> list:
    """The scene's compensation windows as the evaluator cuts them at the
    defaults: the events of its frame windows in consecutive blocks of
    15,000 (at ~1.1 Mev/s the 300 ms limit never closes one first); the
    remainder makes none."""
    from evo_tpu_torch.io.replay import FrameWindowIterator

    wins = [w.events for w in FrameWindowIterator(dataset)]
    x, y, t_us = (np.concatenate([getattr(e, k) for e in wins]) for k in ("x", "y", "t_us"))
    return [(x[i:i + WINDOW_EVENTS].astype(np.float64),
             y[i:i + WINDOW_EVENTS].astype(np.float64),
             t_us[i:i + WINDOW_EVENTS].astype(np.int64))
            for i in range(0, len(x) - WINDOW_EVENTS + 1, WINDOW_EVENTS)]


def phase_temporal_windows(splat, windows, dev, label: str) -> dict:
    """(a): every window cold, one by one and in batches of W: bit for bit
    the same field and costs."""
    from evo_tpu_torch.dist import temporal
    from evo_tpu_torch.tracker import compensate as comp

    temporal.compensate_windows_batched(windows[:2], device=dev)  # batched set-up
    out, results = {}, {}
    for w in (1,) + BATCHES:
        reset_counts(splat)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if w == 1:
            res = [comp.compensate_window(*win, device=dev) for win in windows]
        else:
            res = [r for i in range(0, len(windows), w)
                   for r in temporal.compensate_windows_batched(windows[i:i + w], device=dev)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts(splat)
        calls = -(-len(windows) // w)
        # the LM's reads of its stop flag, and one copy to the host per call
        out[f"W={w}"] = dict(seconds=seconds, windows=len(res), calls=calls,
                             comp_tile=launches["comp_tile"], comp_step=launches["comp_step"],
                             warp_splat_fwd=launches["warp_splat_fwd"],
                             warp_splat_bwd=launches["warp_splat_bwd"],
                             count_splats=launches["splat_fwd"],
                             host_reads=launches["comp_host_reads"] + calls)
        results[w] = res
    ref = results[1]
    for w in BATCHES:
        errs = dict(cost0_rel=0.0, vel=0.0, img=0.0)
        same = True
        for (v1, i1, c1, c01), (v, i, c, c0) in zip(ref, results[w]):
            errs["cost0_rel"] = max(errs["cost0_rel"], abs(c0 - c01) / abs(c01))
            errs["vel"] = max(errs["vel"], float(np.abs(v - v1).max()))
            errs["img"] = max(errs["img"], float(np.abs(i - i1).max()))
            same = same and np.array_equal(v, v1) and c == c1 and c0 == c01
        out[f"W={w}"]["max_diff_to_W=1"] = errs
        out[f"W={w}"]["bitwise_to_W=1"] = same
        out[f"W={w}"]["speedup_vs_W=1"] = out["W=1"]["seconds"] / out[f"W={w}"]["seconds"]
        # one block a tile row and one a window: a window's field and costs
        # do not depend on the windows solved beside it
        if not same or errs["img"] > 1e-3:
            raise AssertionError(f"W={w}: batched windows differ from the one-window solves "
                                 f"by {errs}")
        if out[f"W={w}"]["comp_tile"] <= 0 or out[f"W={w}"]["comp_step"] <= 0:
            raise AssertionError(f"W={w} never launched comp_tile or comp_step")
    print(f"temporal batching, {len(windows)} windows ({label}): " + json.dumps(out), flush=True)
    return out


def phase_temporal_drive(splat, dataset, dev, label: str, sync12: dict) -> dict:
    """(b): the default drive with temporal_batch=8, the first 12 frames,
    beside the same drive without it."""
    from evo_tpu_torch.run.evaluator import EvaluatorParams

    default_stream = torch.cuda.default_stream(dev).cuda_stream
    per_window = run_standard(splat, dataset, EvaluatorParams(), max_frames=12)
    r = run_standard(splat, dataset, EvaluatorParams(temporal_batch=8), max_frames=12)
    stats = check_standard(r, "the default drive with temporal_batch=8")
    stats["per_window_drive"] = dict(
        wall_s=per_window["wall"], stage_s=dict(per_window["ev"].counters.times),
        launches=per_window["launches"], synchronous_wall_s=sync12["wall"])
    stats.update(check_same_tracks(sync12, r, "the default drive with temporal_batch=8",
                                   fields=False))
    streams = {st for _, _, st in r["seen"]}
    if (len(streams) != 1 or default_stream in streams
            or not all(t.startswith("evo-comp") for _, t, _ in r["seen"])):
        raise AssertionError(f"temporal batches launched from {r['seen']}, not from the "
                             "evo-comp thread on one stream of its own")
    if "compensation_batched" not in stats["stage_s"]:
        raise AssertionError("no temporal batch was solved")
    print(f"temporal batch drive, 12 frames ({label}): " + json.dumps(stats), flush=True)
    return stats


def _plain_normal_equations(poses, pts, intr, of, ol, op, om, fixed):
    """The BA normal-equation blocks in float64 with one device's
    index_add_: the sharded reduction's unsharded counterpart."""
    from evo_tpu_torch.solve.lm import huber_weights
    from evo_tpu_torch.vo.ba import _obs_linearize

    F, L = poses.shape[0], pts.shape[0]
    r, Jp, Jl = (a.double() for a in _obs_linearize(poses[of], pts[ol], intr, op))
    w = huber_weights((r * r).sum(-1), 0.8) * om.double()
    Jp = torch.where(fixed[of][:, None, None], torch.zeros_like(Jp), Jp)
    wr, Jpw = r * w[:, None], Jp * w[:, None, None]
    z = partial(torch.zeros, dtype=torch.float64, device=poses.device)
    return (z((F, 6, 6)).index_add_(0, of, Jpw.transpose(1, 2) @ Jp),
            z((L, 3, 3)).index_add_(0, ol, (Jl * w[:, None, None]).transpose(1, 2) @ Jl),
            z((L * F, 6, 3)).index_add_(0, ol * F + of, Jpw.transpose(1, 2) @ Jl)
            .reshape(L, F, 6, 3),
            z((F, 6)).index_add_(0, of, (Jp.transpose(1, 2) @ wr[..., None])[..., 0]),
            z((L, 3)).index_add_(0, ol, (Jl.transpose(1, 2) @ wr[..., None])[..., 0]))


def ba_problem(dev, n_frames=6, n_points=40, seed=0):
    """Cameras on an arc looking at a point cloud (the scene of the BA
    tests), its observations padded to a multiple of 8."""
    from evo_tpu_torch.core import camera, lie
    from evo_tpu_torch.core.types import CalibParams

    rng = np.random.default_rng(seed)
    intr = torch.tensor(CalibParams(fx=199.0, fy=198.0, cx=132.0, cy=110.0).to_list(),
                        dtype=torch.float32, device=dev)
    poses = torch.stack([lie.se3_exp(torch.tensor(
        [0.4 * i, 0.02 * i, 0.01 * i, 0.0, 0.05 * i, 0.0], device=dev)) for i in range(n_frames)])
    pts = torch.tensor(np.stack([rng.uniform(-2, 3.5, n_points), rng.uniform(-1.5, 1.5, n_points),
                                 rng.uniform(5, 9, n_points)], -1), dtype=torch.float32, device=dev)
    of, ol, op = [], [], []
    for f in range(n_frames):
        p_cam = lie.se3_apply(lie.se3_inverse(poses[f]), pts)
        pix = camera.project(intr, p_cam)
        ok = (p_cam[:, 2] > 0.5) & (pix[:, 0] > 5) & (pix[:, 0] < 235) & (pix[:, 1] > 5) \
            & (pix[:, 1] < 175)
        for i in torch.nonzero(ok).flatten().tolist():
            of.append(f)
            ol.append(i)
            op.append((pix[i] + torch.tensor(rng.normal(0, 0.5, 2), device=dev)).tolist())
    pad = (-len(of)) % 8
    mask = [True] * len(of) + [False] * pad
    of, ol, op = of + [0] * pad, ol + [0] * pad, op + [[0.0, 0.0]] * pad
    fixed = torch.zeros(n_frames, dtype=torch.bool, device=dev)
    fixed[:2] = True
    return (poses, pts, intr, torch.tensor(of, device=dev), torch.tensor(ol, device=dev),
            torch.tensor(op, dtype=torch.float32, device=dev),
            torch.tensor(mask, device=dev), fixed)


def gloo_on_cuda_rank():
    """One rank of the gloo probe: the collectives the port's dist/ uses, on
    CUDA tensors; returns {collective: "ok" or the error}. Point to point
    (the halo exchange's `batch_isend_irecv`) is left out: gloo writes from
    the device pointer, and its transport thread then aborts the process
    (`gloo::IoException`, writev: Bad address) or raises."""
    import torch.distributed as dist

    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    trials = {
        "all_reduce": lambda: dist.all_reduce(torch.full((4,), rank + 1.0, device=dev)),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(2)], torch.ones(4, device=dev)),
        "broadcast": lambda: dist.broadcast(torch.ones(4, device=dev), src=0),
    }
    out = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # the probe's finding, printed by the phase
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def phase_mesh(splat, dataset, dev, label: str) -> dict:
    """(c): a one-rank mesh over NCCL on the card, each sharded function
    against its one-device computation; then the two-rank gloo probe."""
    import os
    import torch.distributed as dist

    from evo_tpu_torch.dist import mesh, multihost, reduce, tiling
    from evo_tpu_torch.tracker import compensate as comp

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        multihost.initialize("file://" + os.path.join(tmp, "rendezvous"), 1, 0, device=dev)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the card's process group runs {dist.get_backend()}")
            m = mesh.make_mesh()
            ev = dataset.events.slice(0, WINDOW_EVENTS)
            x, y = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (ev.x, ev.y))
            w = torch.ones_like(x)
            reset_counts(splat)
            got = tiling.sharded_splat(m, x, y, w, 180, 240, device=dev)
            launched = counts(splat)["splat_fwd"]
            want = splat.splat_image(x, y, w, 180, 240)
            err_splat = (got - want).abs().max().item()
            if not got.is_cuda or launched != 1 or err_splat > 1e-4:
                raise AssertionError(f"sharded_splat on the card: {launched} launches, "
                                     f"off by {err_splat}")
            p = comp.CompensateParams(max_iters=8)
            data, edges, ty, tx, _, _ = comp.build_tile_data(
                ev.x.astype(np.float64), ev.y.astype(np.float64), ev.t_us.astype(np.int64),
                p, 180, 240, dev)
            kw = dict(tile=p.tile, scale=p.scale, tv_weight=p.tv_weight,
                      tv_huber=p.tv_huber, max_iters=p.max_iters)
            v_sh, c_sh, c0_sh = tiling.sharded_tile_solve_data(m, data, ty=ty, tx=tx, **kw)
            v_1, c_1, c0_1 = comp.solve_motion_field(data, edges, **kw)
            err_v = (v_sh - v_1).abs().max().item()
            err_c0 = abs(float(c0_sh) - float(c0_1)) / float(c0_1)
            if err_c0 > 1e-5 or err_v > 5e-3:
                raise AssertionError(f"sharded tile solve off by {err_v} px/ms, cost0 {err_c0}")
            prob = ba_problem(dev)
            got_ne = reduce.sharded_normal_equations(m, *prob, device=dev)
            want_ne = _plain_normal_equations(*prob)
            err_ne = {}
            for name, g, r in zip(("Hpp", "Hll", "A", "bp", "bl"), got_ne, want_ne):
                err_ne[name] = ((g.double() - r).abs().max() / r.abs().max().clamp_min(1e-12)).item()
                if not g.is_cuda or err_ne[name] > 1e-4:
                    raise AssertionError(f"sharded {name} off by {err_ne[name]} (relative)")
            out["nccl_one_rank"] = dict(
                seconds=time.perf_counter() - t0, splat_max_abs_err=err_splat,
                tile_solve_vel_max_diff=err_v, tile_solve_cost0_rel=err_c0,
                tile_solve_cost=[float(c_sh), float(c_1)],
                normal_equations_rel_err=err_ne)
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    probe = multihost.launch(gloo_on_cuda_rank, 2, device=dev, backend="gloo", timeout_s=180.0)
    out["gloo_two_ranks_on_one_card"] = dict(seconds=time.perf_counter() - t0,
                                             rank0=probe[0], rank1=probe[1])
    print(f"mesh on the card ({label}): " + json.dumps(out), flush=True)
    return out


def mesh_rank(dataset, frames: int) -> dict:
    """One rank of 12 (b): the standard mode on the default drive over the
    first `frames` frames on a (1, n) mesh of the world's ranks, no device
    given; its trajectory.txt, device, table rows, splat launches, keyframes
    and ATE."""
    import torch.distributed as dist

    from evo_tpu_torch.dist import mesh
    from evo_tpu_torch.kernels import splat
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    m = mesh.make_mesh(1, dist.get_world_size())
    with tempfile.TemporaryDirectory() as tmp:
        ev = Evaluator(dataset, EvaluatorParams(mesh=m, output_dir=tmp))
        reset_counts(splat)
        t0 = time.perf_counter()
        ev.run(max_frames=frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts(splat)
        paths = ev.finish()
        with open(paths["trajectory"], "rb") as f:
            traj = f.read()
        keyframes = len(np.loadtxt(paths["vo_trajectory"], ndmin=2))
    ate = ev.vo.last_ate
    return dict(rank=dist.get_rank(), backend=dist.get_backend(), device=str(ev.device),
                table_rows=ev.tracker.table.capacity, wall_s=wall, launches=launches,
                stage_s=dict(ev.counters.times), keyframes=keyframes,
                ate_over_max_depth=None if ate is None else ate.rmse / MAX_DEPTH_M,
                trajectory=traj)


def block_split_check(dev) -> dict:
    """The window scan of a 128-row ready table on the card against the same
    rows scanned as two blocks of 64, as two ranks hold them: whether a
    row's result moves with the batch's shape (bit for bit, it must not)."""
    from evo_tpu_torch.dist import multihost
    from evo_tpu_torch.tracker import align
    from evo_tpu_torch.tracker import patch_state as ps

    t = multihost._ready_table(np.random.default_rng(1), 128, 180, 240)
    ex, ey, et, ep, mask, grads = multihost._scan_inputs(np.random.default_rng(2), 2, 2048,
                                                         180, 240)
    ev = [torch.as_tensor(a).to(dev) for a in (ex, ey, et, ep, mask)]
    g = torch.as_tensor(grads).to(dev)
    full, log = align.process_window_scan(ps.table_from_numpy(t, dev), g, *ev, g[0])
    halves = [align.process_window_scan(
        ps.table_from_numpy({k: v[s] for k, v in t.items()}, dev), g, *ev, g[0])
        for s in (slice(0, 64), slice(64, 128))]
    center = torch.cat([h[0].center for h in halves])
    cost = torch.cat([h[1]["cost"] for h in halves], 1)
    return dict(center_max_diff_px=(center - full.center).abs().max().item(),
                cost_max_diff=(cost - log["cost"]).abs().max().item(),
                bitwise=bool(torch.equal(center, full.center) and torch.equal(cost, log["cost"])))


def compare_tracks(ref: np.ndarray, run: np.ndarray) -> dict:
    """trajectory.txt rows of two runs, matched by (track id, timestamp)."""
    a = {(int(r[0]), int(round(r[1] * 1e6))): r[2:] for r in ref}
    b = {(int(r[0]), int(round(r[1] * 1e6))): r[2:] for r in run}
    both = sorted(a.keys() & b.keys())
    d = np.array([np.abs(a[k] - b[k]).max() for k in both])
    return dict(rows=[len(ref), len(run)], unmatched=len(a.keys() ^ b.keys()),
                tracks=[len({k[0] for k in a}), len({k[0] for k in b})],
                max_diff_px=float(d.max()), median_diff_px=float(np.median(d)),
                share_within_1e3=float(np.mean(d <= 1e-3)),
                share_within_0_1=float(np.mean(d <= 0.1)))


def phase_meshed(splat, dataset, dev, label: str, default_run: dict, sync12: dict) -> dict:
    """Phase 12: the meshed path, (a)-(d)."""
    import hashlib
    import io
    import os

    import torch.distributed as dist

    from evo_tpu_torch.dist import mesh, multihost
    from evo_tpu_torch.run.evaluator import EvaluatorParams

    t_phase = time.perf_counter()
    out = {}
    ref = default_run
    ref_stats = check_standard(ref, "the unmeshed default drive")
    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "rendezvous"), 1, 0, device=dev)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"the card's process group runs {dist.get_backend()}")
            # (a) the slice at full width, one NCCL rank
            run = run_standard(splat, dataset, EvaluatorParams(mesh=mesh.make_mesh()))
            stats = check_standard(run, "the meshed default drive")
            stats.update(check_same_tracks(ref, run, "the meshed default drive"))
            if run["ev"].tracker.mesh is None or run["ev"].tracker.table.capacity != 128:
                raise AssertionError("the meshed run's tracker holds no mesh")
            if abs(stats["ate_over_max_depth"] - ref_stats["ate_over_max_depth"]) > 1e-4:
                raise AssertionError(f"meshed ATE {stats['ate_over_max_depth']} against "
                                     f"{ref_stats['ate_over_max_depth']} unmeshed")
            if abs(stats["keyframes"] - ref_stats["keyframes"]) > 1:
                raise AssertionError(f"meshed: {stats['keyframes']} keyframes, "
                                     f"{ref_stats['keyframes']} unmeshed")
            # the meshed solve keeps its host loop: kernel B's solve entry at
            # each trip where the unmeshed loop launches its loop entry
            shared = ("splat_fwd", "splat_bwd", "align_step", "comp_tile")
            if any(run["launches"][k] != ref["launches"][k] for k in shared) \
                    or run["launches"]["comp_step_solve"] <= 0:
                raise AssertionError(f"meshed launches {run['launches']} against "
                                     f"{ref['launches']} unmeshed")
            stats["unmeshed"] = dict(wall_s=ref_stats["wall_s"], stage_s=ref_stats["stage_s"],
                                     launches=ref_stats["launches"])
            out["a"] = stats
            print(f"meshed path, one NCCL rank, all frames ({label}): " + json.dumps(stats),
                  flush=True)
            # (c), first half: the parity check on this NCCL rank
            t0 = time.perf_counter()
            parity = multihost.parity_worker(dev)
            if not (parity["ok"] and parity["device"].startswith("cuda")):
                raise AssertionError(f"parity_worker on the card: {parity}")
            parity["seconds"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()

    # (b) two gloo ranks on the one card, a (1, 2) mesh. Each holds 64 rows;
    # the two ranks agree byte for byte, the unmeshed run to the bars below
    t0 = time.perf_counter()
    ranks = multihost.launch(mesh_rank, 2, (dataset, 12), device=dev, backend="gloo",
                             timeout_s=300.0)
    sync12_stats = check_standard(sync12, "the synchronous standard mode, 12 frames")
    for r in ranks:
        if not r["device"].startswith("cuda") or r["backend"] != "gloo" or r["table_rows"] != 64:
            raise AssertionError(f"rank {r['rank']} ran on {r['device']} over "
                                 f"{r['backend']} with {r['table_rows']} rows")
        if r["trajectory"] != ranks[0]["trajectory"]:
            raise AssertionError(f"rank {r['rank']}'s trajectory.txt is not rank 0's")
        if (min(r["launches"][k] for k in ("splat_fwd", "comp_tile", "comp_step",
                                           "align_step", "frame_policy")) <= 0
                or r["launches"]["route_events"] != r["launches"]["align_step"]):
            raise AssertionError(f"rank {r['rank']} launched {r['launches']}")
        if not (r["ate_over_max_depth"] is not None
                and r["ate_over_max_depth"] < ATE_OVER_MAX_DEPTH_LIMIT
                and abs(r["keyframes"] - sync12_stats["keyframes"]) <= 1):
            raise AssertionError(f"rank {r['rank']}: ATE {r['ate_over_max_depth']}, "
                                 f"{r['keyframes']} keyframes")
    tracks = compare_tracks(sync12["traj"], np.loadtxt(
        io.StringIO(ranks[0]["trajectory"].decode()), ndmin=2))
    # the bars: a row's solve does not depend on the rows beside it (the
    # alignment kernel, one block per row), so the ranks reproduce the
    # unmeshed run's tracks: every row matched, every matched row within
    # 1e-3 px (as the default drive reproduces the synchronous one), the ATE
    # within twice the unmeshed run's
    split = block_split_check(dev)
    if not split["bitwise"]:
        raise AssertionError(f"a 128-row scan against two 64-row blocks: {split}")
    if not (tracks["unmatched"] == 0 and tracks["share_within_1e3"] == 1.0):
        raise AssertionError(f"two gloo ranks against the synchronous run: {tracks}")
    for r in ranks:
        if r["ate_over_max_depth"] > 2 * sync12_stats["ate_over_max_depth"]:
            raise AssertionError(f"rank {r['rank']}: ATE {r['ate_over_max_depth']} against "
                                 f"{sync12_stats['ate_over_max_depth']} unmeshed")
    out["b"] = dict(seconds=time.perf_counter() - t0, against_synchronous_12=tracks,
                    block_split=split,
                    ranks=[{k: v for k, v in r.items() if k != "trajectory"} for r in ranks],
                    synchronous_12=dict(wall_s=sync12["wall"],
                                        keyframes=sync12_stats["keyframes"],
                                        ate_over_max_depth=sync12_stats["ate_over_max_depth"]))
    print(f"meshed path, two gloo ranks on one card, 12 frames ({label}): "
          + json.dumps(out["b"]), flush=True)

    # (c), second half: the mesh code path's cost on one card
    t0 = time.perf_counter()
    pipe = multihost.measure_scaling_pipeline(counts=(1,), device=dev, timeout_s=300.0)
    for kind, rows in pipe.items():
        row = rows[1]
        err = row.get("cost_max_abs_err", row.get("vel_max_abs_err"))
        if not (err < 2e-3 and row["ms_sharded"] > 0 and row["ms_single"] > 0):
            raise AssertionError(f"measure_scaling_pipeline {kind}: {row}")
    out["c"] = dict(parity=parity, pipeline=pipe, pipeline_seconds=time.perf_counter() - t0)
    print(f"meshed path, parity and the mesh's cost on one card ({label}): "
          + json.dumps(out["c"]), flush=True)

    # (d) the artifact goes where it is told, never to SCALING.json
    t0 = time.perf_counter()
    scaling_json = os.path.join(os.path.dirname(os.path.abspath(__file__)), "SCALING.json")

    def digest():
        if not os.path.exists(scaling_json):
            return None
        with open(scaling_json, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "scaling.json")
        art = multihost.write_scaling_artifact(path, counts=(1,), device=dev, timeout_s=300.0)
        if not os.path.exists(path) or not art["multiprocess"]["ok"]:
            raise AssertionError(f"write_scaling_artifact: {art}")
    if digest() != before:
        raise AssertionError("write_scaling_artifact changed SCALING.json")
    out["d"] = dict(seconds=time.perf_counter() - t0, scaling=art["scaling"],
                    device_kind=art["device_kind"])
    out["seconds"] = time.perf_counter() - t_phase
    print(f"meshed path, scaling artifact ({label}): " + json.dumps(out["d"]), flush=True)
    print(f"phase 12 took {out['seconds']:.2f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    from evo_tpu_torch.kernels import (align_step, ba_solve, comp_step, comp_tile, corner_select,
                                       frame_maps, frame_policy, frame_rows, localize, nvcc,
                                       route_events, splat)
    from evo_tpu_torch.run.time_splat import Timer, card

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    label = card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(label, flush=True)

    # one nvcc for each source, started together
    t0 = time.perf_counter()
    libs = (splat._lib, align_step._lib, partial(align_step._lib, clocks=True), comp_tile._lib,
            partial(comp_tile._lib, clocks=True), comp_step._lib,
            partial(comp_step._lib, clocks=True), localize._lib,
            partial(localize._lib, clocks=True), ba_solve._lib, partial(ba_solve._lib, clocks=True),
            frame_maps._lib, corner_select._lib, partial(corner_select._lib, clocks=True),
            frame_rows._lib, partial(frame_rows._lib, clocks=True), frame_policy._lib,
            partial(frame_policy._lib, clocks=True), route_events._lib,
            partial(route_events._lib, clocks=True))
    with ThreadPoolExecutor(len(libs)) as pool:
        for build in [pool.submit(lib) for lib in libs]:
            build.result()
    print(f"built the splat, alignment, compensation, VO, frame, policy and routing kernels "
          f"(and the clock builds) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in ("evo_splat", "evo_align_step", "evo_align_step_clock", "evo_comp_tile",
                 "evo_comp_tile_clock", "evo_comp_step", "evo_comp_step_clock", "evo_localize",
                 "evo_localize_clock", "evo_ba_solve", "evo_ba_solve_clock", "evo_frame_maps",
                 "evo_corner_select", "evo_corner_select_clock", "evo_frame_rows",
                 "evo_frame_rows_clock", "evo_frame_policy", "evo_frame_policy_clock",
                 "evo_route_events", "evo_route_events_clock"):
        for line in nvcc.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas ({name}):", line.strip(), flush=True)

    timer = Timer(dev)
    rows = phase_kernels(splat, timer, dev, label)
    align_row = phase_align_step(timer, dev, label, rows[0]["floor_ms"])
    comp_rows = phase_comp_kernels(timer, dev, label, rows[0]["floor_ms"])
    dataset = simulate(dev, label)
    vo_rows = phase_vo_kernels(timer, dev, label, dataset)
    frame_rows_ = phase_frame_kernels(timer, dev, label, dataset)
    route_row = phase_route_kernel(timer, dev, label, dataset)
    phase_frame_card_tests(label)
    phase_sweep(splat, timer, dev, label)
    phase_svd_methods(timer, dev, label)
    del timer
    stats, window, dataset, trajectories = phase_main_path(splat, dev, label, dataset)
    large = phase_large_tiles(splat, window, dev)
    phase_tracks_window(splat, trajectories, window, dev, label)
    vo_stats, sync, sync12 = phase_standard_mode(splat, dataset, dev, label)
    phase_vo_repeats(splat, dataset, label, sync12)
    pipe_stats, default_run = phase_pipelined(splat, dataset, dev, label, vo_stats, sync,
                                              sync12)
    t0 = time.perf_counter()
    phase_runtime_extras(splat, dataset, dev, label, sync, trajectories)
    print(f"run-time extras took {time.perf_counter() - t0:.2f} s; the smoke so far "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    t0 = time.perf_counter()
    timer = Timer(dev)
    batched_rows = phase_batched_kernels(splat, timer, dev, label)
    del timer
    temporal = phase_temporal_windows(splat, compensation_windows(dataset), dev, label)
    temporal_drive = phase_temporal_drive(splat, dataset, dev, label, sync12)
    phase_mesh(splat, dataset, dev, label)
    print(f"temporal batching and the mesh took {time.perf_counter() - t0:.2f} s; the smoke "
          f"so far {time.perf_counter() - t_start:.2f} s", flush=True)
    meshed = phase_meshed(splat, dataset, dev, label, default_run, sync12)
    print(f"the smoke so far {time.perf_counter() - t_start:.2f} s", flush=True)

    # each entry at the shape its path gives it (or gave it, for the entries
    # compensation's kernels took over); the other shapes are printed above.
    # The generic forward serves the count image (main path)
    at_shape = {"splat_fwd": "nearest [1, 15000]", "splat_bwd": "gaussian [24, 1024]",
                "warp_splat_fwd": f"gaussian [{TILES}, 1024]",
                "warp_splat_bwd": f"gaussian [{TILES}, 1024]"}
    kernels = []
    for name, shape in at_shape.items():
        mine = [r for r in rows if r["kernel"] == name]
        at = next(r for r in mine if r["shape"].startswith(shape))
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES,
            # the tracker experiment's run; the standard mode's own counts
            # are in the `vo path` line
            launches=stats["launches"][name],
            launches_large_tiles=large[name],
            launches_standard_mode=vo_stats["launches"][name],
            launches_pipelined=pipe_stats["pipelined"]["launches"][name],
            launches_mesh=meshed["a"]["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine), shape=at["shape"],
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], library_ms=at["library_ms"],
            floor_ms=at["floor_ms"], host_us=at["host_us"],
        ))
        if name == "splat_bwd":
            kernels[-1]["note"] = (
                "on no path since comp_tile took the 40 px tiles (phase 6, which it served "
                "before): held to its plain version above")
        if name.startswith("warp_splat"):
            kernels[-1]["note"] = (
                "on no path since comp_tile took the 20 px tiles: launches 0 in every run; "
                "held to its plain version above")
            # the default drive with temporal_batch=8 (11 (b)), and the
            # batched solves' shapes (11 (a))
            kernels[-1]["launches_temporal_batch"] = temporal_drive["launches"][name]
            kernels[-1]["batched"] = {
                r["shape"]: dict(ms=r["ms"], host_us=r["host_us"], plain_ms=r["plain_ms"],
                                 bound_ms=r["bound_ms"], max_abs_err=r["max_abs_err"],
                                 launches=temporal[f"W={r['w']}"][name])
                for r in batched_rows if r["kernel"] == name}
    kernels.append(dict(
        name="align_step", route="cuda", source=ALIGN_SOURCE, replaces=ALIGN_REPLACES,
        # the tracker experiment's run, then every drive's
        launches=stats["launches"]["align_step"],
        launches_standard_mode=vo_stats["launches"]["align_step"],
        launches_pipelined=pipe_stats["pipelined"]["launches"]["align_step"],
        launches_temporal_batch=temporal_drive["launches"]["align_step"],
        launches_mesh=meshed["a"]["launches"]["align_step"],
        launches_mesh_gloo_ranks=[r["launches"]["align_step"] for r in meshed["b"]["ranks"]],
        max_abs_err=align_row["max_abs_err"], shape=align_row["shape"],
        ms=align_row["ms"], plain_ms=align_row["plain_ms"], bound_ms=align_row["bound_ms"],
        bound_by=align_row["bound_by"], library_ms=None, floor_ms=align_row["floor_ms"],
        host_us=align_row["host_us"], errors=align_row["errors"], trips=align_row["trips"],
        sweep=align_row["sweep"]))
    # compensation's kernels, each at the tracker experiment's shape (W = 1,
    # 108 tiles; kernel A at E = 1024), the other shapes beside it
    for name, source, replaces, main_shape in (
            ("comp_tile", COMP_TILE_SOURCE, COMP_TILE_REPLACES, "edge [108, 1024]"),
            ("comp_step", COMP_STEP_SOURCE, COMP_STEP_REPLACES, "1 x 108 tiles")):
        mine = [r for r in comp_rows if r["kernel"] == name]
        at = next(r for r in mine if r["shape"].startswith(main_shape))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=stats["launches"][name],
            launches_standard_mode=vo_stats["launches"][name],
            launches_pipelined=pipe_stats["pipelined"]["launches"][name],
            launches_temporal_batch=temporal_drive["launches"][name],
            launches_temporal_windows={k: v[name] for k, v in temporal.items()},
            launches_mesh=meshed["a"]["launches"][name],
            launches_mesh_gloo_ranks=[r["launches"][name] for r in meshed["b"]["ranks"]],
            launches_large_tiles=large[name],
            max_abs_err=max(r["max_abs_err"] for r in mine), shape=at["shape"],
            ms=at["ms"], plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_by=at["bound_by"], library_ms=at["library_ms"], floor_ms=at["floor_ms"],
            host_us=at["host_us"], clock=at["clock"], clock_build_ms=at["clock_build_ms"],
            other_shapes={r["shape"]: {k: r[k] for k in (
                "ms", "host_us", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err", "clock")} for r in mine if r is not at}))
    # VO's kernels, each at the shape of the largest call of its kind in the
    # standard mode's 24 frames; launches on every drive (the tracker
    # experiment runs no VO)
    for row, name, source, replaces in ((vo_rows[0], "localize", LOCALIZE_SOURCE,
                                         LOCALIZE_REPLACES),
                                        (vo_rows[1], "ba_solve", BA_SOURCE, BA_REPLACES)):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=vo_stats["launches"][name],
            launches_tracker_experiment=stats["launches"][name],
            launches_pipelined=pipe_stats["pipelined"]["launches"][name],
            launches_pipelined_12_frames={k: pipe_stats[k]["launches"][name] for k in (
                "pipelined_inline_vo", "pipelined_host_policy")},
            launches_temporal_batch=temporal_drive["launches"][name],
            launches_mesh=meshed["a"]["launches"][name],
            launches_mesh_gloo_ranks=[r["launches"][name] for r in meshed["b"]["ranks"]],
            max_abs_err=row["max_abs_err"], shape=row["shape"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=None, host_us=row["host_us"], clock=row["clock"],
            clock_build_ms=row["clock_build_ms"],
            **({"cholesky_library_ms": row["cholesky_library_ms"], "trips": row["trips"],
                "orders_ms": row["orders_ms"], "cluster": row["cluster"]}
               if name == "ba_solve" else {"lm_trips": row["trips"]})))
    # the frame path's kernels, at the run's shapes; launches on every drive
    for row, (name, source, replaces) in zip(frame_rows_, FRAME_KERNELS):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=vo_stats["launches"][name],
            launches_tracker_experiment=stats["launches"][name],
            launches_pipelined=pipe_stats["pipelined"]["launches"][name],
            launches_pipelined_12_frames={k: pipe_stats[k]["launches"][name] for k in (
                "pipelined_inline_vo", "pipelined_host_policy")},
            launches_temporal_batch=temporal_drive["launches"][name],
            launches_mesh=meshed["a"]["launches"][name],
            launches_mesh_gloo_ranks=[r["launches"][name] for r in meshed["b"]["ranks"]],
            max_abs_err=row["max_abs_err"], shape=row["shape"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], host_us=row["host_us"],
            **({"clock": row["clock"]} if row.get("clock") else {}),
            **({"calls_us": row["calls_us"], "calls_sum_us": row["calls_sum_us"]}
               if name == "frame_rows" else {})))
    # the policy's and the routing's kernels: launches on every drive (the
    # policy's main path is the default drive, the routing's every drive)
    for row, (name, source, replaces) in ((frame_rows_[3], POLICY_KERNEL),
                                          (route_row, ROUTE_KERNEL)):
        main_path = pipe_stats["pipelined"] if name == "frame_policy" else stats
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path["launches"][name],
            launches_tracker_experiment=stats["launches"][name],
            launches_standard_mode=vo_stats["launches"][name],
            launches_pipelined=pipe_stats["pipelined"]["launches"][name],
            launches_pipelined_12_frames={k: pipe_stats[k]["launches"][name] for k in (
                "pipelined_inline_vo", "pipelined_host_policy")},
            launches_temporal_batch=temporal_drive["launches"][name],
            launches_mesh=meshed["a"]["launches"][name],
            launches_mesh_gloo_ranks=[r["launches"][name] for r in meshed["b"]["ranks"]],
            max_abs_err=row["max_abs_err"], shape=row["shape"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], host_us=row["host_us"], calls_us=row["calls_us"],
            calls_sum_us=row["calls_sum_us"], digest=row["digest"], clock=row["clock"],
            **({"dispatches_a_frame": row["dispatches"]} if name == "frame_policy"
               else {"window": row["window"]})))
    print(label, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
