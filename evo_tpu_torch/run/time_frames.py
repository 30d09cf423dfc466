"""The tracker's frame step on one CUDA card, for one tree: the `frames`
stage split by part, the drives' walls, and the frame kernels held to their
plain versions and timed.

    python evo_tpu_torch/run/time_frames.py [--root DIR] [--reps R]
    python evo_tpu_torch/run/time_frames.py [--root DIR] --kernels

Simulates `chip_smoke.py`'s scene (`3walls`, 1.2 s at 20 fps, seed 3) with
the `evo_tpu_torch` package found under DIR (default: the tree this file is
in) and runs the standard mode on the card with every parameter at its
default.

The split (`split`): the synchronous drive once more with each part of the
frame step wrapped in a timer that synchronizes the card before and after
it (`PARTS`: every name the tree has of Harris and the gradients, the
corner selection and its read, the host policy, the mirror reads, the
frame's table update, LK and the re-budget), so each part's seconds hold
its own device work. The timers' synchronizations cost time of their own,
so the uninstrumented `frames` stage is printed beside them (`drives`).
Only names that the tree has are wrapped, so any version of the port since
the tracker can be split: unpack the other commit somewhere and run this
file once per tree, in turns, in one call.

`drives`: R rounds of the synchronous and the default drive in turns, each
after a warm-up run of three frames (`time_comp.run_mode`): wall and stage
seconds and the launches the tree counts.

`--kernels` (a tree with the frame kernels): the three kernels
(`kernels.frame_maps`, `kernels.corner_select`, `kernels.frame_rows`) on
the scene's frames, each held to its plain version (`check_frame_maps`,
`check_corner_select`, `check_frame_rows`, which `chip_smoke.py` phase 3
runs too) and timed: device µs a launch over 200 launches between one pair
of CUDA events behind a busy queue (`time_splat.Timer`), host µs a launch,
the bound (`time_comp.bound`: the bytes each must move over 3.35 TB/s
against its float32 operations over 67 TFLOP/s), the plain version's time
and the library time where one PyTorch call computes the same function;
`frame_rows` also on each of the synchronous run's 24 calls, with a digest
of its outputs; the clock splits of `corner_select` and, where the tree
has its clock build, of `frame_rows`; ptxas's registers and spills. This
file's checks run on another tree's package too (`--root`), so two trees
are timed in turns in one call.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

SCENE = dict(duration_s=1.2, fps=20.0, seed=3, scene="3walls", contrast_threshold=0.05)
REPS = 200

# (module under evo_tpu_torch, attribute, part name); a dotted attribute is a
# method of a class. Nested parts are timed inclusive of what they call.
PARTS = (
    ("tracker.detector", "EventTracker.new_image", "frame_step"),
    ("tracker.detector", "frame_analyze", "analyze"),
    ("tracker.detector", "compute_grads", "gradients"),
    ("kernels.harris", "harris_response", "harris"),
    ("kernels.harris", "detect_corners", "detect_corners"),
    ("kernels.frame_maps", "frame_maps", "frame_maps"),
    ("kernels.corner_select", "corner_select", "corner_select"),
    ("tracker.detector", "EventTracker._frame_read", "frame_read"),
    ("tracker.detector", "EventTracker.host_mirror", "mirror_read"),
    ("tracker.detector", "EventTracker._frame_policy", "host_policy"),
    ("tracker.detector", "frame_apply", "frame_apply"),
    ("kernels.lk", "pyramidal_lk", "lk"),
    ("tracker.detector", "apply_flow_init", "flow_init"),
    ("tracker.align", "update_num_of_events", "rebudget"),
    ("kernels.frame_rows", "frame_rows", "frame_rows"),
)


def _resolve(module: str, attr: str):
    """(owner, name) of a part in the tree, or None where it has none."""
    try:
        owner = importlib.import_module(f"evo_tpu_torch.{module}")
    except ImportError:
        return None
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    return (owner, name) if hasattr(owner, name) else None


def split(dataset, frames: int | None = None) -> dict:
    """The synchronous drive with each part of `PARTS` the tree has timed
    between two synchronizations: {part: {s, calls}} (inclusive), and the
    run's wall and `frames` stage."""
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    times: dict[str, list] = {}
    patched = []
    for module, attr, part in PARTS:
        got = _resolve(module, attr)
        if got is None:
            continue
        owner, name = got
        fn = getattr(owner, name)
        times[part] = [0.0, 0]

        def timed(*args, _fn=fn, _part=part, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            times[_part][0] += time.perf_counter() - t0
            times[_part][1] += 1
            return out

        patched.append((owner, name, fn))
        setattr(owner, name, timed)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ev = Evaluator(dataset, EvaluatorParams(pipelined=False, output_dir=tmp))
            t0 = time.perf_counter()
            ev.run(max_frames=frames)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ev.finish()
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
    return dict(wall_s=wall, frames_stage_s=ev.counters.times.get("frames"),
                frames=int(ev.counters.counts["frames"]),
                parts={k: dict(s=v[0], calls=v[1]) for k, v in times.items()})


def frame_launches() -> dict:
    """The frame kernels' launch counts, where the tree has them."""
    out = {}
    for name in ("frame_maps", "corner_select", "frame_rows"):
        got = _resolve(f"kernels.{name}", f"launches_{name}")
        if got is not None:
            out[name] = getattr(*got)
    return out


def reset_frame_counts() -> None:
    for name in ("frame_maps", "corner_select", "frame_rows"):
        got = _resolve(f"kernels.{name}", "reset_counts")
        if got is not None:
            getattr(*got)()


def drives(dataset, rounds: int) -> list:
    """`rounds` rounds of the synchronous and the default drive in turns,
    the order reversed each round: one row a run."""
    from evo_tpu_torch.run import time_comp

    rows = []
    for r in range(rounds):
        for mode in ("sync", "default") if r % 2 == 0 else ("default", "sync"):
            reset_frame_counts()
            row = time_comp.run_mode(dataset, mode)
            row["counts"].update(frame_launches())
            row["round"] = r
            rows.append(row)
    return rows


# ---- the kernels ------------------------------------------------------------


def texture(dx: float = 0.0, dy: float = 0.0, h: int = 180, w: int = 240, seed: int = 11):
    """A smooth [0, 1] texture of 30 soft squares and a ramp, moved by (dx,
    dy) px: a frame pair with a known flow (`tests/test_torch_frame.py`'s
    recipe), made with numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = xx - dx, yy - dy
    img = np.zeros((h, w))
    for _ in range(30):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        s = rng.uniform(3, 7)
        img += rng.uniform(0.3, 1.0) / (1 + np.exp((np.maximum(abs(u - cx), abs(v - cy)) - s)
                                                   / 0.7))
    img += 0.1 * np.sin(0.31 * u + 0.17 * v)
    return ((img - img.min()) / (img.max() - img.min())).astype(np.float32)


def frames_of(dataset, dev, n: int) -> list:
    """The first n frames of the scene as float32 images on `dev`."""
    from evo_tpu_torch.tracker.detector import EventTracker

    tr = EventTracker(device=dev)
    return [tr._as_f32_image(dataset.image_u8(k)) for k in range(min(n, dataset.num_images))]


def maps_flops(h: int, w: int) -> float:
    """Floating-point operations of one frame's maps, counted from
    `csrc/frame_maps.cu`: ~76 a pixel (the log, two Sobel pairs and their
    scales, three products, three 3x3 box sums, the response), and 9 for
    each tap pass of the two blurs (level 0's rows at level 1's columns,
    level 1's columns, level 1's rows at level 2's columns, level 2)."""
    h1, w1 = (h + 1) // 2, (w + 1) // 2
    h2, w2 = (h1 + 1) // 2, (w1 + 1) // 2
    return 76.0 * h * w + 9.0 * (h * w1 + h1 * w1 + h1 * w2 + h2 * w2)


def select_flops(h: int, w: int, k: int, n_candidates: int, max_corners: int) -> float:
    """Operations of one corner selection on this response: the border
    maximum and the 3x3 peak test (~12 a pixel), four radix passes over the
    candidates where they are more than K, the bitonic sort of the keys, and
    the greedy pass's distances (3 a pair of candidate and accepted corner:
    at most K x max_corners)."""
    passes = 4 * n_candidates if n_candidates > k else 0
    kpad = 1 << max(k - 1, 1).bit_length()
    log2 = kpad.bit_length() - 1
    return 12.0 * h * w + passes + kpad * log2 * (log2 + 1) / 2 + 3.0 * k * max_corners


def greedy_host_seconds(resp, *, max_corners: int, quality_level: float,
                        min_distance: float, border: int, reps: int = 20) -> float:
    """Seconds of the plain version's host greedy pass on this response's
    top-K (the least of `reps`)."""
    from evo_tpu_torch.kernels import corner_select as cs

    scores = cs.masked_scores(resp, max_corners=max_corners, quality_level=quality_level,
                              min_distance=min_distance, border=border)
    k = min(4 * max_corners, scores.numel())
    top_scores, top_idx = (t[:k].cpu().numpy() for t in
                           torch.sort(scores, descending=True, stable=True))
    w = resp.shape[1]
    pos = np.stack([top_idx % w, top_idx // w], axis=-1).astype(np.float32)
    ok = np.isfinite(top_scores)
    min_d2 = np.float32(min_distance * min_distance)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        cs.greedy(pos, ok, min_d2)
        best = min(best, time.perf_counter() - t0)
    return best


def maps_error(got, ref) -> float:
    """The largest difference of two frames' maps (gradient pair, response,
    pyramid levels 1 and 2)."""
    return max(float((a - b).abs().max()) for a, b in zip(got, ref))


def library_maps(img):
    """The frame's maps in the fewest PyTorch calls (`F.conv2d` with the
    filters stacked: the Sobel pairs of log I and of I, the box of the three
    Harris products as one grouped convolution, each blur pass): the
    library's way, timed beside the kernel, never called by the port."""
    import torch.nn.functional as F

    from evo_tpu_torch.kernels import gradients

    x = img[None, None]
    sob = torch.tensor([gradients.SOBEL_X, gradients.SOBEL_Y], dtype=img.dtype,
                       device=img.device)[:, None]
    g = F.conv2d(torch.log(x + 0.1), sob, padding=1) * 0.125
    d = F.conv2d(x, sob, padding=1) * 0.25
    prods = torch.cat([d[:, :1] * d[:, :1], d[:, 1:] * d[:, 1:], d[:, :1] * d[:, 1:]], 1)
    box = F.conv2d(prods, torch.ones(3, 1, 3, 3, dtype=img.dtype, device=img.device),
                   padding=1, groups=3)[0]
    tr = box[0] + box[1]
    resp = box[0] * box[1] - box[2] * box[2] - 0.04 * tr * tr
    k = gradients.gaussian_kernel1d(1.0, 2, img.dtype, img.device)
    levels, cur = [], x
    for _ in range(2):
        cur = F.conv2d(F.conv2d(cur, k[None, None, None, :], padding=(0, 2)),
                       k[None, None, :, None], padding=(2, 0))[..., ::2, ::2]
        levels.append(cur[0, 0])
    return g[0], resp, *levels


def check_frame_maps(timer, dev, imgs) -> dict:
    """`frame_maps` against `frame_maps_ref` on the frames `imgs` (1e-5),
    then timed on the first."""
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.run.time_splat import Timer

    err = 0.0
    for img in imgs:
        err = max(err, maps_error(fm.frame_maps(img), fm.frame_maps_ref(img)))
    if not err <= 1e-5:
        raise AssertionError(f"frame_maps is {err:.3e} from its plain version (bar 1e-5)")
    img = imgs[0]
    h, w = img.shape
    outs = fm.frame_maps(img)
    lib_err = maps_error(library_maps(img), outs)
    n_bytes = 4 * (h * w + sum(int(t.numel()) for t in outs))
    b_ms, by = bound(n_bytes, maps_flops(h, w))
    return dict(kernel="frame_maps", shape=f"[{h}, {w}] -> grad, resp, [{outs[2].shape[0]}, "
                f"{outs[2].shape[1]}], [{outs[3].shape[0]}, {outs[3].shape[1]}]",
                max_abs_err=err, library_abs_err=lib_err,
                ms=timer.device_ms(lambda: fm.frame_maps(img), REPS),
                host_us=Timer.host_us(lambda: fm.frame_maps(img), REPS),
                plain_ms=timer.device_ms(lambda: fm.frame_maps_ref(img), REPS),
                bound_ms=b_ms, bound_by=by,
                library_ms=timer.device_ms(lambda: library_maps(img), REPS))


def explain_apart(got: list, resp, **kw) -> dict:
    """Whether the kernels' ranked corners `got` (flat indices) differ from
    the plain path's on its response `resp` only by candidates whose
    responses lie within 1e-5, the bar the two responses are held to
    (`tests/test_torch_frame.py`): two candidates that close can rank either
    way. Replays the plain path's greedy pass on its ranked candidates: at
    the first rank where the two accepted lists part, the kernels' corner
    there is paired with the one it displaced (or, where one list has ended,
    with the quality threshold); the pair's two responses must lie within
    1e-5. The kernels' corner then takes the displaced one's rank in the
    candidates (joining them if it was none) and the replay runs again, until
    the lists agree. Returns the pairs and `explained`."""
    from evo_tpu_torch.kernels import corner_select as cs

    h, w = resp.shape
    b = kw["border"]
    r = resp.cpu().reshape(-1)
    thr = float(kw["quality_level"] * resp[b:h - b, b:w - b].max())
    scores, order = cs._top_k(resp, **kw)
    order = [int(i) for i, s in zip(order, scores) if np.isfinite(s)]
    min_d2 = np.float32(kw["min_distance"] ** 2)
    pairs = []
    for _ in range(kw["max_corners"] + 1):
        pos = np.stack([np.array(order) % w, np.array(order) // w], -1).astype(np.float32)
        acc = [order[i] for i in np.flatnonzero(
            cs.greedy(pos, np.ones(len(order), bool), min_d2))[:kw["max_corners"]]]
        if acc == got:
            return dict(pairs=pairs, explained=True)
        i = next(k for k in range(max(len(acc), len(got)))
                 if k >= len(acc) or k >= len(got) or acc[k] != got[k])
        g = got[i] if i < len(got) else None
        d = acc[i] if i < len(acc) else None
        a = float(r[g]) if g is not None else thr
        c = float(r[d]) if d is not None else thr
        pairs.append(dict(rank=i, kernels=None if g is None else (g % w, g // w),
                          displaced=None if d is None else (d % w, d // w),
                          responses=(a, c), gap=abs(a - c)))
        if not abs(a - c) <= 1e-5:
            break
        if g is None:
            order.remove(d)
        else:
            if g in order:
                order.remove(g)
            order.insert(order.index(d) if d is not None else len(order), g)
    return dict(pairs=pairs, explained=False)


def corner_sets(imgs: list, params) -> dict:
    """The corners of each frame by the kernels' path (`frame_maps`'
    response, `corner_select`) against the plain path's (`harris_response`'s
    convolutions, `corner_select_ref`): the frames whose ranked corners
    differ, each with its pairs of swapped corners (`explain_apart`)."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.kernels import harris

    kw = cs.select_kwargs(params)
    apart = []
    for k, img in enumerate(imgs):
        got = cs.corner_select(fm.frame_maps(img)[1], **kw)
        resp = harris.harris_response(img)
        ref = cs.corner_select_ref(resp, **kw)
        if torch.equal(got[0].cpu(), ref[0].cpu()) and torch.equal(got[2].cpu(), ref[2].cpu()):
            continue
        w = resp.shape[1]
        ranked = [int(y) * w + int(x) for x, y in got[0][got[2]].cpu().tolist()]
        apart.append(dict(frame=k, **explain_apart(ranked, resp, **kw)))
    return dict(frames=len(imgs), apart=apart, ok=all(f["explained"] for f in apart))


def check_corner_select(timer, dev, resps: list, params) -> dict:
    """`corner_select` against `corner_select_ref` on each response: the
    same corners, order and scores; timed on the first. The library time is
    `torch.topk` of the masked scores on the card plus the plain version's
    greedy pass on the host (least of 20), the two calls a library user
    would make."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.run.time_splat import Timer

    kw = cs.select_kwargs(params)
    for resp in resps:
        same = cs.same_corners(cs.corner_select(resp, **kw), cs.corner_select_ref(resp, **kw))
        if not same["equal"]:
            raise AssertionError(f"corner_select differs from its plain version: {same}")
    resp = resps[0]
    h, w = resp.shape
    k = min(4 * kw["max_corners"], h * w)
    n_cand = cs.candidates(resp, **kw)
    same = cs.same_corners(cs.corner_select(resp, **kw), cs.corner_select_ref(resp, **kw))
    scores = cs.masked_scores(resp, **kw)
    # the clock build's split of one launch after REPS of them (a cold first
    # launch reads slower), held to the plain build's bits
    clk = torch.zeros(len(cs.STAGES), dtype=torch.int64, device=dev)
    timer.device_ms(lambda: cs.corner_select(resp, **kw, clocks=clk), REPS)
    clocked = cs.corner_select(resp, **kw, clocks=clk)
    if not cs.same_corners(clocked, cs.corner_select(resp, **kw))["equal"]:
        raise AssertionError("corner_select's clock build gives other corners")
    n_bytes = 4 * h * w + 13 * kw["max_corners"]
    b_ms, by = bound(n_bytes, select_flops(h, w, k, n_cand, kw["max_corners"]))
    return dict(kernel="corner_select", shape=f"[{h}, {w}] -> {kw['max_corners']} (K {k})",
                max_abs_err=same["max_abs_err"], candidates=n_cand,
                clock=dict(zip(cs.STAGES, clk.tolist())),
                accepted=same["accepted"], compared=len(resps),
                ms=timer.device_ms(lambda: cs.corner_select(resp, **kw), REPS),
                host_us=Timer.host_us(lambda: cs.corner_select(resp, **kw), REPS),
                plain_ms=timer.device_ms(lambda: cs.corner_select_ref(resp, **kw), 20),
                bound_ms=b_ms, bound_by=by,
                library_ms=timer.device_ms(lambda: torch.topk(scores, k), REPS)
                + 1e3 * greedy_host_seconds(resp, **kw))


def compare_rows(got, ref) -> dict:
    """The kernel's `frame_rows` (table, diagnostics) against the plain
    version's: LK's status, its flow where tracked (1e-3 px), the table's
    alive, initialized and budgets equal, warps 1e-3 px, flow angles 1e-5
    rad, times without update 1e-3 relative. Rows that part are named;
    `ok` holds where every parted row is an LK stop-test tie (`ties`: a
    level's last |dv|^2 within 2 % of 1e-4 in the kernel)."""
    (gt, gd), (rt, rd) = got, ref
    st_g, st_r = gd["lk_status"].cpu(), rd["lk_status"].cpu()
    tracked = st_g & st_r
    flow_err = (gd["lk_flow"].cpu() - rd["lk_flow"].cpu()).abs().amax(-1)
    bad = (st_g != st_r) | (tracked & (flow_err > 1e-3))
    for name in ("alive", "initialized", "num_of_events"):
        bad |= getattr(gt, name).cpu() != getattr(rt, name).cpu()
    bad |= (gt.warp - rt.warp).abs().amax(-1).cpu() > 1e-3
    bad |= (gt.flow - rt.flow).abs().cpu() > 1e-5
    bad |= ((gt.time_without_update - rt.time_without_update).abs()
            > 1e-3 * rt.time_without_update.abs()).cpu()
    d2 = gd["lk_d2"].cpu()
    tie = ((d2 - 1e-4).abs() <= 2e-6).any(-1)
    rows = torch.nonzero(bad).flatten().tolist()
    return dict(ok=bool((~bad | tie).all()), rows_apart=rows,
                ties=[dict(row=r, d2=d2[r].tolist()) for r in rows if tie[r]],
                lk_rows=int(gd["lk_trips"].cpu().gt(0).any(-1).sum()),
                flow_max_abs_err=float(flow_err[tracked].max()) if tracked.any() else 0.0,
                trips=int(gd["lk_trips"].sum()))


def rows_work(table, diag, h: int, w: int) -> tuple:
    """(bytes, operations) that a `frame_rows` call's data needs. Bytes are
    the distinct ones: the table's fields in and out, each level of the two
    pyramids once (the tracked rows' windows, at most the level), and the
    gradient pair once (the live rows' 25 x 25 rects, at most the pair).
    Operations: ~180 a template sample, ~90 a sample a trip, ~40 a rect
    pixel of the budget (counted from the kernel)."""
    trips = diag["lk_trips"].cpu()
    tracked = trips.gt(0).any(-1)
    n_lk, n_live = int(tracked.sum()), int(table.alive.sum())
    levels = [((h + (1 << k) - 1) >> k, (w + (1 << k) - 1) >> k) for k in range(3)]
    pyr = sum(min(lh * lw, n_lk * min(64, lh, lw) ** 2) for lh, lw in levels)
    n_bytes = table.capacity * 2 * 36 + 2 * 4 * pyr + 4 * 2 * min(h * w, n_live * 625)
    n_flops = n_lk * 3 * 441 * 180 + int(trips.sum()) * 441 * 90 + n_live * 625 * 40
    return n_bytes, n_flops


def record_frame_rows(dataset, frames: int) -> list:
    """The arguments of every `frame_rows` call of the synchronous standard
    mode over the first `frames` frames, each tensor copied."""
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
    from evo_tpu_torch.tracker import detector

    calls = []
    inner = detector.frame_rows

    def recording(table, prev_pyr, cur_pyr, grad, **kw):
        calls.append(dict(args=(
            detector.ps.PatchTable(**{k: getattr(table, k).clone() for k in detector.ps.FIELDS}),
            tuple(t.clone() for t in prev_pyr or ()), tuple(t.clone() for t in cur_pyr),
            grad.clone()), kw=dict(kw)))
        return inner(table, prev_pyr, cur_pyr, grad, **kw)

    detector.frame_rows = recording
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ev = Evaluator(dataset, EvaluatorParams(pipelined=False, output_dir=tmp))
            ev.run(max_frames=frames)
            ev.finish()
    finally:
        detector.frame_rows = inner
    return calls


def clock_frame_rows(timer, call: dict) -> dict:
    """The clock build's split of one recorded call (`kernels.frame_rows.
    STAGES`): one launch after REPS of them (a cold first launch reads
    slower), held to the plain build's bits. The launch lasts as long as its
    slowest row, so the split is that row's, beside the stages' largest
    values over all rows."""
    from evo_tpu_torch.kernels import frame_rows as fr

    a, kw = call["args"], dict(call["kw"], diagnostics=True)
    clk = torch.zeros((a[0].capacity, len(fr.STAGES)), dtype=torch.int64, device=a[0].center.device)
    timer.device_ms(lambda: fr.frame_rows(*a, **kw, clocks=clk), REPS)
    got = fr.frame_rows(*a, **kw, clocks=clk)
    ref = fr.frame_rows(*a, **kw)
    for name in fr.OUT_FIELDS:
        if not torch.equal(getattr(got[0], name), getattr(ref[0], name)):
            raise AssertionError(f"frame_rows' clock build gives another {name}")
    for name in fr.DIAGNOSTICS:
        if not torch.equal(got[1][name], ref[1][name]):
            raise AssertionError(f"frame_rows' clock build gives another {name}")
    c = clk.cpu()
    slow = int(c[:, -1].argmax())
    return dict(row=slow, trips=int(got[1]["lk_trips"][slow].sum()),
                cycles=dict(zip(fr.STAGES, c[slow].tolist())),
                largest=dict(zip(fr.STAGES, c.amax(0).tolist())))


def check_frame_rows(timer, dev, calls: list) -> dict:
    """`frame_rows` against `frame_rows_ref` on every recorded call
    (`compare_rows`), each call timed (`calls_us`: device µs a launch over
    REPS launches, in the run's order) and its outputs hashed in order
    (`digest`: two trees that give the same bits on every call print the
    same), then the call with the most LK rows timed in full and, where the
    tree has the clock build, split."""
    from evo_tpu_torch.kernels import frame_rows as fr
    from evo_tpu_torch.run.time_comp import bound
    from evo_tpu_torch.run.time_splat import Timer
    from evo_tpu_torch.tracker import detector

    rows, apart, ties, calls_us = [], [], [], []
    digest = hashlib.sha256()
    for k, call in enumerate(calls):
        a, kw = call["args"], dict(call["kw"], diagnostics=True)
        got = fr.frame_rows(*a, **kw)
        for t in [getattr(got[0], n) for n in fr.OUT_FIELDS] + [got[1][n] for n in fr.DIAGNOSTICS]:
            digest.update(t.contiguous().cpu().numpy().tobytes())
        row = compare_rows(got, detector.frame_rows_ref(*a, **kw))
        if not row["ok"]:
            raise AssertionError(f"frame_rows differs from its plain version at call {k}: {row}")
        rows.append(row)
        apart += [(k, r) for r in row["rows_apart"]]
        ties += [dict(call=k, **t) for t in row["ties"]]
        calls_us.append(1e3 * timer.device_ms(lambda: fr.frame_rows(*a, **call["kw"]), REPS))
    best = max(range(len(calls)), key=lambda k: (rows[k]["lk_rows"], k))
    a, kw = calls[best]["args"], calls[best]["kw"]
    _, diag = fr.frame_rows(*a, **kw, diagnostics=True)
    h, w = a[3].shape[1:]
    b_ms, by = bound(*rows_work(a[0], diag, h, w))

    def run(f):
        return lambda: f(*a, **kw)

    return dict(kernel="frame_rows", shape=f"{a[0].capacity} rows, {rows[best]['lk_rows']} "
                f"LK, {rows[best]['trips']} trips", compared=len(calls),
                max_abs_err=max(r["flow_max_abs_err"] for r in rows), rows_apart=apart,
                ties=ties, digest=digest.hexdigest(), calls_us=calls_us,
                calls_lk_rows=[r["lk_rows"] for r in rows],
                calls_sum_us=sum(calls_us), heaviest_call=best,
                clock=clock_frame_rows(timer, calls[best]) if hasattr(fr, "STAGES") else None,
                ms=timer.device_ms(run(fr.frame_rows), REPS),
                host_us=Timer.host_us(run(fr.frame_rows), REPS),
                plain_ms=timer.device_ms(run(detector.frame_rows_ref), 20),
                bound_ms=b_ms, bound_by=by, library_ms=None)


def ptxas(name: str) -> dict:
    """ptxas's report of each entry of the library `name` built in this
    process (`kernels.nvcc.build_logs`): {entry: {registers, spill_stores,
    spill_loads}} (bytes spilled a thread), empty where it was not built
    here."""
    from evo_tpu_torch.kernels import nvcc

    out, entry = {}, None
    for line in nvcc.build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            out[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def check_kernels(timer, dev, dataset, frames: int = 24) -> list:
    """The three frame kernels' rows at the run's shapes: the scene's first
    frames, their responses, and the synchronous run's `frame_rows` calls."""
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.tracker.detector import TrackerParams

    imgs = frames_of(dataset, dev, frames)
    resps = [fm.frame_maps(img)[1] for img in imgs[:3]]
    sets = corner_sets(imgs, TrackerParams())
    if not sets["ok"]:
        raise AssertionError(f"the kernels' corners differ from the plain path's beyond "
                             f"responses within 1e-5: {sets}")
    row = check_corner_select(timer, dev, resps, TrackerParams())
    row["corner_sets"] = sets
    rows = [check_frame_maps(timer, dev, imgs[:3]), row,
            check_frame_rows(timer, dev, record_frame_rows(dataset, frames))]
    for r in rows:
        lib = f"evo_{r['kernel']}"
        r["ptxas"] = {name: ptxas(name) for name in (lib, lib + "_clock") if ptxas(name)}
    return rows


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="directory that holds the evo_tpu_torch package to time")
    ap.add_argument("--reps", type=int, default=2, help="rounds of the two drives")
    ap.add_argument("--kernels", action="store_true",
                    help="hold the frame kernels to their plain versions and time them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_frames: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.time_splat import Timer, card

    dev = torch.device("cuda")
    dataset = sim.to_dataset(sim.EventCameraSimulator(sim.SimParams(**SCENE),
                                                      device=dev).generate())
    label = card()
    if args.kernels:
        from evo_tpu_torch.kernels import nvcc

        for row in check_kernels(Timer(dev), dev, dataset):
            print(f"time_frames {args.root}: kernel " + json.dumps(dict(row, card=label),
                                                                  default=str), flush=True)
        for name, log in sorted(nvcc.build_logs.items()):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"time_frames {args.root}: ptxas ({name}): {line.strip()}", flush=True)
        return 0
    split(dataset, frames=3)  # warm-up
    print(f"time_frames {args.root}: split " + json.dumps(dict(split(dataset), card=label)),
          flush=True)
    for row in drives(dataset, args.reps):
        keep = {k: row[k] for k in ("mode", "round", "wall_s", "stage_s", "counts")}
        print(f"time_frames {args.root}: drive " + json.dumps(dict(keep, card=label)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
