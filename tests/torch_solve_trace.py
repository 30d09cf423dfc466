"""A per-solve trace of the tracker's alignment in `evo_tpu` and in the port,
on one written dataset: which solve first takes other inputs.

    env JAX_PLATFORMS=cpu python tests/torch_solve_trace.py OUT.json \
        [--scene shapes|plane] [--duration S] [--control centre budget] \
        [--replay-float64 STEP:ROW ...]

It writes one quality row's scene once (the port's simulator, seed 1):
`shapes` (the `shapes` row: 48 polygons, 6 s) or `plane` (the `plane_age`
row: the textured plane, 12 s); `--duration` cuts it to a prefix. It runs
the rows' protocol (the tracker experiment, no compensation) through both
packages on the CPU, and records every solved row of every event sub-batch, keyed by
(track id, solve ordinal):

- before the solve: the sub-batch, the patch-table row (centre, warp, flow,
  `num_of_events`, the event ring, the gradient slot), the integration
  set's size and its 25x25 image, and the slot's frame and checksum;
- after it: centre, warp, flow, cost, lost, the budget's raw float before
  its truncation and the budget.

`evo_tpu` is traced through run-time wrappers of
`evo_tpu.tracker.align.optimize_ready_patches` and `update_budgets_solved`
with a `jax.debug.callback` inside, installed before `process_window_scan`
is first traced (it looks both names up as module globals); `evo_tpu` itself
is not edited. The port is traced through wrappers of the same two
functions of `evo_tpu_torch.tracker.align`, which `solve_step_ref` calls.

It prints and writes: the first solve whose integer inputs differ, the
first whose float inputs differ by more than 1e-4 px (1e-5 rad) while every
earlier output agrees to 1e-5 px, the first output apart by more than 1e-5
px, `evo_tpu`'s inputs of their sub-batches replayed through the port's
solve, every sub-batch so replayed (`replay_summary`: the gaps' quantiles,
the solves beyond float32 rounding and how many of them sit at the LM's
stop test, at one trip's accept or stop test, or within the solve's own
response to a rounding-sized change of one cost: `trip_decisions`), and both packages' trajectories scored by both scorers.
`--control centre` runs `evo_tpu` alone once more with every solved centre
raised by one float32 ulp (`budget`: every raw budget), and scores that row
too. `--replay-float64` traces `evo_tpu` alone and replays the named solves
(sub-batch, index among its solved rows) through the port's solve in float32
and in float64 (`replay_in_float64`). It imports both packages and runs on
the CPU, the port on one thread (its CPU arithmetic can round otherwise on
more): about 10 minutes for the 6 s scene with both controls.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    # the device count the tests run under (tests/conftest.py)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from evo_tpu.io import davis as jdavis  # noqa: E402
from evo_tpu.run import quality as jquality  # noqa: E402
from evo_tpu.run.evaluator import Evaluator as JEvaluator  # noqa: E402
from evo_tpu.run.evaluator import EvaluatorParams as JParams  # noqa: E402
from evo_tpu.tracker import align as jalign  # noqa: E402
from evo_tpu.tracker import patch_state as jps  # noqa: E402
from evo_tpu_torch.core import lie  # noqa: E402
from evo_tpu_torch.io import sim  # noqa: E402
from evo_tpu_torch.io.davis import Davis240cDataset  # noqa: E402
from evo_tpu_torch.run import quality  # noqa: E402
from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams  # noqa: E402
from evo_tpu_torch.solve.lm import huber_cost  # noqa: E402
from evo_tpu_torch.tracker import align  # noqa: E402
from evo_tpu_torch.tracker import patch_state as ps  # noqa: E402

FIELDS = ps.FIELDS
# the rect's corners about its centre: a warp is held by the pixels it moves
CORNERS = np.array([[-12.0, -12.0], [12.0, -12.0], [-12.0, 12.0], [12.0, 12.0]])
INPUT_PX, INPUT_RAD, OUTPUT_PX = 1e-4, 1e-5, 1e-5


# the quality row whose scene and protocol each `--scene` takes
ROWS = {"shapes": "shapes", "plane": "plane_age"}


def write_scene(out_dir: str, duration_s: float | None = None, scene: str = "shapes") -> str:
    """The scene of `scene`'s quality row (`ROWS`), its first `duration_s`
    seconds (default: the row's), written once in the dataset format."""
    cfg = quality.suite_configs()[ROWS[scene]]
    assert cfg["scene"] == scene and cfg["tracker_experiment"]
    kw = dict(texture_cells=cfg["texture_cells"]) if "texture_cells" in cfg else {}
    out = sim.EventCameraSimulator(sim.SimParams(
        duration_s=cfg["duration_s"] if duration_s is None else duration_s, fps=20.0,
        seed=1, scene=scene, **kw), device="cpu").generate()
    return sim.write_dataset(os.path.join(out_dir, "ds"), out)


class Trace:
    """The solved rows of every sub-batch, in order: `steps[k]` holds the
    rows that solved in sub-batch k, their table before the solve ("pre"),
    after it ("post", budget included), the integration image, the raw
    budgets and each row's slot checksum; `frames` the gradient store and
    slot births after each frame."""

    def __init__(self):
        self.steps: list[dict] = []
        self.frames: list[dict] = []
        self._open: dict | None = None

    def on_solve(self, pre: dict, ran, cost, lost, integrated, post: dict, slot_sum):
        rows = np.flatnonzero(np.asarray(ran))
        pre = {k: np.asarray(v)[rows] for k, v in pre.items()}
        self._open = dict(
            step=len(self.steps), rows=rows, frame=len(self.frames), pre=pre,
            cost=np.asarray(cost)[rows], lost=np.asarray(lost)[rows],
            image=np.asarray(integrated)[rows].astype(np.int16),
            post={k: np.asarray(v)[rows] for k, v in post.items()},
            slot_sum=np.asarray(slot_sum)[pre["grad_slot"]])

    def on_budget(self, raw, num_of_events, alive):
        s = self._open
        s["raw"] = np.asarray(raw)[s["rows"]]
        s["post"]["num_of_events"] = np.asarray(num_of_events)[s["rows"]]
        s["post"]["alive"] = np.asarray(alive)[s["rows"]]
        self.steps.append(s)
        self._open = None

    def on_frame(self, grads, slot_birth):
        grads, birth = np.asarray(grads), np.asarray(slot_birth).copy()
        used = np.flatnonzero(birth >= 0)  # the slots a frame has written
        self.frames.append(dict(shape=grads.shape, used=used, grads=grads[used].copy(),
                                slot_birth=birth))

    def store(self, frame: int):
        """(the gradient store [SLOTS, 2, H, W] after frame `frame`, its newest
        slot's gradients), as tensors."""
        f = self.frames[frame]
        grads = torch.zeros(f["shape"])
        grads[f["used"]] = torch.as_tensor(f["grads"])
        return grads, grads[int(np.argmax(f["slot_birth"]))]


def _integration_size(center, ev_x, ev_y, valid):
    """How many events of the integration set fall inside the current rect
    (the events the image sums)."""
    rx = np.round(ev_x - (center[:, 0:1] - ps.PATCH_EXTENT))
    ry = np.round(ev_y - (center[:, 1:2] - ps.PATCH_EXTENT))
    inside = (rx >= 0) & (rx < ps.PATCH_SIDE) & (ry >= 0) & (ry < ps.PATCH_SIDE)
    return (valid & inside).sum(-1)


def _nudge_up(a):
    return jnp.nextafter(a, jnp.full_like(a, jnp.inf))


# -- evo_tpu ------------------------------------------------------------------
class _JaxHooks:
    """Run-time wrappers of `evo_tpu.tracker.align`'s two step functions,
    recording into a `Trace` through ordered debug callbacks; `control`
    raises each solved centre ("centre") or raw budget ("budget") by one
    float32 ulp instead of recording. JAX's caches are cleared on entry and
    exit, so `process_window_scan` is traced anew with (and then without)
    them."""

    def __init__(self, trace: Trace | None, control: str | None = None):
        self.trace, self.control = trace, control
        self.saved = (jalign.optimize_ready_patches, jalign.update_budgets_solved)

    def __enter__(self):
        opt, bud = self.saved
        trace, control = self.trace, self.control

        def optimize_ready_patches(table, grads):
            new, info = opt(table, grads)
            if control == "centre":
                ran = info["ran"][:, None]
                return dataclasses.replace(
                    new, center=jnp.where(ran, _nudge_up(new.center), new.center)), info
            if trace is not None:
                pre = {k: getattr(table, k) for k in FIELDS}
                post = {k: getattr(new, k) for k in ("center", "warp", "flow", "cur_t")}
                jax.debug.callback(trace.on_solve, pre, info["ran"], info["cost"],
                                   info["lost"], info["integrated"], post,
                                   jnp.sum(grads, axis=(1, 2, 3)), ordered=True)
            return new, info

        def raw_budgets(table, grad):
            return jax.vmap(jalign._budget_one, in_axes=(None, 0, 0, 0))(
                grad, table.warp, table.flow, table.center)

        def update_budgets_solved(table, grad, ran):
            if control == "budget":
                return _budgets_from_raw(table, grad, ran, _nudge_up(raw_budgets(table, grad)))
            new = bud(table, grad, ran)
            if trace is not None:
                jax.debug.callback(trace.on_budget, raw_budgets(table, grad),
                                   new.num_of_events, new.alive, ordered=True)
            return new

        jalign.optimize_ready_patches = optimize_ready_patches
        jalign.update_budgets_solved = update_budgets_solved
        jax.clear_caches()
        return self

    def __exit__(self, *exc):
        jalign.optimize_ready_patches, jalign.update_budgets_solved = self.saved
        jax.clear_caches()


def _budgets_from_raw(table, grad, ran, raw):
    """`evo_tpu`'s `update_budgets_solved` (its full-width branch) from
    given raw budgets [P]."""
    h, w = grad.shape[1], grad.shape[2]
    cx, cy = table.center[:, 0], table.center[:, 1]
    border_lost = ran & ((cx <= 5) | (cy <= 5) | (cx >= w - 5) | (cy >= h - 5))
    tl = table.center - jps.PATCH_EXTENT
    rect_oob = ((tl[:, 0] < 0) | (tl[:, 1] < 0) | (tl[:, 0] + jps.PATCH_SIDE >= w)
                | (tl[:, 1] + jps.PATCH_SIDE >= h))
    budget = jnp.clip(raw.astype(jnp.int32), jps.MIN_NUM_EVENTS, jps.MAX_NUM_EVENTS)
    budget = jnp.where(rect_oob, jps.INIT_NUM_EVENTS, budget)
    return dataclasses.replace(table, alive=table.alive & ~border_lost,
                               num_of_events=jnp.where(ran, budget, table.num_of_events))


def run_jax(ds_dir: str, out_dir: str, trace: Trace | None = None,
            control: str | None = None) -> dict:
    """`evo_tpu`'s tracker experiment on ds_dir, traced into `trace` (or
    under a `control` nudge); returns its trajectories."""
    jds = jdavis.Davis240cDataset(ds_dir)
    jev = JEvaluator(jds, JParams(output_dir=out_dir, run_compensation=False,
                                  tracker_experiment=True))
    if trace is not None:
        new_image = jev.tracker.new_image

        def recording(t_us, image):
            new_image(t_us, image)
            trace.on_frame(jev.tracker.grads, jev.tracker.slot_birth)
        jev.tracker.new_image = recording
    with _JaxHooks(trace, control):
        jev.run()
        jev.flush_pending()
    return {int(k): list(v) for k, v in jev.tracker.trajectories.items()}


# -- the port -------------------------------------------------------------------
class _PortHooks:
    """Wrappers of `evo_tpu_torch.tracker.align`'s two step functions (which
    `solve_step_ref` looks up at each call), recording into a `Trace`."""

    def __init__(self, trace: Trace):
        self.trace = trace
        self.saved = (align.optimize_ready_patches, align.update_budgets_solved)

    def __enter__(self):
        opt, bud = self.saved
        trace = self.trace

        def optimize_ready_patches(table, grads):
            new, info = opt(table, grads)
            trace.on_solve(
                {k: getattr(table, k).numpy() for k in FIELDS}, info["ran"].numpy(),
                info["cost"].numpy(), info["lost"].numpy(), info["integrated"].numpy(),
                {k: getattr(new, k).numpy() for k in ("center", "warp", "flow", "cur_t")},
                grads.sum((1, 2, 3)).numpy())
            return new, info

        def update_budgets_solved(table, grad, ran):
            new = bud(table, grad, ran)
            raw = align.budgets(grad, table.warp, table.flow, table.center)
            trace.on_budget(raw.numpy(), new.num_of_events.numpy(), new.alive.numpy())
            return new

        align.optimize_ready_patches = optimize_ready_patches
        align.update_budgets_solved = update_budgets_solved
        return self

    def __exit__(self, *exc):
        align.optimize_ready_patches, align.update_budgets_solved = self.saved


def run_port(ds_dir: str, out_dir: str, trace: Trace) -> dict:
    """The port's tracker experiment on ds_dir on the CPU, traced."""
    ev = Evaluator(Davis240cDataset(ds_dir), EvaluatorParams(
        output_dir=out_dir, run_compensation=False, tracker_experiment=True),
        device="cpu")
    new_image = ev.tracker.new_image

    def recording(t_us, image):
        new_image(t_us, image)
        trace.on_frame(ev.tracker.grads.numpy(), ev.tracker.slot_birth)
    ev.tracker.new_image = recording
    with _PortHooks(trace):
        try:
            ev.run()
        finally:
            ev.stop_workers()
    return {int(k): list(v) for k, v in ev.tracker.trajectories.items()}


# -- comparison -----------------------------------------------------------------
def solves(trace: Trace) -> dict:
    """{(track id, ordinal): (step, index in the step)} over every solve of
    a live track, the ordinal counting that track's solves from 0."""
    out, seen = {}, {}
    for s in trace.steps:
        for i, tid in enumerate(s["pre"]["track_id"].tolist()):
            if tid < 0:
                continue
            n = seen.get(tid, 0)
            seen[tid] = n + 1
            out[(tid, n)] = (s["step"], i)
    return out


def _warp_px(a, b, center):
    """Largest distance between the rect corners moved by warps a and b."""
    pts = torch.tensor(center[None, :] + CORNERS, dtype=torch.float64)
    wa = lie.se2_apply(torch.tensor(a, dtype=torch.float64)[None], pts)
    wb = lie.se2_apply(torch.tensor(b, dtype=torch.float64)[None], pts)
    return float((wa - wb).norm(dim=-1).max())


def _angle(a, b):
    d = abs(float(a) - float(b)) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def row_of(trace: Trace, at) -> dict:
    """One solve's record: its inputs and outputs as plain numbers."""
    s = trace.steps[at[0]]
    i = at[1]
    pre = {k: v[i] for k, v in s["pre"].items()}
    _, _, _, _, valid = ps.newest_events(ps.PatchTable(**{
        k: torch.as_tensor(v[None]) for k, v in pre.items()}))
    valid = valid.numpy()[0]
    birth = trace.frames[s["frame"] - 1]["slot_birth"] if s["frame"] else None
    return dict(
        step=s["step"], frame=s["frame"], pre=pre,
        n_int=int(_integration_size(pre["center"][None], pre["ev_x"][None],
                                    pre["ev_y"][None], valid[None])[0]),
        image=s["image"][i], slot=int(pre["grad_slot"]),
        slot_frame=None if birth is None else int(birth[int(pre["grad_slot"])]),
        slot_sum=float(s["slot_sum"][i]), raw=float(s["raw"][i]),
        cost=float(s["cost"][i]), lost=bool(s["lost"][i]),
        post={k: v[i] for k, v in s["post"].items()})


def compare_rows(a: dict, b: dict) -> dict:
    """The differences between two records of one solve: the integer
    inputs that differ, the float inputs' and the outputs' largest gaps."""
    pa, pb = a["pre"], b["pre"]
    ints = [k for k, x, y in (
        ("step", a["step"], b["step"]),
        ("num_of_events", int(pa["num_of_events"]), int(pb["num_of_events"])),
        ("n_int", a["n_int"], b["n_int"]),
        ("slot", a["slot"], b["slot"]),
        ("slot_frame", a["slot_frame"], b["slot_frame"]),
        ("image", a["image"].tobytes(), b["image"].tobytes())) if x != y]
    qa, qb = a["post"], b["post"]
    return dict(
        int_inputs=ints,
        in_center=float(np.abs(pa["center"] - pb["center"]).max()),
        in_warp=_warp_px(pa["warp"], pb["warp"], pa["center"]),
        in_flow=_angle(pa["flow"], pb["flow"]),
        out_center=float(np.abs(qa["center"] - qb["center"]).max()),
        out_warp=_warp_px(qa["warp"], qb["warp"], pa["center"]),
        out_flow=_angle(qa["flow"], qb["flow"]),
        cost=abs(a["cost"] - b["cost"]), lost=(a["lost"], b["lost"]),
        raw=(a["raw"], b["raw"]),
        budget=(int(qa["num_of_events"]), int(qb["num_of_events"])))


def _float_inputs_apart(d: dict) -> bool:
    return (d["in_center"] > INPUT_PX or d["in_warp"] > INPUT_PX
            or d["in_flow"] > INPUT_RAD)


def _outputs_apart(d: dict, px: float = OUTPUT_PX) -> bool:
    return (d["out_center"] > px or d["out_warp"] > px or d["out_flow"] > px
            or d["lost"][0] != d["lost"][1] or d["budget"][0] != d["budget"][1])


def first_differences(jt: Trace, pt: Trace) -> dict:
    """Walk the common solves in stream order (sub-batch, then `evo_tpu`'s
    row order) and name the first solve with an integer input unequal, the
    first with a float input apart beyond rounding while every earlier
    output agrees to 1e-5 px, and the first output apart by 1e-5 px; also
    the solves only one package ran."""
    js, pts = solves(jt), solves(pt)
    common = sorted(set(js) & set(pts), key=lambda k: js[k])
    found: dict = {"solves": [len(js), len(pts)], "common": len(common),
                   "only_jax": len(set(js) - set(pts)),
                   "only_port": len(set(pts) - set(js))}
    outputs_clean = True
    for key in common:
        a, b = row_of(jt, js[key]), row_of(pt, pts[key])
        d = compare_rows(a, b)
        entry = dict(track=key[0], ordinal=key[1], step=a["step"], **d)
        if d["int_inputs"] and "first_int" not in found:
            found["first_int"] = entry
        if _float_inputs_apart(d) and outputs_clean and "first_float" not in found:
            found["first_float"] = entry
        if _outputs_apart(d) and "first_output" not in found:
            found["first_output"] = entry
            outputs_clean = False
        if {"first_int", "first_output"} <= found.keys() and (
                "first_float" in found or not outputs_clean):
            break
    only = sorted(set(js) ^ set(pts), key=lambda k: js.get(k, pts.get(k)))
    if only:
        found["first_unmatched"] = dict(track=only[0][0], ordinal=only[0][1],
                                        in_jax=only[0] in js)
    return found


# bars of float32 rounding between the two packages' solves of one input:
# their sums run in other orders, and up to 10 LM trips carry it (1.2e-4 px
# at the rect's corners at the 99th percentile of the 6 s scene's solves); a
# trip more or less moves a row 3e-3 px or more
ROUND_PX, ROUND_RAD, ROUND_COST = 5e-4, 2e-5, 2e-5
FTOL_MOVES = (0.98, 1.02)


def _solve_rows(jt: Trace, s: dict, rows: list, ftol_scale: float = 1.0):
    """`evo_tpu`'s inputs of rows `rows` of sub-batch s (the gradient store
    of its frame) through the port's `solve_step_ref` on the CPU, with the
    LM's stop threshold scaled by `ftol_scale`: (table, ran, cost, lost)."""
    table = ps.PatchTable(**{k: torch.as_tensor(v[rows]) for k, v in s["pre"].items()})
    grads, latest = jt.store(s["frame"] - 1)
    saved = align.ALIGN_FTOL
    align.ALIGN_FTOL = saved * ftol_scale
    try:
        return align.solve_step_ref(table, grads, latest)
    finally:
        align.ALIGN_FTOL = saved


def _gaps(new, ran, cost, lost, s: dict, rows: list) -> list[dict]:
    """Per row, the port's solve (`_solve_rows`) against `evo_tpu`'s
    recorded outputs of sub-batch s: centre and the warp's rect corners
    (px), flow (rad), cost (relative), and whether lost, budget and alive
    are equal."""
    post = {k: v[rows] for k, v in s["post"].items()}
    out = []
    for j, i in enumerate(rows):
        out.append(dict(
            ran=bool(ran[j]),
            centre=float(np.abs(new.center[j].numpy() - post["center"][j]).max()),
            warp=_warp_px(new.warp[j].numpy(), post["warp"][j], s["pre"]["center"][i]),
            flow=_angle(new.flow[j], post["flow"][j]),
            cost=abs(float(cost[j]) - float(s["cost"][i])) / abs(float(s["cost"][i])),
            same=(bool(lost[j]) == bool(s["lost"][i])
                  and int(new.num_of_events[j]) == int(post["num_of_events"][j])
                  and bool(new.alive[j]) == bool(post["alive"][j]))))
    return out


def replay_rows(jt: Trace, s: dict, rows=None, ftol_scale: float = 1.0) -> list[dict]:
    """`evo_tpu`'s inputs of sub-batch s (rows `rows` of it, default all)
    through the port's solve, with the LM's stop threshold scaled by
    `ftol_scale`: per row the gaps to `evo_tpu`'s outputs (`_gaps`)."""
    rows = list(range(len(s["rows"])) if rows is None else rows)
    return _gaps(*_solve_rows(jt, s, rows, ftol_scale), s, rows)


def within_rounding(d: dict) -> bool:
    return (d["centre"] <= ROUND_PX and d["warp"] <= ROUND_PX and d["flow"] <= ROUND_RAD
            and d["cost"] <= ROUND_COST and d["same"])


def at_the_stop(jt: Trace, s: dict, i: int) -> bool:
    """Whether row i of sub-batch s gives `evo_tpu`'s outputs to rounding
    once the port's stop threshold moves by 2 % one way or the other: the
    two LMs parted at the stop test `cost - cost_new <= ftol * cost`."""
    return any(within_rounding(replay_rows(jt, s, [i], scale)[0]) for scale in FTOL_MOVES)


# a trip's relative decrease of the cost within TIE of a test's threshold
# (0 for the accept test `cost_new < cost`, ftol for the stop test) is a tie
# that rounding can decide: TIE is 2 % of ftol, as `FTOL_MOVES`, and the
# order of the two packages' cost gaps (a few 1e-6). A candidate's
# residuals scaled by 1 -+ TIE move its cost by TIE to 2 TIE relative (the
# Huber cost is linear, then quadratic, in them), enough to turn any tie.
TIE = 2e-6
CANDIDATE_NUDGES = (-TIE, TIE)


class CandidateNudge:
    """While entered, `align.lm_solve` runs with the linearisation's
    residuals at call `trip` (call 0 is the start, call k the candidate of
    LM trip k) scaled by 1 + `scale`: that candidate's cost moves, and with
    it the trip's accept and stop tests, but not the candidate. `costs`
    records each call's cost as `lm_solve` takes it."""

    def __init__(self, trip: int | None = None, scale: float = 0.0):
        self.trip, self.scale, self.costs = trip, scale, []

    def __enter__(self):
        self._saved = align.lm_solve

        def lm_solve(lin, x0, **kw):
            def nudged(x):
                r, J = lin(x)
                if len(self.costs) == self.trip:
                    r = r * (1.0 + self.scale)
                sq = (r.reshape(r.shape[0], -1, kw["block_size"]) ** 2).sum(-1)
                self.costs.append(huber_cost(sq, kw["huber_delta"]))
                return r, J

            return self._saved(nudged, x0, **kw)

        align.lm_solve = lm_solve
        return self

    def __exit__(self, *exc):
        align.lm_solve = self._saved


def trip_decisions(jt: Trace, s: dict, i: int) -> dict:
    """Row i of sub-batch s through the port's solve, trip by trip: each
    trip's relative decrease of the cost (`(best - cost_new) / best`, best
    the lowest cost before it; accepted where > 0, stopping where also <=
    ftol); the smallest distance of a decrease to each test's threshold
    (`accept_margin`, `stop_margin`); the trips within TIE of one (`ties`);
    `decided_at`: the first tie whose candidate cost, nudged by
    `CANDIDATE_NUDGES`, gives `evo_tpu`'s outputs to rounding (None: no
    tie does). Then the same nudge at every trip: the largest move of the
    port's own outputs (`own_spread`, centre and corners px, flow rad) and
    the first trip whose nudge reaches `evo_tpu`'s outputs to rounding
    (`reached_by`), which shows the gap is the size of the solve's own
    response to a rounding-sized change of one cost, tie or not."""
    rows = [i]
    with CandidateNudge() as plain:
        base = _solve_rows(jt, s, rows)
    costs = [float(c[0]) for c in plain.costs]
    dec = {k: (min(costs[:k]) - costs[k]) / min(costs[:k]) for k in range(1, len(costs))}
    thresholds = dict(accept=0.0, stop=align.ALIGN_FTOL)
    ties = [(k, t) for k in dec for t, at in thresholds.items() if abs(dec[k] - at) <= TIE]
    out = dict(trips=len(costs) - 1, ties=ties, decided_at=None, reached_by=None,
               **{f"{t}_margin": min((abs(v - at) for v in dec.values()), default=None)
                  for t, at in thresholds.items()})
    spread = dict(centre=0.0, warp=0.0, flow=0.0)
    for k in dec:
        for scale in CANDIDATE_NUDGES:
            with CandidateNudge(k, scale):
                new, ran, cost, lost = _solve_rows(jt, s, rows)
            spread["centre"] = max(spread["centre"], float(
                (new.center[0] - base[0].center[0]).abs().max()))
            spread["warp"] = max(spread["warp"], _warp_px(
                new.warp[0].numpy(), base[0].warp[0].numpy(), s["pre"]["center"][i]))
            spread["flow"] = max(spread["flow"], _angle(new.flow[0], base[0].flow[0]))
            if within_rounding(_gaps(new, ran, cost, lost, s, rows)[0]):
                tie = [t for kk, t in ties if kk == k]
                if tie and out["decided_at"] is None:
                    out["decided_at"] = (k, tie[0])
                if out["reached_by"] is None:
                    out["reached_by"] = k
    out["own_spread"] = spread
    return out


def replay_in_float64(jt: Trace, step: int, i: int) -> dict:
    """Row i of sub-batch `step` of `evo_tpu` through the port's solve in
    float32 and in float64 (every float input and the gradient store made
    double), and in float64 from the centre moved one float32 ulp either
    way: the flow angle (rad) of each beside `evo_tpu`'s, whether float64
    lies between the two float32 answers (`straddled`), and how far the
    nudged float64 solves move it (`f64_spread`). A float64 answer that the
    float32 runs straddle, and that rounding-sized input changes do not
    move, says the two float32 answers part by rounding alone."""
    s = jt.steps[step]
    grads, latest = jt.store(s["frame"] - 1)

    def solve(dtype, nudge: float = 0.0):
        pre = {k: torch.as_tensor(v[[i]]) for k, v in s["pre"].items()}
        if nudge:
            pre["center"] = torch.as_tensor(np.nextafter(
                s["pre"]["center"][[i]], np.float32(nudge * np.inf)))
        pre = {k: v.to(dtype) if v.is_floating_point() else v for k, v in pre.items()}
        with CandidateNudge() as calls:
            new, ran, cost, lost = align.solve_step_ref(ps.PatchTable(**pre), grads.to(dtype),
                                                        latest.to(dtype))
        return dict(flow=float(new.flow[0]), cost=float(cost[0]), trips=len(calls.costs) - 1)

    f32, f64 = solve(torch.float32), solve(torch.float64)
    nudged = [solve(torch.float64, n)["flow"] for n in (-1.0, 1.0)]
    jax_flow = float(s["post"]["flow"][i])
    lo, hi = sorted((jax_flow, f32["flow"]))
    return dict(step=step, row=i, track=int(s["pre"]["track_id"][i]),
                evo_tpu_flow=jax_flow, port_f32_flow=f32["flow"], f64_flow=f64["flow"],
                f32_apart=_angle(jax_flow, f32["flow"]),
                f64_to_evo_tpu=_angle(f64["flow"], jax_flow),
                f64_to_port=_angle(f64["flow"], f32["flow"]),
                straddled=lo <= f64["flow"] <= hi,
                f64_spread=max(_angle(f, f64["flow"]) for f in nudged),
                costs=dict(evo_tpu=float(s["cost"][i]), port_f32=f32["cost"],
                           f64=f64["cost"]),
                trips=dict(port_f32=f32["trips"], f64=f64["trips"]))


def replay_through_port(jt: Trace, at) -> dict:
    """One sub-batch of `evo_tpu` through the port's solve: the largest
    gaps over its rows."""
    s = jt.steps[at[0]]
    got = replay_rows(jt, s)
    return dict(step=s["step"], rows=len(got), ran=all(d["ran"] for d in got),
                **{k: max(d[k] for d in got) for k in ("centre", "warp", "flow", "cost")},
                same=all(d["same"] for d in got))


def _geometry_within_rounding(d: dict) -> bool:
    return (d["centre"] <= ROUND_PX and d["warp"] <= ROUND_PX and d["flow"] <= ROUND_RAD
            and d["cost"] <= ROUND_COST)


def replay_summary(jt: Trace) -> dict:
    """Every sub-batch of `evo_tpu` replayed through the port's solve: the
    quantiles of the centres' and warps' gaps (px) to `evo_tpu`'s outputs;
    the solves beyond rounding, and how many of them sit at the LM's stop
    (`at_the_stop`); the others (`elsewhere`), each with its gaps, whether
    its geometry is within rounding (then only the budget, `lost` or
    `alive` differ: an integer decided on a float) and its
    `trip_decisions`; of those, how many are decided at one trip's accept
    or stop test (`decided_at`), how many the solve's own response to a
    rounding-sized change of one cost reaches (`reached_by`), and how many
    neither (`undecided`)."""
    centre, warp, apart = [], [], []
    for s in jt.steps:
        if len(s["rows"]) == 0:
            continue
        for i, d in enumerate(replay_rows(jt, s)):
            centre.append(d["centre"])
            warp.append(d["warp"])
            if not within_rounding(d):
                apart.append((s, i, d))
    q = (0.5, 0.9, 0.99, 1.0)
    stop = [at_the_stop(jt, s, i) for s, i, _ in apart]
    elsewhere = [dict(step=s["step"], row=i, track=int(s["pre"]["track_id"][i]),
                      geometry_within_rounding=_geometry_within_rounding(d),
                      **d, **trip_decisions(jt, s, i))
                 for (s, i, d), st in zip(apart, stop) if not st]
    tests = [e["decided_at"][1] for e in elsewhere if e["decided_at"]]
    reached = [e for e in elsewhere if not e["decided_at"] and e["reached_by"]]
    return dict(solves=len(centre), centre_px=dict(zip(q, np.quantile(centre, q).tolist())),
                warp_px=dict(zip(q, np.quantile(warp, q).tolist())),
                beyond_rounding=len(apart), at_the_stop=sum(stop),
                decided_at={t: tests.count(t) for t in ("accept", "stop")},
                reached_by_own_spread=len(reached),
                undecided=len(elsewhere) - len(tests) - len(reached), elsewhere=elsewhere,
                first=[(s["step"], i, int(s["pre"]["track_id"][i]), d["centre"], d["warp"])
                       for s, i, d in apart[:10]])


def score(trajectories: dict, ds_dir: str, per_track: bool = False) -> dict:
    """(error px, age s, tracks) by the port's scorer and by `evo_tpu`'s;
    with `per_track`, also the port scorer's error of each track."""
    ds = Davis240cDataset(ds_dir)
    p = quality.evaluate_tracker(trajectories, ds.gt_t_us, ds.gt_poses, ds.calib,
                                 plane_depth=2.0, scene="plane", device="cpu")
    jds = jdavis.Davis240cDataset(ds_dir)
    j = jquality.evaluate_tracker(trajectories, jds.gt_t_us, jds.gt_poses, jds.calib,
                                  plane_depth=2.0, scene="plane")
    out = dict(port=[float(p.mean_distance_error_px), float(p.mean_feature_age_s),
                     int(p.num_tracks)],
               evo_tpu=[float(j.mean_distance_error_px), float(j.mean_feature_age_s),
                        int(j.num_tracks)])
    if per_track:
        out["per_track"] = {int(k): float(v) for k, v in p.per_track_error.items()}
    return out


def gap_by_track(a: dict, b: dict, top: int = 8) -> dict:
    """Where two runs' mean track errors part: the tracks of both with the
    largest |error b - error a| (px), and the share of the mean's gap they
    carry."""
    common = sorted(set(a) & set(b))
    diff = {t: b[t] - a[t] for t in common}
    order = sorted(common, key=lambda t: -abs(diff[t]))
    total = sum(diff.values()) / max(len(common), 1)
    head = sum(diff[t] for t in order[:top]) / max(len(common), 1)
    return dict(tracks=len(common), mean_gap_px=total, top=[(t, a[t], b[t]) for t in order[:top]],
                top_share=head / total if total else None,
                apart_1e_3=sum(abs(v) > 1e-3 for v in diff.values()),
                apart_0_1=sum(abs(v) > 0.1 for v in diff.values()))


def trace_both(ds_dir: str, work: str) -> tuple[Trace, dict, Trace, dict]:
    jt, pt = Trace(), Trace()
    jtraj = run_jax(ds_dir, os.path.join(work, "jax"), jt)
    ptraj = run_port(ds_dir, os.path.join(work, "port"), pt)
    return jt, jtraj, pt, ptraj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="JSON report path")
    ap.add_argument("--scene", choices=tuple(ROWS), default="shapes")
    ap.add_argument("--duration", type=float, default=None,
                    help="seconds of the scene (default: its row's, 6 or 12)")
    ap.add_argument("--control", nargs="*", default=[], choices=("centre", "budget"))
    ap.add_argument("--replay-float64", nargs="*", default=[], metavar="STEP:ROW",
                    help="trace `evo_tpu` alone and replay these solves in float32 and "
                    "float64 (`replay_in_float64`)")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as work:
        ds_dir = write_scene(work, args.duration, args.scene)
        if args.replay_float64:
            jt = Trace()
            run_jax(ds_dir, os.path.join(work, "jax"), jt)
            report = dict(scene=args.scene, duration_s=args.duration, steps=len(jt.steps),
                          replays=[replay_in_float64(jt, *map(int, at.split(":")))
                                   for at in args.replay_float64])
            print(json.dumps(report, indent=1, default=str))
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)
            return 0
        jt, jtraj, pt, ptraj = trace_both(ds_dir, work)
        report = dict(scene=args.scene, duration_s=args.duration,
                      steps=[len(jt.steps), len(pt.steps)],
                      first=first_differences(jt, pt))
        js = solves(jt)
        for name in ("first_int", "first_float", "first_output"):
            f = report["first"].get(name)
            if f is not None:
                report[f"replay_{name}"] = replay_through_port(
                    jt, js[(f["track"], f["ordinal"])])
        report["replay_all"] = replay_summary(jt)
        # where the rows part, track by track (the port's run, then each
        # control, against `evo_tpu`'s)
        js_, ps_ = score(jtraj, ds_dir, True), score(ptraj, ds_dir, True)
        j_tracks = js_.pop("per_track")
        report["gap_by_track"] = gap_by_track(j_tracks, ps_.pop("per_track"))
        report["scores"] = dict(evo_tpu=js_, port=ps_)
        for nudge in args.control:
            ctraj = run_jax(ds_dir, os.path.join(work, nudge), control=nudge)
            cs = score(ctraj, ds_dir, True)
            cs["gap_by_track"] = gap_by_track(j_tracks, cs.pop("per_track"))
            report[f"control_{nudge}"] = cs
    print(json.dumps(report, indent=1, default=str))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
