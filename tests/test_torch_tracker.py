"""The port's tracker (routing, alignment, the whole tracker experiment)
against the JAX package's, on the same inputs: synthetic rings for the
routing, and the JAX simulator's `plane` scene written as a dataset for the
rest — both packages read the same files.

Tolerances, each with its reason:
- routing moves data: ring contents and counts identical;
- one alignment solve on the same table: cost within 1e-4 and params within
  1e-4 relative (float32 sampling and 4x4 solves in another summation
  order; the linearizations agree to ~1e-6, and the LM carries that noise
  along flat directions of the cost into translations of several px),
  `ran` and `lost` identical;
- the whole slice: the same track ids, >= 95 % of the trajectory points the
  two share within 0.05 px, final-cost row counts within 2 %, the first
  compensation field within 1e-2 px/ms. A solve that lands a hair apart
  can flip a later accept/reject or lost decision, so the slice is held to
  shares rather than to every point.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.io import davis as jdavis
from evo_tpu.io import sim as jsim
from evo_tpu.run import evaluator as jeval
from evo_tpu.tracker import align as jalign
from evo_tpu.tracker import compensate as jcomp
from evo_tpu.tracker import detector as jdet
from evo_tpu.tracker import patch_state as jps
from evo_tpu_torch.io import davis as tdavis
from evo_tpu_torch.run import evaluator as teval
from evo_tpu_torch.tracker import align as talign
from evo_tpu_torch.tracker import compensate as tcomp
from evo_tpu_torch.tracker import detector as tdet
from evo_tpu_torch.tracker import patch_state as tps

torch.set_num_threads(1)

CAPACITY = 32


def _jax_table_numpy(table) -> dict:
    return {f.name: np.asarray(getattr(table, f.name))
            for f in dataclasses.fields(table)}


def test_route_events_ring_matches_jax():
    rng = np.random.default_rng(3)
    p, n = CAPACITY, 1500
    table = jps.empty_table(p)
    centers = rng.uniform(20, 100, (p, 2)).astype(np.float32)
    alive = rng.uniform(size=p) < 0.8
    # rings part full, full, and about to wrap; two patches collect > E hits
    ev_count = rng.integers(0, 700, p).astype(np.int32)
    centers[:2] = [60.0, 60.0]
    alive[:2] = True
    table = dataclasses.replace(
        table, alive=jnp.asarray(alive), center=jnp.asarray(centers),
        ev_count=jnp.asarray(ev_count),
        ev_t=jnp.asarray(rng.uniform(size=(p, jps.MAX_EVENTS)).astype(np.float32)),
    )
    ex = np.round(rng.uniform(40, 80, n)).astype(np.float32)
    ey = np.round(rng.uniform(40, 80, n)).astype(np.float32)
    et = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    ep = rng.choice([-1.0, 1.0], n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.95
    ref = _jax_table_numpy(jps.route_events(
        table, *(jnp.asarray(a) for a in (ex, ey, et, ep, mask))))
    ours = tps.table_to_numpy(tps.route_events(
        tps.table_from_numpy(_jax_table_numpy(table), device="cpu"),
        *(torch.from_numpy(a) for a in (ex, ey, et, ep, mask))))
    assert (ref["ev_count"] - ev_count)[:2].min() > jps.MAX_EVENTS
    for name in ("ev_t", "ev_x", "ev_y", "ev_p", "ev_count", "counter"):
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


@pytest.fixture(scope="module")
def plane_dataset(tmp_path_factory):
    """0.3 s of the JAX simulator's plane scene at 20 fps, written as a
    dataset directory."""
    out = tmp_path_factory.mktemp("plane")
    s = jsim.EventCameraSimulator(jsim.SimParams(duration_s=0.3, fps=20.0, seed=1))
    return jsim.write_dataset(str(out), s.generate())


def test_optimize_ready_patches_matches_jax(plane_dataset):
    ds = jdavis.Davis240cDataset(plane_dataset)
    tr = jdet.EventTracker(jdet.TrackerParams(capacity=CAPACITY))
    tr.new_image(int(ds.image_t_us[0]), ds.image_u8(0))
    tr.new_image(int(ds.image_t_us[1]), ds.image_u8(1))
    lo, hi = np.searchsorted(ds.events.t_us, ds.image_t_us[1:3])
    ev = ds.events.slice(lo, min(hi, lo + 5000))
    bounds = [(0, len(ev))]
    xyp, trel, offset, _ = tr._window_batches(ev.t_us, ev.x, ev.y, ev.p, bounds, len(ev))
    ex, ey, et, ep, mask = jdet.unpack_events(jnp.asarray(xyp), jnp.asarray(trel),
                                              jnp.asarray(offset))
    table = jps.route_events(tr.table, ex[0], ey[0], et[0], ep[0], mask[0])
    j_table, j_info = jalign.optimize_ready_patches(table, tr.grads)

    t_table, t_info = talign.optimize_ready_patches(
        tps.table_from_numpy(_jax_table_numpy(table), device="cpu"),
        torch.tensor(np.asarray(tr.grads)))
    ran = np.asarray(j_info["ran"])
    assert ran.sum() >= 5
    np.testing.assert_array_equal(t_info["ran"].numpy(), ran)
    np.testing.assert_array_equal(t_info["lost"].numpy(), np.asarray(j_info["lost"]))
    np.testing.assert_allclose(t_info["cost"].numpy(), np.asarray(j_info["cost"]), atol=1e-4)
    ref = _jax_table_numpy(j_table)
    ours = tps.table_to_numpy(t_table)
    for name in ("warp", "flow", "center"):
        np.testing.assert_allclose(ours[name][ran], ref[name][ran], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for name in ("alive", "counter", "n_costs", "cur_t", "last_update_t"):
        np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)


def _record(monkeypatch, module, log):
    inner = module.compensate_window

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        log.append(np.asarray(out[0]))
        return out

    monkeypatch.setattr(module, "compensate_window", recording)


def test_tracker_experiment_matches_jax(plane_dataset, tmp_path, monkeypatch):
    """The whole slice: the tracker experiment with compensation, JAX
    Evaluator against the port's, on one dataset directory."""
    shared = dict(tracker_experiment=True, run_compensation=True)
    tracker = dict(capacity=CAPACITY)
    j_fields, t_fields = [], []
    _record(monkeypatch, jcomp, j_fields)
    _record(monkeypatch, tcomp, t_fields)

    j_ev = jeval.Evaluator(jdavis.Davis240cDataset(plane_dataset), jeval.EvaluatorParams(
        output_dir=str(tmp_path / "jax"), tracker=jdet.TrackerParams(**tracker), **shared))
    j_ev.run()
    j_paths = j_ev.finish()
    t_ev = teval.Evaluator(tdavis.Davis240cDataset(plane_dataset), teval.EvaluatorParams(
        output_dir=str(tmp_path / "torch"), tracker=tdet.TrackerParams(**tracker), **shared),
        device="cpu")
    t_ev.run()
    t_paths = t_ev.finish()

    j_tr = jdavis.parse_trajectory(j_paths["trajectory"])
    t_tr = tdavis.parse_trajectory(t_paths["trajectory"])
    assert len(j_tr) >= 10
    assert set(t_tr) == set(j_tr)
    close = total = 0
    for tid, (j_t, j_xy) in j_tr.items():
        t_t, t_xy = t_tr[tid]
        common, ji, ti = np.intersect1d(j_t, t_t, return_indices=True)
        total += len(common)
        close += int((np.linalg.norm(j_xy[ji] - t_xy[ti], axis=1) <= 0.05).sum())
    assert total >= 100
    assert close >= 0.95 * total, (close, total)

    j_rows = len(np.loadtxt(j_paths["final_cost"], ndmin=2))
    t_rows = len(np.loadtxt(t_paths["final_cost"], ndmin=2))
    assert j_rows > 50
    assert abs(t_rows - j_rows) <= 0.02 * j_rows, (t_rows, j_rows)

    assert len(j_fields) >= 2 and len(t_fields) == len(j_fields)
    np.testing.assert_allclose(t_fields[0], j_fields[0], atol=1e-2)
    assert os.path.exists(t_paths["final_cost"])


def test_event_window_from_carried_state_matches_jax(plane_dataset):
    """A JAX tracker's state (table, gradient store, slot bookkeeping) is
    carried into the port, and both process the next frame window: the same
    solve log and trajectory extensions."""
    ds = jdavis.Davis240cDataset(plane_dataset)
    jtr = jdet.EventTracker(jdet.TrackerParams(capacity=CAPACITY))
    for k in (0, 1):
        jtr.new_image(int(ds.image_t_us[k]), ds.image_u8(k))
    ttr = tdet.EventTracker(tdet.TrackerParams(capacity=CAPACITY), device="cpu")
    ttr.table = tps.table_from_numpy(_jax_table_numpy(jtr.table), device="cpu")
    ttr.load_numpy_state(np.asarray(jtr.grads), jtr.slot_refcount, jtr.slot_birth,
                         jtr.next_track_id, jtr.epoch_us)
    ttr.trajectories = {k: list(v) for k, v in jtr.trajectories.items()}
    ttr.archived_tracks = set(jtr.archived_tracks)
    lo, hi = np.searchsorted(ds.events.t_us, ds.image_t_us[1:3])
    ev = ds.events.slice(lo, hi)
    args = (ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
            ev.p.astype(np.float64))
    jtr.process_events(*args)
    ttr.process_events(*args)
    j_log, t_log = jtr.final_cost_log, ttr.final_cost_log
    assert len(j_log) >= 20
    assert [(tid, t) for tid, _, t in t_log] == [(tid, t) for tid, _, t in j_log]
    np.testing.assert_allclose([c for _, c, _ in t_log], [c for _, c, _ in j_log],
                               atol=1e-4)
    assert set(ttr.trajectories) == set(jtr.trajectories)
    for tid, entries in jtr.trajectories.items():
        ours = np.asarray(ttr.trajectories[tid], np.float64)
        ref = np.asarray(entries, np.float64)
        np.testing.assert_array_equal(ours[:, 0], ref[:, 0])
        np.testing.assert_allclose(ours[:, 1:], ref[:, 1:], atol=1e-3)
    assert ttr.archived_tracks == jtr.archived_tracks


@pytest.mark.parametrize("block_size, lk_levels", [(5, 3), (3, 4)])
def test_new_image_on_the_cpu_takes_any_block_and_depth(plane_dataset, block_size, lk_levels):
    """The frame step on the CPU with a Harris box other than the frame
    kernels' 3x3, or an LK pyramid deeper than their three levels (the
    plain versions take any): after each of three frames the same rows
    alive and initialized with the same track ids, and centres and warps
    within 1e-3 px (LK's float32 flow, `tests/test_torch_frame.py`'s bar).
    At 180x240 a fourth level is 23 px high, too few for LK's window and
    its travel slack, so both trackers lose the rows there."""
    ds = jdavis.Davis240cDataset(plane_dataset)
    kw = dict(capacity=CAPACITY, block_size=block_size, lk_levels=lk_levels)
    jtr = jdet.EventTracker(jdet.TrackerParams(**kw))
    ttr = tdet.EventTracker(tdet.TrackerParams(**kw), device="cpu")
    for k in range(3):
        jtr.new_image(int(ds.image_t_us[k]), ds.image_u8(k))
        ttr.new_image(int(ds.image_t_us[k]), ds.image_u8(k))
        ref, ours = _jax_table_numpy(jtr.table), tps.table_to_numpy(ttr.table)
        assert k > 0 or ref["alive"].sum() >= 5
        for name in ("alive", "initialized", "track_id"):
            np.testing.assert_array_equal(ours[name], ref[name], err_msg=name)
        live = ref["alive"]
        for name in ("center", "warp"):
            np.testing.assert_allclose(ours[name][live], ref[name][live], atol=1e-3,
                                       err_msg=name)
    assert bool(ref["initialized"].sum() >= 5) is (lk_levels == 3)
