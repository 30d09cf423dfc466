"""The port's pipelined drive and track-field compensation, on the CPU.

(a) `policy.frame_policy` against the JAX package's and against the port's
    host policy on randomized tables: masks, ids and slot exact, centres 1e-6;
(b) the port's pipelined drive against its synchronous one on one scene
    (depth 8, depth 2, inline VO, host policy): timestamps equal, positions
    1e-4, motion field 1e-5, VO rows 1e-4 — the tolerances of
    `tests/test_run.py::test_pipelined_matches_sync`;
(c) the port's pipelined drive against the JAX package's, to the tolerances
    of `test_torch_cli.py::test_standard_mode_matches_jax` (the trackers agree
    to float32 noise only: keyframes within 1, ATE within a factor 1.5);
(d) `motion_field`: the interpolation level by level and
    `compensate_from_tracks` against the JAX package, 1e-5 absolute on the
    field, the count image exact;
(e) an exception on either worker thread ends the run with that exception;
(f) `Counters` counts exactly under three threads.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.tracker import detector as jdet
from evo_tpu.tracker import motion_field as jmf
from evo_tpu.tracker import patch_state as jps
from evo_tpu.tracker import policy as jpolicy
from evo_tpu_torch.io import sim
from evo_tpu_torch.run import evaluator as teval
from evo_tpu_torch.run.metrics import Counters
from evo_tpu_torch.tracker import compensate as tcomp
from evo_tpu_torch.tracker import detector as tdet
from evo_tpu_torch.tracker import motion_field as tmf
from evo_tpu_torch.tracker import patch_state as tps
from evo_tpu_torch.tracker import policy as tpolicy
from evo_tpu_torch.vo.frontend import VoParams
from torch_policy_cases import random_table

torch.set_num_threads(1)

P = jps.MAX_PATCHES


# -- (a) the frame policy ---------------------------------------------------

def _three_policies(s):
    """(port host policy, port device policy + state, JAX device policy)."""
    mirror = {k: s[k] for k in ("alive", "center", "track_id", "grad_slot")}
    tr = tdet.EventTracker(device="cpu")
    tr.slot_refcount = s["refcount"].copy()
    tr.slot_birth = s["slot_birth"].copy()
    tr.num_images, tr.next_track_id = 50, 1000
    host = tr._frame_policy(0, s["corners"][s["ok"]], mirror)

    view = tpolicy.TableView(**{k: torch.from_numpy(v) for k, v in mirror.items()})
    state = tpolicy.PolicyState(
        slot_birth=torch.from_numpy(s["slot_birth"].astype(np.int32)),
        next_tid=torch.tensor(1000, dtype=torch.int32),
        frame_no=torch.tensor(50, dtype=torch.int32))
    dec, new_state = tpolicy.frame_policy(
        view, state, torch.from_numpy(s["corners"]), torch.from_numpy(s["ok"]),
        max_patches=tr.params.max_patches,
        association_distance=tr.params.association_distance)
    dec = {k: v.numpy() for k, v in dec.items()}

    jview = jpolicy.TableView(**{k: jnp.asarray(v) for k, v in mirror.items()})
    jstate = jpolicy.PolicyState(
        slot_birth=jnp.asarray(s["slot_birth"], jnp.int32),
        next_tid=jnp.asarray(1000, jnp.int32), frame_no=jnp.asarray(50, jnp.int32))
    jdec, jnew = jpolicy.frame_policy(
        jview, jstate, jnp.asarray(s["corners"]), jnp.asarray(s["ok"]),
        max_patches=tr.params.max_patches,
        association_distance=tr.params.association_distance)
    jdec = jax.tree.map(np.asarray, jdec)
    for a, b in ((new_state.slot_birth, jnew.slot_birth), (new_state.next_tid, jnew.next_tid),
                 (new_state.frame_no, jnew.frame_no)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return host, dec, new_state, jdec


def _assert_same_decisions(dec, ref):
    assert int(dec["slot"]) == int(ref["slot"])
    for name in ("evict", "new_mask", "new_tid"):
        np.testing.assert_array_equal(dec[name], ref[name], err_msg=name)
    np.testing.assert_allclose(dec["new_center"], ref["new_center"], atol=1e-6)


@pytest.mark.parametrize("case", [
    dict(seed=0), dict(seed=1), dict(seed=2, n_alive=70, n_corners=100),
    dict(seed=3, n_alive=5, n_corners=30), dict(seed=4, n_alive=95, n_corners=80),
    dict(seed=5, exhaust_slots=True),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_frame_policy_matches_jax_and_host(case):
    case = dict(case)
    s = random_table(np.random.default_rng(case.pop("seed")), **case)
    host, dec, new_state, jdec = _three_policies(s)
    _assert_same_decisions(dec, jdec)
    _assert_same_decisions(dec, host)
    assert dec["new_mask"].any() or case.get("n_alive") == 95 or case.get("exhaust_slots")
    if case.get("exhaust_slots"):
        assert dec["evict"].any()
        assert new_state.slot_birth[int(dec["slot"])] == 50
        assert int(dec["slot"]) == int(np.argmin(s["slot_birth"]))
    else:
        assert not dec["evict"].any()
    # the live cap holds
    n_after = s["alive"].sum() - dec["evict"].sum() + dec["new_mask"].sum()
    assert n_after <= 100 or case.get("exhaust_slots")
    assert int(dec["n_new"]) == dec["new_mask"].sum()
    assert int(new_state.next_tid) == 1000 + dec["new_mask"].sum()


def test_slot_refcounts_matches_jax():
    s = random_table(np.random.default_rng(9))
    fields = {k: s[k] for k in ("alive", "center", "track_id", "grad_slot")}
    ours = tpolicy.slot_refcounts(
        tpolicy.TableView(**{k: torch.from_numpy(v) for k, v in fields.items()}), P)
    ref = jpolicy.slot_refcounts(
        jpolicy.TableView(**{k: jnp.asarray(v) for k, v in fields.items()}), P)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy(), s["refcount"])


# -- (b) pipelined == synchronous, in the port ------------------------------

@pytest.fixture(scope="module")
def scene():
    """The port's plane scene, 0.5 s at 20 fps: 10 frames, 8 keyframe
    candidates."""
    return sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2), device="cpu").generate())


def _drive(scene, out_dir, **kw):
    """The standard mode at a small size: 48 table rows, so VO accepts a
    keyframe at 25 inliers; compensation every 20 k events, 2 LM iterations."""
    out_dir.mkdir()
    kw.setdefault("tracker", tdet.TrackerParams(capacity=48, max_patches=48))
    ev = teval.Evaluator(scene, teval.EvaluatorParams(
        output_dir=str(out_dir), compensation_events=20_000,
        compensate=tcomp.CompensateParams(max_iters=2, events_per_tile_cap=512),
        vo=VoParams(num_inliers=25), **kw), device="cpu")
    ev.run()
    paths = ev.finish()
    return ev, np.loadtxt(paths["vo_trajectory"], ndmin=2)


@pytest.fixture(scope="module")
def sync_run(scene, tmp_path_factory):
    return _drive(scene, tmp_path_factory.mktemp("sync") / "out", pipelined=False)


@pytest.fixture
def new_workers():
    """Names of the worker threads started since the test began and still
    alive (the JAX package's own `evo-vo` thread never ends)."""
    before = {t.ident for t in threading.enumerate()}
    return lambda: [t.name for t in threading.enumerate()
                    if t.name.startswith("evo-") and t.ident not in before]


@pytest.mark.parametrize("variant", ["pipe", "depth2", "inline_vo", "host_policy"])
def test_pipelined_matches_sync(scene, sync_run, tmp_path, new_workers, variant):
    kw = dict(
        pipe={}, depth2=dict(pipeline_depth=2), inline_vo=dict(async_vo=False),
        host_policy=dict(tracker=tdet.TrackerParams(capacity=48, max_patches=48,
                                                    device_policy=False)))[variant]
    s_ev, s_rows = sync_run
    ev, rows = _drive(scene, tmp_path / "out", **kw)
    assert ev.params.pipelined and "tracker_window" in ev.counters.times
    assert "tracker_events" in s_ev.counters.times
    t_sync, t_pipe = s_ev.tracker.trajectories, ev.tracker.trajectories
    assert set(t_sync) == set(t_pipe) and len(t_sync) > 40
    for tid, entries in t_sync.items():
        a, b = np.asarray(entries), np.asarray(t_pipe[tid])
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=1e-4)
    assert ev.tracker.final_cost_log == s_ev.tracker.final_cost_log
    assert ev.tracker.next_track_id == s_ev.tracker.next_track_id
    assert ev.tracker.archived_tracks == s_ev.tracker.archived_tracks
    for name in ("events", "frames", "solves", "compensation_windows"):
        assert ev.counters.counts[name] == s_ev.counters.counts[name], name
    assert ev.counters.counts["compensation_windows"] >= 4
    np.testing.assert_allclose(ev.motion_field, s_ev.motion_field, atol=1e-5)
    np.testing.assert_array_equal(ev.compensated_image, s_ev.compensated_image)
    np.testing.assert_allclose(ev.compensation_costs, s_ev.compensation_costs, rtol=1e-6)
    assert len(rows) == len(s_rows) >= 6
    np.testing.assert_allclose(rows, s_rows, atol=1e-4)
    assert ev.counters.calls["vo"] == s_ev.counters.calls["vo"] == 8
    # finish() drained and ended both workers
    assert not ev._pending_frames and not ev._pending_comp and not new_workers()
    assert ev._vo_queue is None or ev._vo_queue.empty()


# -- (c) the port's pipelined drive against the JAX package's ---------------

def test_pipelined_matches_jax_pipelined(tmp_path):
    from evo_tpu.io.davis import Davis240cDataset as JDataset
    from evo_tpu.run import evaluator as jeval
    from evo_tpu_torch.io.davis import Davis240cDataset
    from test_torch_cli import _simulated
    from test_torch_vo import JaxKeyStream

    (tmp_path / "ds").mkdir()
    ds_dir = _simulated(tmp_path / "ds", 0.5)
    jev = jeval.Evaluator(JDataset(ds_dir), jeval.EvaluatorParams(
        output_dir=str(tmp_path / "jax"), run_compensation=False))
    assert jev.params.pipelined and jev.params.async_vo
    jev.run()
    jrows = np.loadtxt(jev.finish()["vo_trajectory"], ndmin=2)
    ev = teval.Evaluator(Davis240cDataset(ds_dir), teval.EvaluatorParams(
        output_dir=str(tmp_path / "torch"), run_compensation=False), device="cpu")
    assert ev.params.pipelined and ev.params.async_vo and ev.params.tracker.device_policy
    ev.vo._sample_indices = JaxKeyStream()
    ev.run()
    rows = np.loadtxt(ev.finish()["vo_trajectory"], ndmin=2)
    assert "tracker_window" in ev.counters.times and "tracker_window" in jev.counters.times
    assert rows.shape[1] == 12 and np.isfinite(rows).all()
    assert len(rows) > 5 and abs(len(rows) - len(jrows)) <= 1
    a, ja = ev.vo.last_ate, jev.vo.last_ate
    assert np.isfinite(a.rmse) and a.rmse > 0
    assert max(a.rmse, ja.rmse) <= 1.5 * min(a.rmse, ja.rmse), (a, ja)
    # the trackers found the same tracks, frame for frame
    assert ev.tracker.next_track_id == jev.tracker.next_track_id
    assert set(ev.tracker.trajectories) == set(jev.tracker.trajectories)
    np.testing.assert_allclose(rows[0], np.eye(4)[:3].reshape(-1), atol=1e-7)


def test_frame_window_from_carried_state_matches_jax(tmp_path):
    """A JAX tracker's state after two fused frame windows, policy state
    included, is carried into the port; both process the third window."""
    from evo_tpu.io.davis import Davis240cDataset as JDataset
    from evo_tpu.io.replay import FrameWindowIterator as JWindows
    from test_torch_cli import _simulated

    (tmp_path / "ds").mkdir()
    ds = JDataset(_simulated(tmp_path / "ds", 0.2))
    cap = 32
    jtr = jdet.EventTracker(jdet.TrackerParams(capacity=cap))
    wins = list(JWindows(ds))[:3]

    def step(tr, w):
        ev = w.events
        t, h = tr.process_frame_window(
            ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
            ev.p.astype(np.float64), w.image_t_us, w.image)
        return tr.consume_frame(t, h)

    for w in wins[:2]:
        step(jtr, w)
    ttr = tdet.EventTracker(tdet.TrackerParams(capacity=cap), device="cpu")
    ttr.table = tps.table_from_numpy(
        {f.name: np.asarray(getattr(jtr.table, f.name))
         for f in dataclasses.fields(jtr.table)}, device="cpu")
    ttr.load_numpy_state(
        np.asarray(jtr.grads), jtr.slot_refcount, jtr.slot_birth, jtr.next_track_id,
        jtr.epoch_us, pstate={k: np.asarray(getattr(jtr.pstate, k))
                              for k in ("slot_birth", "next_tid", "frame_no")})
    ttr.num_images = jtr.num_images
    ttr.prev_image = torch.tensor(np.asarray(jtr.prev_image))
    ttr.trajectories = {k: list(v) for k, v in jtr.trajectories.items()}
    ttr.archived_tracks = set(jtr.archived_tracks)
    jm, tm = step(jtr, wins[2]), step(ttr, wins[2])
    assert int(ttr.pstate.frame_no) == int(jtr.pstate.frame_no) == 3
    np.testing.assert_array_equal(ttr.pstate.slot_birth.numpy(),
                                  np.asarray(jtr.pstate.slot_birth))
    assert int(ttr.pstate.next_tid) == int(jtr.pstate.next_tid) == ttr.next_track_id
    for name in ("alive", "track_id", "grad_slot", "num_of_events"):
        np.testing.assert_array_equal(tm[name], jm[name], err_msg=name)
    live = jm["alive"]
    assert live.sum() >= 10
    np.testing.assert_allclose(tm["center"][live], jm["center"][live], atol=1e-3)
    assert [(tid, t) for tid, _, t in ttr.final_cost_log] == \
        [(tid, t) for tid, _, t in jtr.final_cost_log]
    assert len(ttr.final_cost_log) >= 10
    assert set(ttr.trajectories) == set(jtr.trajectories)


# -- (d) track-field compensation -------------------------------------------

def _jax_levels(xy, vel, count, height, width, levels=4, iters=60):
    """The cascade of `evo_tpu.tracker.motion_field.interpolate_field`, its
    own statements, keeping every level's field."""
    k = xy.shape[0]
    valid = (jnp.arange(k) < count)[:, None]
    w = valid.astype(jnp.float32)
    mean_v = jnp.sum(vel * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    field, out = None, []
    for lvl in range(levels - 1, -1, -1):
        s = 2 ** lvl
        h, wd = height // s, width // s
        xi = jnp.clip(xy[:, 0] // s, 0, wd - 1)
        yi = jnp.clip(xy[:, 1] // s, 0, h - 1)
        cnt = jnp.zeros((h, wd, 1), jnp.float32).at[yi, xi].add(w[:, 0:1])
        acc = jnp.zeros((h, wd, 2), jnp.float32).at[yi, xi].add(vel * w)
        fmask = cnt > 0
        fval = acc / jnp.maximum(cnt, 1.0)
        if field is None:
            field = jnp.broadcast_to(mean_v, (h, wd, 2))
        else:
            field = jax.image.resize(field, (h, wd, 2), method="bilinear")
        field = jmf._jacobi(jnp.where(fmask, fval, field), fmask, fval, iters)
        out.append(np.asarray(field))
    return out


def test_interpolate_field_matches_jax_level_by_level():
    rng = np.random.default_rng(4)
    k, n = 32, 23  # padded samples, 23 valid; two share a coarse cell
    xy = np.zeros((k, 2), np.int32)
    xy[:n] = np.stack([rng.integers(0, 240, n), rng.integers(0, 180, n)], -1)
    xy[1] = xy[0] + [1, 0]
    vel = np.zeros((k, 2), np.float32)
    vel[:n] = rng.normal(0, 0.2, (n, 2))
    ref_levels = _jax_levels(jnp.asarray(xy), jnp.asarray(vel), jnp.asarray(n), 180, 240)
    ref = np.asarray(jmf.interpolate_field(jnp.asarray(xy), jnp.asarray(vel), jnp.asarray(n)))
    np.testing.assert_allclose(ref_levels[-1], ref, atol=1e-7)
    levels = tmf.interpolate_levels(xy, vel, n, device="cpu")
    ours = tmf.interpolate_field(xy, vel, n, device="cpu")
    # 180x240 halves to 90x120, 45x60, 22x30: 22 -> 45 is no factor of two
    assert [tuple(f.shape) for f in levels] == [(22, 30, 2), (45, 60, 2), (90, 120, 2),
                                               (180, 240, 2)]
    for got, want in zip(levels, ref_levels):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    assert np.abs(ref).max() > 0.1 and np.ptp(ref[..., 0]) > 0.05


def _tracks_and_window(rng, n_tracks=25, n_events=4000):
    """Tracks moving at their own velocity over 60 ms, and a window of events
    in its middle."""
    trajectories = {}
    for tid in range(n_tracks):
        x0, y0 = rng.uniform(20, 220), rng.uniform(20, 160)
        vx, vy = rng.normal(0, 80, 2)  # px/s
        trajectories[tid] = [(t, x0 + vx * t * 1e-6, y0 + vy * t * 1e-6)
                             for t in range(0, 60_001, 5_000)]
    trajectories[99] = [(0, 5.0, 5.0)]  # a single entry gives no velocity
    t_us = np.sort(rng.integers(10_000, 50_000, n_events)).astype(np.int64)
    x = rng.uniform(0, 239, n_events)
    y = rng.uniform(0, 179, n_events)
    return trajectories, x, y, t_us


@pytest.mark.parametrize("interpolate", [True, False])
def test_compensate_from_tracks_matches_jax(interpolate):
    trajectories, x, y, t_us = _tracks_and_window(np.random.default_rng(7))
    jf, jimg = jmf.compensate_from_tracks(trajectories, x, y, t_us, interpolate=interpolate)
    f, img = tmf.compensate_from_tracks(trajectories, x, y, t_us, interpolate=interpolate,
                                        device="cpu")
    assert f.shape == (180, 240, 2) and f.dtype == np.float32
    np.testing.assert_allclose(f, jf, atol=1e-5)
    assert np.abs(jf).max() > 0.05
    # the warp is float64 on the host in both; a field 1e-5 apart can move an
    # event across a rounding boundary, so compare on the reference's field
    img_on_ref = tmf.compensate_events_field(
        jf, x, y, t_us, 0.5 * (float(t_us[0]) + float(t_us[-1])), device="cpu")
    np.testing.assert_array_equal(img_on_ref, jimg)
    assert np.abs(img - jimg).sum() <= 4  # at most two events one pixel apart
    assert 0 < img.sum() <= len(x)


def test_compensate_from_tracks_without_tracks_matches_jax():
    _, x, y, t_us = _tracks_and_window(np.random.default_rng(8), n_events=1500)
    jf, jimg = jmf.compensate_from_tracks({}, x, y, t_us)
    f, img = tmf.compensate_from_tracks({}, x, y, t_us, device="cpu")
    assert not f.any() and not np.asarray(jf).any()
    np.testing.assert_array_equal(img, jimg)
    assert img.sum() == len(x)  # a zero field moves nothing out of the image


def test_tracks_mode_runs_in_both_drives(scene, tmp_path):
    """`compensation_mode="tracks"` through the evaluator: the field comes
    from the tracker's trajectories, in the synchronous and the pipelined
    drive (where the trajectories lag by the windows in flight)."""
    for name, pipelined in (("sync", False), ("pipe", True)):
        ev = teval.Evaluator(scene, teval.EvaluatorParams(
            output_dir=str(tmp_path), compensation_mode="tracks", pipelined=pipelined,
            pipeline_depth=1, compensation_events=30_000,
            tracker=tdet.TrackerParams(capacity=32, max_patches=32)), device="cpu")
        ev.run(max_frames=5)
        ev.finish()
        assert ev.counters.counts["compensation_windows"] >= 1, name
        assert ev.motion_field.shape == (180, 240, 2), name
        assert np.isfinite(ev.motion_field).all() and np.abs(ev.motion_field).max() > 0, name
        assert 0 < ev.compensated_image.sum() <= 30_000, name
        assert not ev.compensation_costs
    with pytest.raises(ValueError, match="unknown compensation mode"):
        teval.Evaluator(scene, teval.EvaluatorParams(compensation_mode="flow"), device="cpu")


# -- (e) a worker that raises ends the run with its exception ---------------

class _FakeWindow:
    vel_dev = None

    def get(self):
        return np.zeros((9, 12, 2), np.float32), np.zeros((180, 240), np.float32), 1.0, 2.0


def _small_evaluator(scene, tmp_path, **kw):
    return teval.Evaluator(scene, teval.EvaluatorParams(
        output_dir=str(tmp_path), compensation_events=10_000,
        tracker=tdet.TrackerParams(capacity=32, max_patches=32),
        vo=VoParams(num_inliers=20), **kw), device="cpu")


def _run_and_finish(ev, max_frames=5):
    ev.run(max_frames=max_frames)
    ev.finish()


@pytest.mark.parametrize("failing_call", [0, -1], ids=["first_window", "newest_window"])
def test_compensation_worker_failure_ends_the_run(scene, tmp_path, monkeypatch, new_workers,
                                                  failing_call):
    calls = []

    def counting(*args, **kwargs):
        calls.append(threading.current_thread().name)
        return _FakeWindow()

    monkeypatch.setattr(tcomp, "compensate_window", counting)
    _run_and_finish(_small_evaluator(scene, tmp_path))
    n_windows = len(calls)
    assert n_windows >= 3 and all(name.startswith("evo-comp") for name in calls)
    fail_at = failing_call % n_windows
    calls.clear()

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) - 1 == fail_at:
            raise RuntimeError("compensation worker failed")
        return _FakeWindow()

    monkeypatch.setattr(tcomp, "compensate_window", failing)
    ev = _small_evaluator(scene, tmp_path)
    with pytest.raises(RuntimeError, match="compensation worker failed"):
        _run_and_finish(ev)
    assert len(calls) > fail_at
    assert not new_workers()


@pytest.mark.parametrize("failing_call", [0, -1], ids=["first_keyframe", "newest_keyframe"])
def test_vo_worker_failure_ends_the_run(scene, tmp_path, new_workers, failing_call):
    n_keyframes = 3  # frames 3..5 of a 5-frame run
    fail_at = failing_call % n_keyframes
    ev = _small_evaluator(scene, tmp_path, run_compensation=False)
    calls = []

    def failing(kf):
        calls.append(threading.current_thread().name)
        if len(calls) - 1 == fail_at:
            raise RuntimeError("vo worker failed")

    ev.vo.new_keyframe_candidate = failing
    with pytest.raises(RuntimeError, match="vo worker failed"):
        _run_and_finish(ev)
    assert calls and set(calls) == {"evo-vo"}
    assert not new_workers()


# -- (f) the counters under threads -----------------------------------------

def test_counters_count_exactly_under_three_threads():
    c = Counters()
    n = 4000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                c.add("events", 3)
                with c.timed("stage"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.counts["events"] == 3 * 3 * n
    assert c.calls["stage"] == 3 * n
    s = c.summary()
    assert s["events"] == 9 * n and s["calls_stage"] == 3 * n and s["time_stage_s"] >= 0
    assert c.rate("events") > 0
