"""The port's debug views, quality and precision reports, profiler and NaN
canary on the CPU, each held against `evo_tpu` on the same inputs:

- `predicted_nabla` and `cost_map` on one table and gradient store, 1e-4;
- PNGs from the port's own writer decode (with Pillow, here) to the pixels
  `evo_tpu/run/viz.py` writes through Pillow for the same array;
- `evaluate_tracker`, `_raycast_plane_batch` and `death_breakdown` on
  identical trajectories and ground truth (float32 scoring in both: 1e-5
  relative on the errors);
- one quality row end to end on a short dataset both packages read: the
  same tracks, errors within 1e-3 relative (the trackers agree to float32
  noise);
- the `shapes` scene's events lie on its polygons' edges;
- the precision report: assembly errors below 1e-5, the keys of `evo_tpu`'s;
- `profile_trace` writes a trace; the NaN canary raises on a NaN, on the
  main thread and on a worker, and stays silent on a short run of the
  default drive with compensation, as `jax_debug_nans` does in `evo_tpu`.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evo_tpu.run import quality as jquality
from evo_tpu.run import viz as jviz
from evo_tpu.tracker import align as jalign
from evo_tpu.tracker import patch_state as jps
from evo_tpu_torch.core.types import CalibParams
from evo_tpu_torch.io import sim
from evo_tpu_torch.io.davis import Davis240cDataset
from evo_tpu_torch.run import metrics, precision_report, quality, viz
from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
from evo_tpu_torch.tracker import align
from evo_tpu_torch.tracker import patch_state as tps
from evo_tpu_torch.tracker.compensate import CompensateParams
from evo_tpu_torch.tracker.detector import EventTracker
from tests.test_run import square_dataset  # noqa: F401 (fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tracked(square_dataset):  # noqa: F811
    """A port tracker after three frames of the square scene: its table and
    gradient store."""
    from evo_tpu_torch.io.replay import FrameWindowIterator

    ds = Davis240cDataset(square_dataset)
    tr = EventTracker(device="cpu")
    for k, win in enumerate(FrameWindowIterator(ds)):
        if k == 3:
            break
        ev = win.events
        tr.process_events(ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
                          ev.p.astype(np.float64))
        tr.new_image(win.image_t_us, win.image)
    assert int(tr.table.alive.sum()) >= 4
    return tr


def _jax_table(tr):
    return jps.PatchTable(**{k: jnp.asarray(v) for k, v in tps.table_to_numpy(tr.table).items()})


def test_predicted_nabla_and_cost_map_match_jax(tracked):
    jt, jgrads = _jax_table(tracked), jnp.asarray(tracked.grads.numpy())
    nabla = align.predicted_nabla(tracked.table, tracked.grads)
    ref = np.asarray(jalign.predicted_nabla(jt, jgrads))
    assert nabla.shape == ref.shape == (tracked.table.capacity, 25, 25)
    np.testing.assert_allclose(nabla.numpy(), ref, atol=1e-4)
    for row in torch.nonzero(tracked.table.alive).flatten()[:3].tolist():
        cm = align.cost_map(tracked.table, tracked.grads, row)
        jcm = np.asarray(jalign.cost_map(jt, jgrads, row))
        assert cm.shape == jcm.shape == (11, 11) and np.ptp(jcm) > 0
        np.testing.assert_allclose(cm.numpy(), jcm, atol=1e-4)


@pytest.mark.parametrize("kind", ["gray", "rgb"])
def test_png_writer_matches_pillow(tmp_path, kind):
    rng = np.random.default_rng(0)
    if kind == "gray":
        img = rng.normal(size=(37, 53)).astype(np.float32)
        ours = viz.save_gray(str(tmp_path / "ours.png"), img)
        theirs = jviz.save_gray(str(tmp_path / "theirs.png"), img)
    else:
        img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
        ours = viz.save_rgb(str(tmp_path / "ours.png"), img)
        theirs = jviz.save_rgb(str(tmp_path / "theirs.png"), img)
    with Image.open(ours) as a, Image.open(theirs) as b:
        assert a.mode == b.mode == ("L" if kind == "gray" else "RGB")
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_views_of_a_tracker(tracked, tmp_path):
    paths = viz.save_patch_views(str(tmp_path), tracked, 0)
    sizes = {k: Image.open(p).size for k, p in paths.items()}
    assert sizes == {"integrated_nabla": (25, 25), "predicted_nabla": (25, 25),
                     "cost_map": (11, 11)}
    frame = np.full((180, 240), 0.2, np.float32)
    rgb = viz.render_feature_overlay(frame, tracked)
    assert rgb.shape == (180, 240, 3) and (rgb[..., 1] == 255).any()
    ev = viz.render_event_image(np.array([5.0, 10.0]), np.array([3.0, 4.0]),
                                np.array([1, -1]), height=16, width=16)
    assert tuple(ev[3, 5]) == (0, 255, 0) and tuple(ev[4, 10]) == (255, 0, 0)


def _scoring_inputs(rng):
    """Ground truth of the simulator's trajectory at 20 fps over 1 s, and 30
    tracks of pixels wandering from a start, some starting or ending outside
    the ground truth's time range."""
    gt_t = np.arange(0, 1_000_001, 50_000, dtype=np.int64)
    gt = np.stack([sim.EventCameraSimulator.default_trajectory(t / 1e6) for t in gt_t])
    trajs = {}
    for tid in range(30):
        t0 = int(rng.integers(-100_000, 600_000))
        n = int(rng.integers(2, 12))
        xy = rng.uniform([20, 20], [220, 160]) + np.cumsum(rng.normal(0, 1.5, (n, 2)), 0)
        trajs[tid] = [(t0 + 37_000 * k, float(x), float(y)) for k, (x, y) in enumerate(xy)]
    return gt_t, gt, trajs


@pytest.mark.parametrize("scene", ["plane", "3walls"])
def test_evaluate_tracker_matches_jax(scene):
    gt_t, gt, trajs = _scoring_inputs(np.random.default_rng(1))
    from evo_tpu.core.types import CalibParams as JCalibParams

    calib = CalibParams(fx=199.0, fy=198.0, cx=119.5, cy=89.5)
    jcalib = JCalibParams(fx=199.0, fy=198.0, cx=119.5, cy=89.5)
    ours = quality.evaluate_tracker(trajs, gt_t, gt, calib, 2.0, scene=scene, device="cpu")
    ref = jquality.evaluate_tracker(trajs, gt_t, gt, jcalib, 2.0, scene=scene)
    assert ours.num_tracks == ref.num_tracks >= 15
    assert ours.per_track_error.keys() == ref.per_track_error.keys()
    for tid, e in ref.per_track_error.items():
        assert ours.per_track_error[tid] == pytest.approx(e, rel=1e-5, abs=1e-5)
    assert ours.mean_feature_age_s == ref.mean_feature_age_s
    assert ours.mean_distance_error_px == pytest.approx(ref.mean_distance_error_px, rel=1e-5)
    rng = np.random.default_rng(2)
    poses = gt[rng.integers(0, len(gt), 40)]
    pix = rng.uniform([0, 0], [240, 180], (40, 2))
    hits = quality._raycast_plane_batch(poses, calib.to_list(), pix, 2.0, scene, device="cpu")
    jhits = jquality._raycast_plane_batch(poses, jnp.asarray(jcalib.to_array()), pix, 2.0,
                                          scene)
    np.testing.assert_allclose(hits, jhits, rtol=1e-5, atol=1e-6)
    assert quality.death_breakdown(trajs) == jquality.death_breakdown(trajs)


def test_quality_row_matches_jax(tmp_path):
    """The 3walls row's protocol (standard mode, no compensation) on a 0.4 s
    scene written by the port's simulator and read by both packages."""
    from evo_tpu.io import davis as jdavis
    from evo_tpu.run.evaluator import Evaluator as JEvaluator
    from evo_tpu.run.evaluator import EvaluatorParams as JParams

    out = sim.EventCameraSimulator(sim.SimParams(duration_s=0.4, fps=20.0, seed=1,
                                                 scene="3walls"), device="cpu").generate()
    ds_dir = sim.write_dataset(str(tmp_path / "ds"), out)
    cfg = quality.suite_configs(0.4)["3walls"]
    row = quality.score_row("3walls", cfg, Davis240cDataset(ds_dir), str(tmp_path / "out"),
                            device="cpu")
    jds = jdavis.Davis240cDataset(ds_dir)
    jev = JEvaluator(jds, JParams(output_dir=str(tmp_path / "jax"), run_compensation=False))
    jev.run()
    jev.flush_pending()
    q = jquality.evaluate_tracker(jev.tracker.trajectories, jds.gt_t_us, jds.gt_poses,
                                  jds.calib, plane_depth=2.0, scene="3walls")
    assert row["num_tracks"] == q.num_tracks >= 40
    assert row["tracker_err_px"] == pytest.approx(q.mean_distance_error_px, rel=1e-3, abs=2e-3)
    assert row["feature_age_s"] == pytest.approx(q.mean_feature_age_s, abs=1e-3)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "QUALITY.json")) as f:
        assert row["reference"] == json.load(f)["3walls"]["reference"]
    assert row["frames"] == 8 and row["device"] == "cpu"


@pytest.mark.slow
def test_shapes_row_on_one_dataset_matches_jax(tmp_path):
    """The `shapes` row's protocol (the tracker experiment on the 48-polygon
    scene, no compensation, scored against the plane at 2 m) on the row's
    full 6 s of stream, written once by the port's simulator and read by both
    packages: the tolerances of `test_quality_row_matches_jax`. It settles
    whether the port's row differs from `evo_tpu`'s only by its scene.

    It fails, a recorded fault: ROADMAP.md §C item 2 gives the two rows
    (`evo_tpu` 0.565 px and 3.328 s, the port 0.554 px and 3.324 s) and the
    cause found, float32 rounding that the tracker amplifies."""
    from evo_tpu.io import davis as jdavis
    from evo_tpu.run.evaluator import Evaluator as JEvaluator
    from evo_tpu.run.evaluator import EvaluatorParams as JParams

    cfg = quality.suite_configs()["shapes"]
    assert cfg["duration_s"] == 6.0 and cfg["tracker_experiment"]
    out = sim.EventCameraSimulator(sim.SimParams(
        duration_s=cfg["duration_s"], fps=20.0, seed=1, scene="shapes",
        texture_cells=cfg["texture_cells"]), device="cpu").generate()
    ds_dir = sim.write_dataset(str(tmp_path / "ds"), out)
    row = quality.score_row("shapes", cfg, Davis240cDataset(ds_dir), str(tmp_path / "out"),
                            device="cpu")
    jds = jdavis.Davis240cDataset(ds_dir)
    jev = JEvaluator(jds, JParams(output_dir=str(tmp_path / "jax"), run_compensation=False,
                                  tracker_experiment=True))
    jev.run()
    jev.flush_pending()
    q = jquality.evaluate_tracker(jev.tracker.trajectories, jds.gt_t_us, jds.gt_poses,
                                  jds.calib, plane_depth=2.0, scene="plane")
    print(f"shapes row, port: {row['feature_age_s']} s, {row['tracker_err_px']} px, "
          f"{row['num_tracks']} tracks; evo_tpu: {q.mean_feature_age_s:.3f} s, "
          f"{q.mean_distance_error_px:.3f} px, {q.num_tracks} tracks")
    known = "a recorded fault, ROADMAP.md §C item 2"
    assert row["num_tracks"] == q.num_tracks >= 20
    assert row["tracker_err_px"] == pytest.approx(q.mean_distance_error_px, rel=1e-3,
                                                  abs=2e-3), known
    assert row["feature_age_s"] == pytest.approx(q.mean_feature_age_s, abs=1e-3), known
    assert row["frames"] == 120 and row["device"] == "cpu"


@pytest.mark.slow
def test_plane_age_row_on_one_dataset_matches_jax(tmp_path):
    """The `plane_age` row's protocol (the tracker experiment on the textured
    plane, no compensation, scored against the plane at 2 m) on the row's
    full 12 s of stream, written once by the port's simulator and read by
    both packages, under the bars of `test_shapes_row_on_one_dataset_matches_jax`.
    It settles whether the port's row (2.122 px against `evo_tpu`'s 1.484 px
    on their own scenes) differs from `evo_tpu`'s only by its scene.

    It fails, a recorded fault: ROADMAP.md §C item 6 gives the two rows on
    the one dataset (`evo_tpu` 2.0913 px and 8.4819 s, the port 1.855 px and
    8.484 s, 100 tracks each): most of the old gap was the scene, and the
    rows still part by 0.236 px."""
    from evo_tpu.io import davis as jdavis
    from evo_tpu.run.evaluator import Evaluator as JEvaluator
    from evo_tpu.run.evaluator import EvaluatorParams as JParams

    cfg = quality.suite_configs()["plane_age"]
    assert cfg["duration_s"] == 12.0 and cfg["tracker_experiment"]
    out = sim.EventCameraSimulator(sim.SimParams(
        duration_s=cfg["duration_s"], fps=20.0, seed=1, scene="plane"),
        device="cpu").generate()
    ds_dir = sim.write_dataset(str(tmp_path / "ds"), out)
    row = quality.score_row("plane_age", cfg, Davis240cDataset(ds_dir),
                            str(tmp_path / "out"), device="cpu")
    jds = jdavis.Davis240cDataset(ds_dir)
    jev = JEvaluator(jds, JParams(output_dir=str(tmp_path / "jax"), run_compensation=False,
                                  tracker_experiment=True))
    jev.run()
    jev.flush_pending()
    q = jquality.evaluate_tracker(jev.tracker.trajectories, jds.gt_t_us, jds.gt_poses,
                                  jds.calib, plane_depth=2.0, scene="plane")
    print(f"plane_age row, port: {row['feature_age_s']} s, {row['tracker_err_px']} px, "
          f"{row['num_tracks']} tracks; evo_tpu: {q.mean_feature_age_s:.4f} s, "
          f"{q.mean_distance_error_px:.7f} px, {q.num_tracks} tracks")
    assert row["num_tracks"] == q.num_tracks >= 20
    assert row["tracker_err_px"] == pytest.approx(q.mean_distance_error_px, rel=1e-3,
                                                  abs=2e-3)
    assert row["feature_age_s"] == pytest.approx(q.mean_feature_age_s, abs=1e-3)
    assert row["frames"] == 240 and row["device"] == "cpu"


def test_quality_cli_needs_an_output_path(tmp_path, monkeypatch):
    """`python -m evo_tpu_torch.run.quality` has no default output, and
    writes each row's artifacts beside the JSON, under OUT_rows/<row>/."""
    with pytest.raises(SystemExit):
        quality.main([])
    dirs = []
    monkeypatch.setattr(quality, "simulate", lambda cfg, fps, device: None)
    monkeypatch.setattr(quality, "score_row", lambda key, cfg, ds, out_dir, device: (
        dirs.append(out_dir) or {"row": key}))
    out = tmp_path / "q.json"
    assert quality.main([str(out), "--rows", "plane", "3walls", "--device", "cpu"]) == 0
    assert dirs == [str(tmp_path / "q_rows" / "plane"), str(tmp_path / "q_rows" / "3walls")]
    assert json.loads(out.read_text()) == {"plane": {"row": "plane"}, "3walls": {"row": "3walls"}}


def test_shapes_events_lie_on_polygon_edges():
    s = sim.EventCameraSimulator(sim.SimParams(duration_s=0.15, fps=20.0, seed=4,
                                               scene="shapes", texture_cells=12), device="cpu")
    out = s.generate()
    ev = out["events"]
    assert len(ev["t_us"]) > 2000
    # the wall point under each event's pixel at its time, from its frame's pose
    k = np.minimum(ev["t_us"] // 50_000, len(out["gt"]) - 1)
    poses = torch.tensor(np.stack([out["gt"][i][1] for i in k]), dtype=torch.float32)
    from evo_tpu_torch.core import camera, lie

    pix = torch.tensor(np.stack([ev["x"], ev["y"]], -1), dtype=torch.float32)
    d = lie.quat_rotate(poses[:, 0:4], camera.unproject(s.intr, pix))
    t = (2.0 - poses[:, 6]) / d[:, 2]
    hit = poses[:, 4:7] + t[:, None] * d
    dist = sim.shape_sdf(hit[:, 0], hit[:, 1], s.shapes).abs().amin(-1)
    # a pixel spans ~0.01 on the wall; the camera moves within one frame
    assert float((dist < 0.04).float().mean()) > 0.95


def test_precision_report_matches_jax():
    from evo_tpu.run import precision_report as jreport

    rep = precision_report.build_report(reps=1, device="cpu")
    ref = jreport.build_report()

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(rep) == keys(ref)
    for e in rep["assembly_vs_f64_oracle"].values():
        assert e["plain_f32_max_rel_err"] < 1e-5 and e["compensated_max_rel_err"] < 1e-5
    assert rep["solve"]["initial_cost"] == pytest.approx(ref["solve"]["initial_cost"], rel=1e-5)
    assert rep["solve"]["final_cost_rel_diff"] < 1e-4 and rep["backend"] == "cpu"
    assert rep["decision"].startswith("ba_compensated stays DEFAULT-OFF")


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(str(tmp_path / "prof")):
        a = torch.randn(64, 64)
        (a @ a).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names


def test_nan_canary(square_dataset, tmp_path):  # noqa: F811
    metrics.enable_nan_canary()
    try:
        with pytest.raises(FloatingPointError):
            torch.zeros(3) / torch.zeros(3)
        # a short run of the default drive, compensation and VO on their
        # worker threads with the canary entered: silent
        ds = Davis240cDataset(square_dataset)
        ev = Evaluator(ds, EvaluatorParams(
            output_dir=str(tmp_path), compensation_events=10_000,
            compensate=CompensateParams(max_iters=2, events_per_tile_cap=256)), device="cpu")
        ev.run()
        ev.finish()
        assert ev.counters.counts["compensation_windows"] >= 3 and ev.counters.calls["vo"] >= 3
        # a NaN made on the VO worker raises there, and the run ends with it
        ev = Evaluator(ds, EvaluatorParams(output_dir=str(tmp_path), run_compensation=False),
                       device="cpu")
        seen = []

        def poisoned(kf):
            seen.append(threading.current_thread().name)
            torch.full((2,), float("inf")) - torch.full((2,), float("inf"))

        ev.vo.new_keyframe_candidate = poisoned
        with pytest.raises(FloatingPointError):
            ev.run()
        assert set(seen) == {"evo-vo"}
    finally:
        metrics.enable_nan_canary(False)
    torch.zeros(3) / torch.zeros(3)  # off again
