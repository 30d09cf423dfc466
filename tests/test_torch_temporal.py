"""Temporal batching of compensation in the port (`dist.temporal`,
`EvaluatorParams.temporal_batch`, `--temporal-batch`) against the JAX
package, on the CPU.

Tolerances: per window, `cost0` rtol 1e-5, the solved field atol 5e-3 px/ms
and the count image atol 1e-3 against the JAX package's batched solve and
against the port's cold one-window solve (those of tests/test_dist.py); a
window solved inside a batch against the same window solved alone at the
same padding: rtol 1e-6 (the batch must not change its accept sequence);
trajectory.txt identical with and without batching on either drive, with
the JAX package's track ids (its tracker's parity is the subject of
tests/test_torch_tracker.py and tests/test_torch_pipeline.py), and the
newest window's field within 5e-3 px/ms of the JAX package's batched run.
The evaluator runs cover the first 3 frames of the square dataset in
windows of 6,000 events, at most 256 events a tile (3 windows)."""

import threading

import numpy as np
import pytest
import torch

from evo_tpu.dist import temporal as jtemporal
from evo_tpu.io import davis as jdavis
from evo_tpu.run import evaluator as jeval
from evo_tpu.tracker import compensate as jcomp
from evo_tpu_torch.dist import temporal
from evo_tpu_torch.io.davis import Davis240cDataset
from evo_tpu_torch.run import checkpoint
from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams
from evo_tpu_torch.tracker import compensate as tcomp
from tests.test_run import square_dataset  # noqa: F401 (fixture)
from tests.test_torch_dist import _moving_lines

torch.set_num_threads(1)

H, W = 60, 80
COMP = dict(tile=20, min_events=10, max_iters=6, events_per_tile_cap=512)
# the evaluator runs of tests/test_dist.py::TestTemporalBatch, cut to the
# first frames and fewer, larger windows
EVAL = dict(compensation_events=6000)
EVAL_COMP = dict(min_events=50, max_iters=4, events_per_tile_cap=256)
FRAMES = 3


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(0)
    return [_moving_lines(rng, 3000, i * 40_000, 30_000, H, W, 0.06, -0.04) for i in range(3)]


def test_batched_windows_match_jax_and_the_one_window_solve(windows):
    p = jcomp.CompensateParams(**COMP)
    ref = jtemporal.compensate_windows_batched(windows, p, height=H, width=W)
    got = temporal.compensate_windows_batched(windows, tcomp.CompensateParams(**COMP),
                                              height=H, width=W, device="cpu")
    assert len(got) == len(windows)
    for (x, y, t), g, r in zip(windows, got, ref):
        alone = tcomp.compensate_window(x, y, t, tcomp.CompensateParams(**COMP), H, W,
                                        device="cpu")
        for v_ref, img_ref, _, c0_ref in (r, alone):
            np.testing.assert_allclose(g[3], c0_ref, rtol=1e-5)
            np.testing.assert_allclose(g[0], np.asarray(v_ref), atol=5e-3)
            np.testing.assert_allclose(g[1], np.asarray(img_ref), atol=1e-3)
        assert g[0].shape == (3, 4, 2) and g[2] <= g[3]


def test_each_window_of_a_batch_keeps_its_own_accepts(windows):
    """Windows that stop at different iterations: every window of the batch
    ends where it ends alone (same padding), so a window that stopped is
    frozen while the others go on."""
    p = tcomp.CompensateParams(**{**COMP, "max_iters": 40})
    built = [tcomp.build_tile_data(x, y, t, p, H, W, "cpu") for x, y, t in windows]
    e_max = max(b[0].ex.shape[1] for b in built)
    data = [temporal._pad_tile_data(b[0], e_max) for b in built]
    kw = dict(tile=p.tile, scale=p.scale, tv_weight=p.tv_weight, tv_huber=p.tv_huber,
              max_iters=p.max_iters)
    edges = built[0][1]
    v, cost, cost0 = tcomp.solve_motion_field_batched(temporal._stack(data), edges, **kw)
    for i, d in enumerate(data):
        v1, c1, c01 = tcomp.solve_motion_field_batched(temporal._stack([d]), edges, **kw)
        np.testing.assert_allclose(v[i].numpy(), v1[0].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(cost[i]), float(c1[0]), rtol=1e-6)
        assert float(cost0[i]) == pytest.approx(float(c01[0]), rel=1e-6)
    # a warm start per window: a non-finite one is ignored, the others used
    vi = v.clone()
    vi[1, 0, 0] = float("nan")
    _, _, c0w = tcomp.solve_motion_field_batched(temporal._stack(data), edges,
                                                 **{**kw, "max_iters": 0}, v_init=vi)
    assert float(c0w[1]) == pytest.approx(float(cost0[1]), rel=1e-6)
    assert float(c0w[0]) == pytest.approx(float(cost[0]), rel=1e-6)


def _port_run(dataset, out, pipelined, batch, max_frames=FRAMES):
    ev = Evaluator(Davis240cDataset(dataset), EvaluatorParams(
        output_dir=str(out), pipelined=pipelined, temporal_batch=batch, **EVAL,
        compensate=tcomp.CompensateParams(**EVAL_COMP)), device="cpu")
    ev.run(max_frames=max_frames)
    return ev, ev.finish()


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_batched(square_dataset, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("jax_tb")
    ev = jeval.Evaluator(jdavis.Davis240cDataset(square_dataset), jeval.EvaluatorParams(
        output_dir=str(out), temporal_batch=2, **EVAL,
        compensate=jcomp.CompensateParams(**EVAL_COMP)))
    ev.run(max_frames=FRAMES)
    return ev, ev.finish()


@pytest.mark.parametrize("pipelined", [False, True], ids=["synchronous", "pipelined"])
def test_evaluator_temporal_batch_writes_the_same_trajectory(square_dataset, tmp_path,  # noqa: F811
                                                            jax_batched, pipelined):
    ev0, p0 = _port_run(square_dataset, tmp_path / "per_window", pipelined, 0)
    ev2, p2 = _port_run(square_dataset, tmp_path / "batched", pipelined, 2)
    assert _read(p2["trajectory"]) == _read(p0["trajectory"])
    c = ev2.counters
    assert c.counts["compensation_windows"] == ev0.counters.counts["compensation_windows"] >= 3
    assert len(ev2.compensation_costs) == c.counts["compensation_windows"]
    assert "compensation_batched" in c.times and ev2.compensated_image is not None
    assert not ev2._comp_windows and not ev2._pending_comp
    jev, jp = jax_batched
    ours, ref = jdavis.parse_trajectory(p2["trajectory"]), jdavis.parse_trajectory(jp["trajectory"])
    assert set(ours) == set(ref) and len(ref) >= 2
    # the newest window's field, solved cold by both packages
    np.testing.assert_allclose(ev2.motion_field, np.asarray(jev.motion_field), atol=5e-3)


@pytest.mark.parametrize("pipelined", [False, True], ids=["synchronous", "pipelined"])
def test_a_failing_batch_ends_the_run(square_dataset, tmp_path, monkeypatch,  # noqa: F811
                                      pipelined):
    inner = temporal.compensate_windows_batched
    calls = []

    def failing(*args, **kwargs):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            raise RuntimeError("batch failed")
        return inner(*args, **kwargs)

    monkeypatch.setattr(temporal, "compensate_windows_batched", failing)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="batch failed"):
        _port_run(square_dataset, tmp_path, pipelined, 2)
    assert calls and all(name.startswith("evo-comp") for name in calls)
    assert not [t for t in threading.enumerate()
                if t.ident not in before and t.name.startswith("evo-")]


def test_checkpoint_with_buffered_windows_resumes_to_the_same_run(square_dataset,  # noqa: F811
                                                                  tmp_path):
    """A checkpoint flushes the buffered windows into a batch first and
    holds none; the resumed run writes the uninterrupted run's
    trajectory.txt and ends with its motion field (the cold solves do not
    depend on how the windows were grouped)."""
    full, pf = _port_run(square_dataset, tmp_path / "full", False, 3, max_frames=4)
    first = Evaluator(Davis240cDataset(square_dataset), EvaluatorParams(
        output_dir=str(tmp_path / "first"), pipelined=False, temporal_batch=3, **EVAL,
        compensate=tcomp.CompensateParams(**EVAL_COMP)), device="cpu")
    first.run(max_frames=2)
    state = checkpoint.state_dict(first)
    assert not first._comp_windows and not first._pending_comp
    assert first.compensation_costs
    path = checkpoint.save_checkpoint(str(tmp_path / "ck"), first)
    first.stop_workers()
    back = checkpoint.load_checkpoint(path, Davis240cDataset(square_dataset), EvaluatorParams(
        output_dir=str(tmp_path / "back"), pipelined=False, temporal_batch=3, **EVAL,
        compensate=tcomp.CompensateParams(**EVAL_COMP)), device="cpu")
    assert "comp.warm_vel" not in state
    back.run(max_frames=4, start_frame=back.image_num)
    pb = back.finish()
    assert _read(pb["trajectory"]) == _read(pf["trajectory"])
    np.testing.assert_allclose(back.motion_field, full.motion_field, atol=5e-3)


def test_cli_runs_with_temporal_batch(square_dataset, tmp_path, monkeypatch):  # noqa: F811
    """--temporal-batch N reaches the evaluator: the windows go to
    `compensate_windows_batched` (here a stand-in that records them) in
    batches of at most N."""
    from evo_tpu_torch.run import cli

    batches = []

    def recording(windows, params, height, width, mesh=None, device=None):
        batches.append(len(windows))
        return [(np.zeros((9, 12, 2), np.float32), np.zeros((height, width), np.float32),
                 0.0, 0.0)] * len(windows)

    monkeypatch.setattr(temporal, "compensate_windows_batched", recording)
    assert cli.main(["--dataset", square_dataset, "--output-dir", str(tmp_path),
                     "--device", "cpu", "--tracker-experiment", "--max-frames", "6",
                     "--temporal-batch", "2"]) == 0
    assert (tmp_path / "trajectory.txt").exists()
    assert batches and max(batches) <= 2 and sum(batches) >= 3
