"""Tests of the port that need a CUDA card: its kernels against their plain
PyTorch versions, and the card's run of the slice against the CPU's.
Without a card they skip. This file imports no JAX (the machine with the
card has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: nearest splat counts exact; Gaussian and bilinear values and
gradients rtol/atol 1e-5 (atomics sum in another order); the fused entry's
d/d vel rtol 1e-5 with atol 1e-5 of its largest entry (a sum over the tile's
events that cancels); compensation field within 1e-4 px/ms between the card
and the CPU, one window or three solved together; VO keyframe poses within
1e-3 between the card and the CPU on the same RANSAC draws, keyframe by
keyframe from one state (the card's scatter-adds and SVDs sum in another
order), and within 1e-3 of the trajectory's extent over a free run."""

import numpy as np
import pytest
import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.core.types import CalibParams
from evo_tpu_torch.kernels import splat
from evo_tpu_torch.tracker import compensate
from evo_tpu_torch.vo import frontend
from evo_tpu_torch.vo.keyframe import Keyframe

H, W = 30, 40


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _events(mode, b, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, n, generator=g) * (W + 8) - 4
    y = torch.rand(b, n, generator=g) * (H + 8) - 4
    w = torch.rand(b, n, generator=g) * 2 - 1
    if mode == "nearest":
        x, y, w = torch.round(x), torch.round(y), torch.ones(b, n)
        x[:, :50] += 0.5  # half-pixel ties land on both neighbours
    return x, y, w


@pytest.mark.gpu
@pytest.mark.parametrize("n", [4000, 1023])  # 16-byte loads, and not
@pytest.mark.parametrize("crop", [None, (24, 30)])
@pytest.mark.parametrize("mode", ["nearest", "bilinear", "gaussian"])
def test_splat_kernel_matches_plain_version(cuda_device, mode, crop, n):
    """crop None: a 30x40 image, one block per image in shared memory. With a
    crop the same events go into a 90x120 image around them, which is above
    `TILE_PIXELS` and takes the one-thread-per-event kernels."""
    x, y, w = (t.to(cuda_device) for t in _events(mode, 4, n, seed=3))
    h, wd = H, W
    if crop is not None:
        h, wd = 90, 120
        x, y = x + crop[1], y + crop[0]
        assert h * wd > splat.TILE_PIXELS
    n_fwd, n_bwd = splat.launches_fwd, splat.launches_bwd
    out = splat.splat_image(x, y, w, h, wd, mode=mode)
    g = torch.randn(4, h, wd, device=cuda_device)
    grads = splat._backward(x, y, w, g, h, wd, mode, 1.0, 3)
    torch.cuda.synchronize()
    assert (splat.launches_fwd, splat.launches_bwd) == (n_fwd + 1, n_bwd + 1)
    ref = splat.splat_image_ref(x, y, w, h, wd, mode=mode)
    tol = 0.0 if mode == "nearest" else 1e-5
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    for a, b in zip(grads, splat.splat_bwd_ref(x, y, w, g, h, wd, mode=mode)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _tiles(e, seed, tile=20):
    """108 compensation tiles of DAVIS240C, E slots each, ~70 % filled."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(108)
    tlx, tly = (t % 12 * tile).float(), (t // 12 * tile).float()
    ex = tlx[:, None] + torch.randint(0, tile, (108, e), generator=g).float()
    ey = tly[:, None] + torch.randint(0, tile, (108, e), generator=g).float()
    dt_us = torch.rand(108, e, generator=g) * 30_000 - 15_000
    valid = torch.rand(108, e, generator=g) < 0.7
    vel = torch.randn(108, 2, generator=g) * 0.05
    return vel, ex, ey, dt_us, valid, tlx, tly


WARP = dict(scale=1e-3, tile=20, weight=float(compensate.GAUSS_NORM))


@pytest.mark.gpu
@pytest.mark.parametrize("e", [256, 1024, 2500])
def test_warp_splat_matches_plain_version(cuda_device, e):
    """The fused forward and backward at the main path's shapes (and one
    that needs three chunks and scalar loads) against the plain version, and
    exactly equal positions: in nearest mode one ulp would move a count."""
    vel, *events = (a.to(cuda_device) for a in _tiles(e, seed=5))
    n_fwd, n_bwd = splat.launches_warp_fwd, splat.launches_warp_bwd
    v = vel.clone().requires_grad_(True)
    img = splat.warp_splat(v, *events, **WARP)
    g = torch.randn_like(img)
    (img * g).sum().backward()
    torch.cuda.synchronize()
    assert (splat.launches_warp_fwd, splat.launches_warp_bwd) == (n_fwd + 1, n_bwd + 1)
    vr = vel.clone().requires_grad_(True)
    ref = splat.warp_splat_ref(vr, *events, **WARP)
    (ref * g).sum().backward()
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v.grad, vr.grad, rtol=1e-5,
                               atol=1e-5 * vr.grad.abs().max().item())
    near = splat.warp_splat(vel, *events, **{**WARP, "weight": 1.0}, mode="nearest")
    near_ref = splat.warp_splat_ref(vel, *events, **{**WARP, "weight": 1.0}, mode="nearest")
    assert torch.equal(near, near_ref)
    assert near.sum() >= events[3].sum()  # every valid event landed


@pytest.mark.gpu
def test_warp_splat_edges_on_card(cuda_device):
    """An event exactly at |d| == radius keeps its outer taps (each worth
    exp(-4.5) / 2 pi = 1.8e-3, far above the tolerance), and one exactly at
    k + 0.5 lands on both neighbours."""
    vel, ex, ey, dt_us, valid, tlx, tly = _tiles(256, seed=6)
    vel[:] = 0.0  # integer positions: the outer taps sit at |d| == 3 exactly
    args = [a.to(cuda_device) for a in (vel, ex, ey, dt_us, valid, tlx, tly)]
    img = splat.warp_splat(*args, **WARP)
    ref = splat.warp_splat_ref(*args, **WARP)
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-5)
    one = [a[:1].clone() for a in args]
    one[4][:] = False
    one[4][0, 0] = True  # a single event at (7, 9) of tile 0
    one[1][0, 0], one[2][0, 0] = 7.0, 9.0
    img = splat.warp_splat(*one, **WARP)[0]
    assert img[20 + 9, 20 + 7 + 3].item() == pytest.approx(
        WARP["weight"] * np.exp(-4.5), rel=1e-5)
    assert img[20 + 9, 20 + 7 + 4].item() == 0.0
    assert torch.count_nonzero(img).item() == 49
    one[1][0, 0], one[2][0, 0] = 7.5, 9.0  # a tie in x
    near = splat.warp_splat(*one, **{**WARP, "weight": 1.0}, mode="nearest")[0]
    assert near[29, 27].item() == 1.0 and near[29, 28].item() == 1.0
    assert near.sum().item() == 2.0
    # a velocity that moves the event onto the tie: 500 us * 1e-3 * 1 px/ms
    one[1][0, 0], one[3][0, 0], one[0][0, 0] = 7.0, 500.0, 1.0
    near = splat.warp_splat(*one, **{**WARP, "weight": 1.0}, mode="nearest")[0]
    assert torch.equal(near, splat.warp_splat_ref(
        *one, **{**WARP, "weight": 1.0}, mode="nearest")[0])


@pytest.mark.gpu
def test_splat_autograd_on_card(cuda_device):
    x, y, w = (t.to(cuda_device) for t in _events("gaussian", 2, 500, seed=4))
    x.requires_grad_(True)
    y.requires_grad_(True)
    n_bwd = splat.launches_bwd
    (splat.splat_image(x, y, w, H, W, mode="gaussian") ** 2).sum().backward()
    assert splat.launches_bwd == n_bwd + 1
    xr = x.detach().clone().requires_grad_(True)
    yr = y.detach().clone().requires_grad_(True)
    (splat.splat_image_ref(xr, yr, w, H, W, mode="gaussian") ** 2).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y.grad, yr.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_compensation_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(7)
    n, h, w = 4000, 60, 80
    t_us = np.sort(rng.uniform(0, 100_000, n)).astype(np.int64)
    x = np.clip(rng.choice(np.arange(5, w - 5, 10), n) + 50 * t_us * 1e-6
                + rng.normal(0, 0.3, n), 0, w - 1)
    y = rng.uniform(0, h - 1, n)
    p = compensate.CompensateParams(max_iters=25, events_per_tile_cap=512)
    n_fwd, n_warp = splat.launches_fwd, splat.launches_warp_bwd
    # no device given: the entry point itself picks the card
    f_gpu, img_gpu, c_gpu, _ = compensate.compensate_window(x, y, t_us, p, h, w)
    assert splat.launches_fwd > n_fwd and splat.launches_warp_bwd > n_warp
    f_cpu, img_cpu, c_cpu, _ = compensate.compensate_window(x, y, t_us, p, h, w,
                                                            device="cpu")
    np.testing.assert_allclose(f_gpu, f_cpu, atol=1e-4)
    assert c_gpu == pytest.approx(c_cpu, rel=1e-5)
    assert img_gpu.sum() == img_cpu.sum() and np.mean(img_gpu == img_cpu) >= 0.995


@pytest.mark.gpu
def test_batched_compensation_on_card_matches_cpu(cuda_device):
    """Three windows solved together (`dist.temporal`) on the card, no device
    given, against the same call on the CPU: each window as the one-window
    solve is held (field 1e-4 px/ms, cost 1e-5 relative, count image of the
    same mass); the W·T tiles go through the fused kernels."""
    from evo_tpu_torch.dist import temporal

    rng = np.random.default_rng(7)
    n, h, w = 4000, 60, 80
    windows = []
    for k in range(3):
        t_us = np.sort(rng.uniform(0, 100_000, n)).astype(np.int64) + 100_000 * k
        x = np.clip(rng.choice(np.arange(5, w - 5, 10), n) + (40 + 10 * k) * (t_us % 100_000) * 1e-6
                    + rng.normal(0, 0.3, n), 0, w - 1)
        windows.append((x, rng.uniform(0, h - 1, n), t_us))
    p = compensate.CompensateParams(max_iters=25, events_per_tile_cap=512)
    n_fwd, n_bwd = splat.launches_warp_fwd, splat.launches_warp_bwd
    gpu = temporal.compensate_windows_batched(windows, p, h, w)
    assert splat.launches_warp_fwd > n_fwd and splat.launches_warp_bwd > n_bwd
    cpu = temporal.compensate_windows_batched(windows, p, h, w, device="cpu")
    for (f_gpu, img_gpu, c_gpu, _), (f_cpu, img_cpu, c_cpu, _) in zip(gpu, cpu):
        np.testing.assert_allclose(f_gpu, f_cpu, atol=1e-4)
        assert c_gpu == pytest.approx(c_cpu, rel=1e-5)
        assert img_gpu.sum() == img_cpu.sum() and np.mean(img_gpu == img_cpu) >= 0.995


def _vo_keyframes(n=12, n_pts=120, noise_px=0.3):
    """Keyframes of a camera translating 0.25 per frame past a cloud of
    known points, with pixel noise, and the ground-truth poses."""
    rng = np.random.default_rng(0)
    calib = CalibParams(fx=199.0, fy=198.0, cx=132.0, cy=110.0)
    intr = torch.tensor(calib.to_list(), dtype=torch.float64)
    world = torch.tensor(np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
                                   rng.uniform(5, 10, n_pts)], -1))
    frames, gt = [], []
    for i in range(n):
        pose = lie.se3_exp(torch.tensor(
            [0.25 * i, 0.01 * i, 0.002 * i, 0.0, 0.01 * i, 0.0], dtype=torch.float64))
        p_cam = lie.se3_apply(lie.se3_inverse(pose), world)
        pix = camera.project(intr, p_cam).numpy()
        lms = {t: pix[t] + rng.normal(0, noise_px, 2) for t in range(n_pts)
               if p_cam[t, 2] > 0.5 and 8 < pix[t, 0] < 232 and 8 < pix[t, 1] < 172}
        frames.append((i * 50_000, lms))
        gt.append(pose.numpy())
    return calib, frames, np.arange(n, dtype=np.int64) * 50_000, np.stack(gt)


class DistinctSamples:
    """A sampler for both runs: minimal samples without a repeated index.
    The front end's own rule draws with replacement, and a sample with a
    repeated correspondence leaves the 8-point system a two-dimensional
    null space: the vector an SVD returns from it is arbitrary, LAPACK and
    cuSOLVER return different ones, and such a hypothesis can collect the
    most inliers on one device and few on the other. The two runs then
    bootstrap from different (equally valid) poses, and the map's scale
    differs by some per cent. Samples of distinct indices agree across the
    devices to one inlier."""

    def __init__(self, seed=0):
        self.generator = torch.Generator(device="cpu").manual_seed(seed)

    def __call__(self, num_hyp, sample_size, n_valid, n_max):
        order = torch.rand(num_hyp, n_valid, generator=self.generator).argsort(-1)
        return order[:, :sample_size] % n_max


def _carry(src, dst):
    """The host-side state and the sampler's stream of one front end, copied
    into another."""
    dst.load_numpy_state(
        src.active_frames.values(), src.stored_frames, src.map.landmarks,
        src.map.observations, src.stored_landmarks, src.without_add,
        src.gt_list, src.gt_aligned, src.zero_gt)
    dst._sample_indices.generator.set_state(src._sample_indices.generator.get_state())


@pytest.mark.gpu
def test_vo_frontend_on_card_matches_cpu(cuda_device):
    """12 keyframes through a front end that is given no device: its solves
    are found on the card, and it agrees with the same run on the CPU on the
    same injected minimal samples.

    Keyframe by keyframe, from the CPU run's state: every pose within 1e-3.
    The free run: rotations within 1e-3, translations within 1e-3 of the
    trajectory's extent. The bootstrap pose differs by ~1e-4 along its
    weakest direction between the devices; it is one of the two gauge poses
    the BA holds fixed, so every later translation carries that difference
    as a common scale factor (1.0004 when this was written), which the
    Sim(3)-aligned ATE does not see."""
    calib, frames, gt_t, gt = _vo_keyframes()

    def front_end(device):
        vo = frontend.VisualOdometryFrontEnd(calib, seed=0, device=device)
        vo._sample_indices = DistinctSamples()
        vo.set_ground_truth(gt_t, gt)
        return vo

    host, card = front_end("cpu"), front_end(None)
    assert card.device.type == "cuda"
    for t, lms in frames:
        step = front_end(None)
        _carry(host, step)
        accepted = host.new_keyframe_candidate(Keyframe(t_us=t, landmarks=dict(lms)))
        assert step.new_keyframe_candidate(Keyframe(t_us=t, landmarks=dict(lms))) == accepted
        assert card.new_keyframe_candidate(Keyframe(t_us=t, landmarks=dict(lms))) == accepted
        np.testing.assert_allclose(np.stack(step.poses()), np.stack(host.poses()), atol=1e-3)
        assert step.map.observations == host.map.observations
    assert card.solve_devices == {"cuda"} and host.solve_devices == {"cpu"}
    assert sorted(card.active_frames) == sorted(host.active_frames)
    p_card, p_host = np.stack(card.poses()), np.stack(host.poses())
    np.testing.assert_allclose(p_card[:, :4], p_host[:, :4], atol=1e-3)
    extent = np.abs(p_host[:, 4:]).max()
    np.testing.assert_allclose(p_card[:, 4:], p_host[:, 4:], atol=1e-3 * extent)
    assert card.last_ate.rmse < 0.05
    assert card.last_ate.rmse == pytest.approx(host.last_ate.rmse, rel=0.05, abs=1e-3)
    assert len(card.ba_log) == len(host.ba_log) > 0


@pytest.mark.gpu
def test_pipelined_on_card_matches_sync_on_card(cuda_device, tmp_path, monkeypatch):
    """The default (pipelined) drive against the synchronous one, both on the
    card, no device given: the same tracks and timestamps, positions within
    1e-3 px, the last motion field within 1e-4 px/ms (same device and the
    same order of work on each stream, so they should be equal); the splat
    kernels are launched from the evo-comp thread
    (their backwards by autograd's thread) on one stream of the worker's own."""
    import threading

    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2)).generate())
    launched = []
    inner = splat._launch

    def recording(name, on, *args):
        launched.append((name, threading.current_thread().name,
                         torch.cuda.current_stream(on.device).cuda_stream))
        return inner(name, on, *args)

    monkeypatch.setattr(splat, "_launch", recording)
    runs = {}
    for name, pipelined in (("sync", False), ("pipe", True)):
        launched.clear()
        (tmp_path / name).mkdir()
        ev = Evaluator(ds, EvaluatorParams(
            output_dir=str(tmp_path / name), pipelined=pipelined,
            compensate=compensate.CompensateParams(max_iters=5)))
        assert ev.device.type == "cuda"
        n_warp = splat.launches_warp_fwd
        ev.run()
        rows = np.loadtxt(ev.finish()["vo_trajectory"], ndmin=2)
        assert splat.launches_warp_fwd > n_warp
        runs[name] = (ev, rows, list(launched))
    (s_ev, s_rows, s_l), (p_ev, p_rows, p_l) = runs["sync"], runs["pipe"]
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    # a backward is launched by autograd's own thread, on its forward's stream
    assert {st for _, _, st in s_l} == {default}
    assert {t for n, t, _ in s_l if "bwd" not in n} == {"MainThread"}
    assert len({st for _, _, st in p_l}) == 1 and p_l[0][2] != default
    assert all(t.startswith("evo-comp") for n, t, _ in p_l if "bwd" not in n)
    assert any("warp_splat_bwd" in n for n, _, _ in p_l)
    assert len(p_l) == len(s_l)
    assert set(p_ev.tracker.trajectories) == set(s_ev.tracker.trajectories)
    for tid, entries in s_ev.tracker.trajectories.items():
        a, b = np.asarray(entries), np.asarray(p_ev.tracker.trajectories[tid])
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=1e-3)
    assert p_ev.counters.counts["compensation_windows"] == \
        s_ev.counters.counts["compensation_windows"] >= 5
    np.testing.assert_allclose(p_ev.motion_field, s_ev.motion_field, atol=1e-4)
    # VO gets identical keyframes, but its scatter-adds on the card sum in an
    # order that depends on what else the card is running, and RANSAC and BA
    # amplify that noise (2.7e-4 in a pose on this scene): held like the two
    # packages against each other, keyframes within 1 and ATE within 1.5x
    assert len(s_rows) >= 6 and abs(len(p_rows) - len(s_rows)) <= 1
    assert np.isfinite(p_rows).all()
    a, b = p_ev.vo.last_ate.rmse, s_ev.vo.last_ate.rmse
    assert max(a, b) <= 1.5 * min(a, b), (a, b)
    assert p_ev.vo.solve_devices == {"cuda"}


@pytest.mark.gpu
def test_compensation_worker_does_not_wait_for_the_default_stream(cuda_device, tmp_path):
    """A window solved on the evo-comp thread finishes while the default
    stream still has seconds of work queued: the worker's launches are on its
    own stream, and its waits are for that stream only."""
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    rng = np.random.default_rng(7)
    n = 15_000
    ts = np.sort(rng.integers(0, 30_000, n)).astype(np.int64)
    xs = rng.uniform(0, 239, n)
    ys = rng.uniform(0, 179, n)
    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.1, fps=20.0, seed=2)).generate())
    ev = Evaluator(ds, EvaluatorParams(
        output_dir=str(tmp_path), compensate=compensate.CompensateParams(max_iters=2)))
    try:
        # the first window starts the worker and builds what it needs
        ev._submit_compensation(xs, ys, ts)
        ev._pending_comp[-1].result(timeout=300).get()
        torch.cuda.synchronize()
        a = torch.randn(8192, 8192, device=cuda_device)
        for _ in range(300):  # seconds of float32 products on the default stream
            torch.mm(a, a)
        busy = torch.cuda.Event()
        busy.record()
        ev._submit_compensation(xs, ys, ts)
        field, img, cost, cost0 = ev._pending_comp[-1].result(timeout=300).get()
        still_busy = not busy.query()
        torch.cuda.synchronize()
    finally:
        ev.stop_workers()
    assert still_busy, "the worker waited for the default stream's work"
    assert np.isfinite(field).all() and img.sum() > 0 and cost <= cost0


@pytest.mark.gpu
def test_resume_on_card_matches_uninterrupted_on_card(cuda_device, tmp_path):
    """Synchronous drive, compensation on, no device given: frames 0-4, a
    checkpoint, a new evaluator restored from it, the rest; the same tracks,
    final costs and motion field as the uninterrupted run (one device, the
    same order of work: equal)."""
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run import checkpoint
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2)).generate())

    def params(name):
        return EvaluatorParams(output_dir=str(tmp_path / name), pipelined=False,
                               compensate=compensate.CompensateParams(max_iters=5))

    full = Evaluator(ds, params("full"))
    full.run()
    first = Evaluator(ds, params("first"))
    first.run(max_frames=5)
    resumed = checkpoint.load_checkpoint(
        checkpoint.save_checkpoint(str(tmp_path / "ckpt"), first), ds, params("resumed"))
    assert resumed.device.type == "cuda" and resumed.tracker.table.alive.is_cuda
    n_warp = splat.launches_warp_fwd
    resumed.run(start_frame=resumed.image_num)
    assert splat.launches_warp_fwd > n_warp
    assert set(resumed.tracker.trajectories) == set(full.tracker.trajectories)
    for tid, entries in full.tracker.trajectories.items():
        a, b = np.asarray(entries), np.asarray(resumed.tracker.trajectories[tid])
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(b[:, 1:], a[:, 1:], atol=1e-3)
    assert [r[0] for r in resumed.tracker.final_cost_log] == \
        [r[0] for r in full.tracker.final_cost_log]
    np.testing.assert_allclose(resumed.motion_field, full.motion_field, atol=1e-4)


@pytest.mark.gpu
def test_quarantine_on_card_keeps_healthy_rows(cuda_device):
    """`quarantine_patches` on a table on the card clears `alive` of the bad
    rows whose id still matches, and leaves every other value bit for bit."""
    from evo_tpu_torch.run.watchdog import HealthMonitor
    from evo_tpu_torch.tracker import patch_state as ps
    from evo_tpu_torch.tracker.detector import EventTracker

    tr = EventTracker()
    g = torch.Generator().manual_seed(0)
    p = tr.table.capacity
    tr.table = tr.table.replace(
        alive=torch.ones(p, dtype=torch.bool, device=cuda_device),
        track_id=torch.arange(p, dtype=torch.int32, device=cuda_device),
        center=(torch.rand(p, 2, generator=g) * 150).to(cuda_device),
        ev_t=torch.rand(p, ps.MAX_EVENTS, generator=g).to(cuda_device))
    before = ps.table_to_numpy(tr.table)
    bad = np.zeros(p, bool)
    bad[[3, 40, 41]] = True
    ids = before["track_id"].copy()
    ids[41] = -5  # reused since the mirror: left alone
    HealthMonitor().quarantine_patches(tr, bad, track_id=ids)
    assert tr.table.alive.is_cuda
    after = ps.table_to_numpy(tr.table)
    want = before["alive"].copy()
    want[[3, 40]] = False
    np.testing.assert_array_equal(after["alive"], want)
    for k in ps.FIELDS:
        if k != "alive":
            assert after[k].tobytes() == before[k].tobytes(), k


@pytest.mark.gpu
def test_meshed_evaluator_on_card_matches_unmeshed(cuda_device, tmp_path):
    """`EvaluatorParams(mesh=make_mesh())` over one NCCL rank, on the
    synchronous and the default drive, against the unmeshed run of the same
    drive, no device given: the one rank holds all 128 rows and solves what
    the unmeshed run solves, in the same order, so the tracks, their
    timestamps and the splat launches are the same and positions within
    1e-3 px, the last motion field within 1e-4 px/ms."""
    import torch.distributed as dist

    from evo_tpu_torch.dist import mesh, multihost
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2)).generate())
    multihost.initialize("file://" + str(tmp_path / "rendezvous"), 1, 0)
    try:
        assert dist.get_backend() == "nccl"
        m = mesh.make_mesh()
        for pipelined in (False, True):
            runs = []
            for grid in (None, m):
                out = tmp_path / f"{pipelined}_{grid is not None}"
                ev = Evaluator(ds, EvaluatorParams(
                    output_dir=str(out), pipelined=pipelined, mesh=grid,
                    compensate=compensate.CompensateParams(max_iters=5)))
                splat.reset_counts()
                ev.run()
                ev.finish()
                runs.append((ev, (splat.launches_fwd, splat.launches_warp_fwd,
                                  splat.launches_warp_bwd)))
            (a, la), (b, lb) = runs
            assert b.tracker.mesh is m and b.tracker.table.alive.is_cuda
            assert la == lb and la[1] > 0
            assert set(a.tracker.trajectories) == set(b.tracker.trajectories)
            for tid, entries in a.tracker.trajectories.items():
                x, y = np.asarray(entries), np.asarray(b.tracker.trajectories[tid])
                np.testing.assert_array_equal(x[:, 0], y[:, 0])
                np.testing.assert_allclose(y[:, 1:], x[:, 1:], atol=1e-3)
            np.testing.assert_allclose(b.motion_field, a.motion_field, atol=1e-4)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_parity_worker_in_two_gloo_ranks_on_card(cuda_device):
    """`parity_worker` in two gloo ranks sharing the card (NCCL takes one rank
    per card): the sharded decode and window scan on CUDA tensors against one
    rank's computation, the JAX package's bars (2e-4, 2e-3)."""
    from evo_tpu_torch.dist import multihost

    ranks = multihost.launch(multihost.parity_worker, 2, (cuda_device,), device=cuda_device,
                             backend="gloo", timeout_s=300.0)
    assert [r["process_id"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["num_processes"] == 2 and r["backend"] == "gloo"
        assert r["device"].startswith("cuda")
        assert r["decode_max_abs_err"] < 2e-4 and r["scan_max_abs_err"] < 2e-3 and r["ok"], r


# ---- the alignment step (`kernels/align_step.py`, `csrc/align_step.cu`) ----
# Tolerances: those of tests/test_torch_align_step.py (the kernel sums the
# 625 rect pixels in another order than the plain version's batched
# reductions, and the LM carries that noise along flat directions of the
# cost; `torch_align_tables.WEAK_ROWS` names the one edge row that float32
# leaves loose), and the integrated event image exact (a sum of +-1).


def _ready_rows(dev):
    """The 128-row ready table and gradient store `block_split_check` and
    `parity_worker` use."""
    from evo_tpu_torch.dist import multihost
    from evo_tpu_torch.tracker import patch_state as ps

    t = multihost._ready_table(np.random.default_rng(1), 128, 180, 240)
    *events, grads = multihost._scan_inputs(np.random.default_rng(2), 2, 2048, 180, 240)
    return (ps.table_from_numpy(t, dev), torch.as_tensor(grads).to(dev),
            [torch.as_tensor(a).to(dev) for a in events])


def _kernel_against_plain(table, grads, rows):
    """One launch against `solve_step_ref` on the same table; returns the
    kernel's integrated images, trips and ran."""
    from evo_tpu_torch.kernels import align_step as kalign
    from evo_tpu_torch.tracker import align
    from evo_tpu_torch.tracker import patch_state as ps
    import torch_align_tables as tables

    n = kalign.launches_align
    fields, ran, cost, lost, extra = kalign.align_step(table, grads, grads[0],
                                                       integrated=True, trips=True)
    torch.cuda.synchronize()
    assert kalign.launches_align == n + 1
    assert all(v.is_cuda for v in fields.values())
    ref_table, ref_ran, ref_cost, ref_lost = align.solve_step_ref(table, grads, grads[0])
    assert torch.equal(ran, ref_ran)
    ran_np = ran.cpu().numpy()
    tables.assert_same_step(ps.table_to_numpy(table.replace(**fields)),
                            ps.table_to_numpy(ref_table), ran_np, cost.cpu().numpy(),
                            ref_cost.cpu().numpy(), table.center.cpu().numpy(), rows)
    sure = ((ref_table.final_costs.median(1).values - 0.6).abs() > 1e-5)
    assert torch.equal(lost[sure], ref_lost[sure])
    img = align.integrate_events(table)
    assert torch.equal(extra["integrated"][ran], img[ran])
    assert (extra["trips"][ran] >= 1).all() and (extra["trips"][~ran] == 0).all()
    return extra, ran


@pytest.mark.gpu
def test_align_step_kernel_matches_plain_version(cuda_device):
    """The kernel against `solve_step_ref` on the card at P = 128 ready rows
    (the window scan's table): ran equal, lost equal, the integrated images
    exact, costs within 1e-4 relative, centres and the warps' rect pixels
    within 1e-3 px, flow within 1e-4 rad, budgets within 1."""
    table, grads, _ = _ready_rows(cuda_device)
    rows = {f"row_{i}": i for i in range(128)}
    extra, ran = _kernel_against_plain(table, grads, rows)
    assert ran.all()


@pytest.mark.gpu
def test_align_step_edge_rows_on_card(cuda_device):
    """The kernel against `solve_step_ref` on `torch_align_tables.edge_table`:
    no integration set, events outside the rect, a window clamped at the
    border, a rect out of the image, a border-lost row, a warp off the image,
    a degenerate (singular, damped) system, a lost row, rows not ready, dead
    or uninitialised; and a NaN flow, whose every step is bad: the kernel
    neither raises nor faults, and gives NaN where the plain version does."""
    from evo_tpu_torch.kernels import align_step as kalign
    from evo_tpu_torch.tracker import align
    from evo_tpu_torch.tracker import patch_state as ps
    import torch_align_tables as tables

    rng = np.random.default_rng(5)
    grads = torch.as_tensor(tables.smooth_grads(rng)).to(cuda_device)
    fields, rows = tables.edge_table(rng, grads.cpu().numpy(), nan_row=True)
    nan_row = rows.pop("nan_flow")
    finite = {k: v[:nan_row] for k, v in fields.items()}
    _kernel_against_plain(ps.table_from_numpy(finite, cuda_device), grads, rows)

    table = ps.table_from_numpy(fields, cuda_device)
    got, ran, cost, lost, _ = kalign.align_step(table, grads, grads[0])
    want, ref_ran, ref_cost, ref_lost = align.solve_step_ref(table, grads, grads[0])
    torch.cuda.synchronize()
    assert ran[nan_row] and ref_ran[nan_row] and not lost[nan_row] and not ref_lost[nan_row]
    assert torch.isnan(cost[nan_row]) and torch.isnan(ref_cost[nan_row])
    for name, v in got.items():
        a, b = v[nan_row].cpu(), getattr(want, name)[nan_row].cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b)) if a.is_floating_point() \
            else torch.equal(a, b), name
    # the rows before it are those of the first launch
    for name, v in got.items():
        a, b = v[:nan_row].cpu(), getattr(want, name)[:nan_row].cpu()
        assert a.shape == b.shape and bool(torch.isfinite(a.float()).all()), name


@pytest.mark.gpu
def test_align_step_clock_build_on_card(cuda_device):
    """The kernel's clock build (-DEVO_ALIGN_CLOCKS) at P = 128 ready rows:
    the bits of the plain build in every output, each row's stage cycles
    adding up to its total, and the count of launches of both."""
    from evo_tpu_torch.kernels import align_step as kalign

    table, grads, _ = _ready_rows(cuda_device)
    n = kalign.launches_align
    outs = []
    for clocks in (False, True):
        fields, ran, cost, lost, extra = kalign.align_step(
            table, grads, grads[0], integrated=True, trips=True, clocks=clocks)
        outs.append({**fields, "ran": ran, "cost": cost, "lost": lost, **extra})
    torch.cuda.synchronize()
    assert kalign.launches_align == n + 2
    for name, v in outs[0].items():
        assert torch.equal(torch.nan_to_num(v), torch.nan_to_num(outs[1][name])), name
    clocks = outs[1]["clocks"].cpu()
    assert clocks.shape == (128, len(kalign.STAGES))
    assert torch.equal(clocks[:, :-1].sum(1), clocks[:, -1]) and (clocks[:, -1] > 0).all()


@pytest.mark.gpu
def test_window_scan_on_card_does_not_depend_on_the_block(cuda_device, monkeypatch):
    """`process_window_scan` of 128 ready rows on the card against the same
    rows as two blocks of 64, as two ranks hold them: bit for bit, every
    field and every log. The scan launches the kernel once a sub-batch and
    never reaches the plain version."""
    from evo_tpu_torch.kernels import align_step as kalign
    from evo_tpu_torch.tracker import align
    from evo_tpu_torch.tracker import patch_state as ps

    def refuse(*args, **kwargs):
        raise AssertionError("the card's scan took the plain version")

    monkeypatch.setattr(align, "solve_step_ref", refuse)
    monkeypatch.setattr(align, "optimize_ready_patches", refuse)
    table, grads, events = _ready_rows(cuda_device)
    n = kalign.launches_align
    full, log = align.process_window_scan(table, grads, *events, grads[0])
    assert kalign.launches_align == n + events[0].shape[0]
    halves = [align.process_window_scan(
        ps.PatchTable(**{k: getattr(table, k)[s].contiguous() for k in ps.FIELDS}),
        grads, *events, grads[0]) for s in (slice(0, 64), slice(64, 128))]
    assert log["ran"][0].all()
    for name in ps.FIELDS:
        assert torch.equal(torch.cat([getattr(h[0], name) for h in halves]),
                           getattr(full, name)), name
    for name, v in log.items():
        assert torch.equal(torch.cat([h[1][name] for h in halves], 1), v), name
