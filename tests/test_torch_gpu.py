"""Tests of the port that need a CUDA card: its kernels against their plain
PyTorch versions, and the card's run of the slice against the CPU's.
Without a card they skip. This file imports no JAX (the machine with the
card has none); run it there with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: nearest splat counts exact; Gaussian and bilinear values and
gradients rtol/atol 1e-5 (atomics sum in another order); the fused entry's
d/d vel rtol 1e-5 with atol 1e-5 of its largest entry (a sum over the tile's
events that cancels); compensation field within 1e-4 px/ms between the card
and the CPU, one window or three solved together, and eight windows solved
together bit for bit as each alone; compensation's kernels to the bars of
`evo_tpu_torch/run/time_comp.py`; VO keyframe poses within
1e-3 between the card and the CPU on the same RANSAC draws, keyframe by
keyframe from one state (the card's scatter-adds and SVDs sum in another
order), and within 1e-3 of the trajectory's extent over a free run; VO's
kernels (`localize`, `ba_solve`) to the bars of
`evo_tpu_torch/run/time_vo.py`'s checks, bit for bit from call to call and
beside each other, one launch a solve; the frame policy's and the event
routing's kernels bit for bit against their plain versions on the card and
on the CPU (`tests/torch_policy_cases.py`'s inputs, as the emulated tests
take them)."""

import numpy as np
import pytest
import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.core.types import CalibParams
from evo_tpu_torch.kernels import comp_step, comp_tile, splat
from evo_tpu_torch.tracker import compensate
from evo_tpu_torch.vo import frontend
from evo_tpu_torch.vo.keyframe import Keyframe
import torch_policy_cases as policy_cases

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
    n_fwd, n_tile, n_step = (splat.launches_fwd, comp_tile.launches_comp_tile,
                             comp_step.launches_step)
    # no device given: the entry point itself picks the card
    f_gpu, img_gpu, c_gpu, _ = compensate.compensate_window(x, y, t_us, p, h, w)
    assert splat.launches_fwd > n_fwd and comp_tile.launches_comp_tile > n_tile \
        and comp_step.launches_step > n_step
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
    same mass); the W·T tiles go through kernels A and B."""
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
    n_tile, n_step = comp_tile.launches_comp_tile, comp_step.launches_step
    gpu = temporal.compensate_windows_batched(windows, p, h, w)
    assert comp_tile.launches_comp_tile > n_tile and comp_step.launches_step > n_step
    cpu = temporal.compensate_windows_batched(windows, p, h, w, device="cpu")
    for (f_gpu, img_gpu, c_gpu, _), (f_cpu, img_cpu, c_cpu, _) in zip(gpu, cpu):
        np.testing.assert_allclose(f_gpu, f_cpu, atol=1e-4)
        assert c_gpu == pytest.approx(c_cpu, rel=1e-5)
        assert img_gpu.sum() == img_cpu.sum() and np.mean(img_gpu == img_cpu) >= 0.995


def _line_windows(k, n=4000, h=60, w=80):
    rng = np.random.default_rng(11)
    out = []
    for i in range(k):
        t_us = np.sort(rng.uniform(0, 100_000, n)).astype(np.int64) + 100_000 * i
        x = np.clip(rng.choice(np.arange(5, w - 5, 10), n) + (30 + 5 * i) * (t_us % 100_000)
                    * 1e-6 + rng.normal(0, 0.3, n), 0, w - 1)
        out.append((x, rng.uniform(0, h - 1, n), t_us))
    return out


@pytest.mark.gpu
def test_batched_windows_on_card_equal_their_one_window_solves(cuda_device):
    """Eight windows solved together on the card give each window's field
    and costs of its solve alone, bit for bit: kernel A runs a block a tile
    row, kernel B one a window, and padding events change nothing."""
    from evo_tpu_torch.dist import temporal

    windows = _line_windows(8)
    p = compensate.CompensateParams(max_iters=25, events_per_tile_cap=512)
    batched = temporal.compensate_windows_batched(windows, p, 60, 80)
    for win, (f8, _, c8, c08) in zip(windows, batched):
        f1, _, c1, c01 = compensate.compensate_window(*win, p, 60, 80)
        assert np.array_equal(f1, f8) and c1 == c8 and c01 == c08


class _Once:
    """A timer that runs each function once and times nothing."""

    @staticmethod
    def device_ms(fn, reps):
        fn()
        return 0.0

    host_us = device_ms


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["edge", "variance"])
def test_comp_tile_matches_plain_on_card(cuda_device, loss):
    """Kernel A at [216, 256] against autograd through the plain splat (the
    bars of `run/time_comp.py`: the score and r 1e-4 relative, J 1e-3,
    escaped equal)."""
    from evo_tpu_torch.run.time_comp import check_comp_tile

    row = check_comp_tile(_Once(), cuda_device, 2, 256, loss, reps=1)
    assert row["r_rel_err"] <= 1e-4 and row["max_abs_err"] <= 1e-3
    assert row["score_rel_err"] <= 1e-4


@pytest.mark.gpu
def test_comp_tile_matches_plain_at_40_px_tiles_on_card(cuda_device):
    """Kernel A on the 24 tiles of 40 px (120x120 padded images, the loss in
    strips of pool rows) at E = 1024, under the same bars."""
    from evo_tpu_torch.run.time_comp import check_comp_tile

    row = check_comp_tile(_Once(), cuda_device, 1, 1024, "edge", reps=1, tile=40)
    assert row["score_rel_err"] <= 1e-4 and row["max_abs_err"] <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("nw, tile", [(1, 20), (3, 20), (1, 40)])
def test_comp_step_matches_plain_on_card(cuda_device, nw, tile):
    """Kernel B's solve and loop entries against their plain versions (the
    bars of `run/time_comp.py`)."""
    from evo_tpu_torch.run.time_comp import check_comp_step

    row = check_comp_step(_Once(), cuda_device, nw, tile, reps=1)
    assert row["errors"]["tail"]["active_equal"]


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [20, 40])
def test_comp_clock_builds_on_card(cuda_device, tile):
    """Compensation's clock builds (-DEVO_COMP_CLOCKS): kernel A's at one
    window of `tile` px tiles, E = 1024, and kernel B's HEAD launch, each
    with the bits of its plain build in every output, each row's or
    window's stage cycles adding up to its total (`run/time_comp.py`'s
    `clock_comp_tile` and `clock_comp_step` raise otherwise), and counted as
    launches of the kernels."""
    from evo_tpu_torch.run.time_comp import clock_comp_step, clock_comp_tile

    n_tile, n_step = comp_tile.launches_comp_tile, comp_step.launches_step
    a = clock_comp_tile(_Once(), cuda_device, 1, 1024, "edge", reps=1, tile=tile)
    b = clock_comp_step(_Once(), cuda_device, 1, tile, reps=1)
    assert comp_tile.launches_comp_tile > n_tile and comp_step.launches_step > n_step
    assert a["clock"]["stages"] == list(comp_tile.STAGES)
    assert b["clock"]["stages"] == list(comp_step.STAGES)
    assert a["clock"]["mean_cycles"][-1] > 0 and b["clock"]["mean_cycles"][-1] > 0


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
    kernels and compensation's are launched from the evo-comp thread on one
    stream of the worker's own."""
    import threading

    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run.evaluator import Evaluator, EvaluatorParams

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2)).generate())
    from evo_tpu_torch.kernels import nvcc

    launched = []
    inner = nvcc.launch

    def recording(fn, on, *args):
        if fn.__name__.startswith(("evo_comp", "evo_splat", "evo_warp")):
            launched.append((fn.__name__, threading.current_thread().name,
                             torch.cuda.current_stream(on.device).cuda_stream))
        return inner(fn, on, *args)

    monkeypatch.setattr(nvcc, "launch", recording)
    runs = {}
    for name, pipelined in (("sync", False), ("pipe", True)):
        launched.clear()
        (tmp_path / name).mkdir()
        ev = Evaluator(ds, EvaluatorParams(
            output_dir=str(tmp_path / name), pipelined=pipelined,
            compensate=compensate.CompensateParams(max_iters=5)))
        assert ev.device.type == "cuda"
        n_tile = comp_tile.launches_comp_tile
        ev.run()
        rows = np.loadtxt(ev.finish()["vo_trajectory"], ndmin=2)
        assert comp_tile.launches_comp_tile > n_tile
        runs[name] = (ev, rows, list(launched))
    (s_ev, s_rows, s_l), (p_ev, p_rows, p_l) = runs["sync"], runs["pipe"]
    default = torch.cuda.default_stream(cuda_device).cuda_stream
    assert {st for _, _, st in s_l} == {default}
    assert {t for _, t, _ in s_l} == {"MainThread"}
    assert len({st for _, _, st in p_l}) == 1 and p_l[0][2] != default
    assert all(t.startswith("evo-comp") for _, t, _ in p_l)
    assert any(n == "evo_comp_lm_step" for n, _, _ in p_l)
    assert len(p_l) == len(s_l)
    assert set(p_ev.tracker.trajectories) == set(s_ev.tracker.trajectories)
    for tid, entries in s_ev.tracker.trajectories.items():
        a, b = np.asarray(entries), np.asarray(p_ev.tracker.trajectories[tid])
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], atol=1e-3)
    assert p_ev.counters.counts["compensation_windows"] == \
        s_ev.counters.counts["compensation_windows"] >= 5
    np.testing.assert_allclose(p_ev.motion_field, s_ev.motion_field, atol=1e-4)
    # VO gets identical keyframes and sums them in one order on the card
    # (`test_vo_on_card_repeats_itself`); held, as the two packages are
    # against each other, to keyframes within 1 and ATE within 1.5x
    assert len(s_rows) >= 6 and abs(len(p_rows) - len(s_rows)) <= 1
    assert np.isfinite(p_rows).all()
    a, b = p_ev.vo.last_ate.rmse, s_ev.vo.last_ate.rmse
    assert max(a, b) <= 1.5 * min(a, b), (a, b)
    assert p_ev.vo.solve_devices == {"cuda"}


@pytest.mark.gpu
def test_vo_on_card_repeats_itself(cuda_device):
    """VO run on the card three times on the same input gives the same
    keyframe poses and ATE bit for bit (ROADMAP §C item 5: its normal
    equations were summed by `index_add_`, whose atomics add in the order
    the threads arrive). The input: the keyframe candidates a synchronous
    run of the 0.5 s scene of `test_pipelined_on_card_matches_sync_on_card`
    hands to VO."""
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.run import time_vo

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.5, fps=20.0, seed=2)).generate())
    candidates = time_vo.record_candidates(ds, 10, cuda_device)
    runs = [time_vo.run_vo(ds, candidates, cuda_device) for _ in range(3)]
    assert len(runs[0]["poses"]) >= 6 and runs[0]["ate"] is not None
    for r in runs[1:]:
        np.testing.assert_array_equal(r["poses"], runs[0]["poses"])
        assert r["ate"] == runs[0]["ate"]
        assert r["ba_iterations"] == runs[0]["ba_iterations"]


@pytest.mark.gpu
def test_observation_sums_on_card_equal_the_cpus(cuda_device):
    """The BA's fixed-order sums on the card: the CPU's sums bit for bit, on
    every one of ten runs, for each block shape the BA sums."""
    from evo_tpu_torch.vo import ba

    rng = np.random.default_rng(0)
    n_f, n_l, n = 21, 192, 2048
    of = torch.tensor(rng.integers(0, n_f, n))
    ol = torch.tensor(rng.integers(0, n_l, n))
    cpu = ba.observation_sums(of, ol, n_f, n_l)
    card = ba.observation_sums(of.to(cuda_device), ol.to(cuda_device), n_f, n_l)
    for k, shape in ((0, (6, 6)), (0, (6,)), (1, (3, 3)), (1, (3,)), (1, (1,)), (2, (6, 3))):
        vals = torch.tensor(rng.standard_normal((n,) + shape).astype(np.float32)
                            * 10.0 ** rng.uniform(-3, 3, (n,) + (1,) * len(shape)))
        want = cpu[k](vals)
        for _ in range(10):
            assert torch.equal(card[k](vals.to(cuda_device)).cpu(), want), (k, shape)


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
    n_tile = comp_tile.launches_comp_tile
    resumed.run(start_frame=resumed.image_num)
    assert comp_tile.launches_comp_tile > n_tile
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
                comp_tile.reset_counts()
                ev.run()
                ev.finish()
                runs.append((ev, (splat.launches_fwd, comp_tile.launches_comp_tile)))
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


# -- VO's kernels: localize and ba_solve ----------------------------------------
class _Once:
    """A timer that runs each function once and times nothing: the checks of
    `run/time_vo.py` without their times."""

    @staticmethod
    def device_ms(fn, reps):
        fn()
        return 0.0

    host_us = device_ms


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_localize_kernel_matches_plain_on_card(cuda_device, seed):
    """`kernels.localize` against `localize_camera_fused_ref` on the card,
    under `run.time_vo.check_localize`'s bars (those of
    tests/test_torch_vo_emulated.py)."""
    import torch_vo_problems as problems

    from evo_tpu_torch.run import time_vo

    intr, pix, pts, n, valid, idx = problems.localize_problem(seed)
    row = time_vo.check_localize(_Once(), cuda_device, (
        [intr, pix, pts, n, valid, problems.THRESHOLD], dict(num_hypotheses=128, indices=idx)))
    assert row["trips"] >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("compensated", [False, True])
def test_ba_kernel_matches_plain_on_card(cuda_device, compensated):
    """`kernels.ba_solve` against `ba_solve_ref` on the card, under
    `run.time_vo.check_ba`'s bars, and, on this well-conditioned window,
    those of tests/test_torch_vo_emulated.py: poses and landmarks within
    1e-4 of the plain version's (1e-3 where a tie parts the trips)."""
    import torch_vo_problems as problems

    from evo_tpu_torch.run import time_vo

    row = time_vo.check_ba(_Once(), cuda_device, (problems.ba_problem(), dict(
        num_iters=50, huber=0.8, compensated=compensated, tol=1e-5)))
    assert row["trips"][0] >= 2
    assert row["max_abs_err"] <= (1e-4 if row["trips"][0] == row["trips"][1] else 1e-3), row


@pytest.mark.gpu
def test_vo_kernels_repeat_their_bits_beside_each_other_on_card(cuda_device):
    """Each kernel twice alone, then both at once on two streams: the same
    bits every time."""
    import torch_vo_problems as problems

    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import localize as kloc
    from evo_tpu_torch.vo import ba

    loc = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a
           for a in problems.localize_problem(0)]
    intr, pix, pts, _, valid, idx = loc
    bargs = [a.to(cuda_device) for a in problems.ba_problem()]
    bargs.append(ba.observation_orders(bargs[3], bargs[4], bargs[0].shape[0], bargs[1].shape[0],
                                       False, bargs[6]))
    kw = dict(num_iters=50, huber=0.8, compensated=False, tol=1e-5)

    def both():
        return kloc.localize(intr, pix, pts, valid, problems.THRESHOLD, idx), \
            kba.ba_solve(*bargs, **kw)

    (l1, b1), (l2, b2) = both(), both()
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(streams[0]):
        l3 = kloc.localize(intr, pix, pts, valid, problems.THRESHOLD, idx)
    with torch.cuda.stream(streams[1]):
        b3 = kba.ba_solve(*bargs, **kw)
    torch.cuda.synchronize()
    for lo in (l2, l3):
        for f in ("pose", "inliers", "candidates", "counts", "best_idx"):
            assert torch.equal(getattr(lo, f), getattr(l1, f)), f
    for bo in (b2, b3):
        for a, b in zip(bo, b1):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("compensated", [False, True])
def test_ba_kernel_gives_its_bits_in_any_cluster_on_card(cuda_device, compensated):
    """`kernels.ba_solve` in clusters of 1, 2, 4, 8 and 16 blocks of 128 and
    256 threads: the bits of the default launch every time."""
    import torch_vo_problems as problems

    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import nvcc
    from evo_tpu_torch.vo import ba

    args = [a.to(cuda_device) for a in problems.ba_problem()]
    orders = ba.observation_orders(args[3], args[4], args[0].shape[0], args[1].shape[0],
                                   compensated, args[6])
    kw = dict(num_iters=50, huber=0.8, compensated=compensated, tol=1e-5)
    want = kba.ba_solve(*args, orders, **kw)
    lib = kba._lib()
    for cluster in (1, 2, 4, 8, 16):
        for threads in (128, 256):
            got = kba.run(lib, lambda *a: nvcc.launch(lib.evo_ba_solve, args[0], *a), *args,
                          orders, **kw, threads=threads, cluster=cluster)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (cluster, threads)


@pytest.mark.gpu
def test_vo_clock_builds_give_the_kernels_bits_on_card(cuda_device):
    """Each VO kernel's clock build against its plain build on the tests'
    problems (`run.time_vo.clock_localize`, `clock_ba`): the same bits, and
    stages that add up to the total."""
    import torch_vo_problems as problems

    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import localize as kloc
    from evo_tpu_torch.run import time_vo

    intr, pix, pts, n, valid, idx = problems.localize_problem(0)
    row = time_vo.clock_localize(_Once(), cuda_device, (
        [intr, pix, pts, n, valid, problems.THRESHOLD], dict(num_hypotheses=128, indices=idx)), 1)
    assert row["clock"]["stages"] == list(kloc.STAGES) and row["clock"]["cycles"][-1] > 0
    row = time_vo.clock_ba(_Once(), cuda_device, (problems.ba_problem(), dict(
        num_iters=50, huber=0.8, compensated=False, tol=1e-5)), 1)
    assert row["clock"]["stages"] == list(kba.STAGES) and row["clock"]["cycles"][-1] > 0


@pytest.mark.gpu
def test_vo_on_card_takes_one_launch_a_solve(cuda_device, monkeypatch):
    """The front end on the card, given no device: each localization is one
    launch of `kernels.localize` and each BA one of `kernels.ba_solve`, and
    neither plain version runs on a card tensor."""
    from evo_tpu_torch.kernels import ba_solve as kba
    from evo_tpu_torch.kernels import localize as kloc
    from evo_tpu_torch.solve import ransac
    from evo_tpu_torch.vo import ba

    plain_on_card = []
    for mod, name in ((ransac, "localize_camera_fused_ref"), (ba, "ba_solve_ref")):
        inner = getattr(mod, name)

        def watch(*args, _inner=inner, _name=name, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                plain_on_card.append(_name)
            return _inner(*args, **kw)

        monkeypatch.setattr(mod, name, watch)
    calib, frames, gt_t, gt = _vo_keyframes()
    vo = frontend.VisualOdometryFrontEnd(calib, seed=0)
    vo.set_ground_truth(gt_t, gt)
    kloc.reset_counts()
    kba.reset_counts()
    for t, lms in frames:
        vo.new_keyframe_candidate(Keyframe(t_us=t, landmarks=dict(lms)))
    assert vo.solve_devices == {"cuda"} and not plain_on_card
    assert kloc.launches_localize == vo.stage_calls["localize"] >= 9
    assert kba.launches_ba == vo.stage_calls["ba"] == len(vo.ba_log) >= 9
    assert vo.last_ate.rmse < 0.05


# -- the frame path's kernels (frame_maps, corner_select, frame_rows) -------

def _frame_pair(dev):
    from evo_tpu_torch.run import time_frames

    return [torch.from_numpy(time_frames.texture(*d)).to(dev) for d in ((0, 0), (1.7, -0.8))]


@pytest.mark.gpu
def test_frame_maps_kernel_matches_plain_on_card(cuda_device):
    """`frame_maps` on the card against its plain version on the card (1e-5)
    at the run's size and at sizes that are no multiple of its 32 px tile."""
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.run import time_frames

    imgs = _frame_pair(cuda_device) + [
        torch.rand(97, 131, generator=torch.Generator().manual_seed(4)).to(cuda_device)]
    fm.reset_counts()
    for img in imgs:
        got, ref = fm.frame_maps(img), fm.frame_maps_ref(img)
        assert [t.shape for t in got] == [t.shape for t in ref]
        assert time_frames.maps_error(got, ref) <= 1e-5
    assert fm.launches_frame_maps == len(imgs)


@pytest.mark.gpu
def test_corner_select_kernel_matches_plain_on_card(cuda_device):
    """`corner_select` on the card: the plain version's corners, order and
    scores on the texture's response, on 1,728 equal peaks (the lower flat
    index first) and on a noise response whose candidates outnumber what
    shared memory could list."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.kernels import harris

    kw = dict(max_corners=100, quality_level=0.01, min_distance=10.0, border=13)
    ties = torch.zeros(180, 240, device=cuda_device)
    ties[2::5, 2::5] = 1.0
    ties[40:60:5, 100:200:5] = 2.0
    noise = harris.harris_response(
        torch.rand(1080, 1440, generator=torch.Generator().manual_seed(7)).to(cuda_device))
    assert cs.candidates(noise, **kw) > 232448 // 8
    cases = [(fm.frame_maps(img)[1], kw) for img in _frame_pair(cuda_device)]
    cases += [(ties, dict(kw, border=0)), (ties, dict(kw, border=0, max_corners=30)),
              (noise, kw)]
    cs.reset_counts()
    for resp, k in cases:
        same = cs.same_corners(cs.corner_select(resp, **k), cs.corner_select_ref(resp, **k))
        assert same["equal"] and same["accepted"] >= 8, same
    assert cs.launches_corner_select == len(cases)


@pytest.mark.gpu
def test_frame_rows_kernel_matches_plain_on_card(cuda_device):
    """`frame_rows` on the card against `frame_rows_ref` on the card
    (`run.time_frames.compare_rows`): new rows near each edge of the texture
    pair beside rows that only take their budget, and without LK; then
    `kernels.lk.pyramidal_lk` (LK alone) against its plain version."""
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.kernels import frame_rows as fr
    from evo_tpu_torch.kernels import lk
    from evo_tpu_torch.run import time_frames
    from evo_tpu_torch.tracker import detector
    from evo_tpu_torch.tracker import patch_state as ps

    img0, img1 = _frame_pair(cuda_device)
    maps0, maps1 = fm.frame_maps(img0), fm.frame_maps(img1)
    pyr0, pyr1 = fm.pyramid(img0, maps0, 3), fm.pyramid(img1, maps1, 3)
    rng = np.random.default_rng(3)
    fields = ps.table_to_numpy(ps.empty_table(32, device="cpu"))
    pts = np.array([(14.0, 90.0), (225.5, 88.25), (120.0, 14.0), (119.5, 160.5),
                    (14.5, 14.5), (225.0, 165.0), (60.5, 60.5), (4.5, 100.0)], np.float32)
    fields["center"][:8] = pts
    fields["center"][8:20] = rng.uniform(20, 160, (12, 2)).astype(np.float32)
    fields["alive"][:20] = True
    fields["initialized"][8:20] = True
    fields["num_of_events"][:] = 75
    table = ps.table_from_numpy(fields, device=cuda_device)
    fr.reset_counts()
    for with_lk in (True, False):
        kw = dict(with_lk=with_lk, radius=10, diagnostics=True)
        row = time_frames.compare_rows(fr.frame_rows(table, pyr0, pyr1, maps1[0], **kw),
                                       detector.frame_rows_ref(table, pyr0, pyr1, maps1[0],
                                                               **kw))
        assert row["ok"] and not row["rows_apart"], row
    assert fr.launches_frame_rows == 2
    valid = torch.ones(8, dtype=torch.bool, device=cuda_device)
    p = torch.from_numpy(pts).to(cuda_device)
    _, flow, st = lk.pyramidal_lk(img0, img1, p, valid)
    _, flow_r, st_r = lk.pyramidal_lk_ref(img0, img1, p, valid)
    assert torch.equal(st, st_r) and int(st.sum()) >= 3
    assert float((flow - flow_r)[st].abs().max()) <= 1e-3


@pytest.mark.gpu
def test_frame_rows_at_radius_15_on_card(cuda_device):
    """`frame_rows` at LK radius 15, (2 r + 1)^2 = 961 samples over the
    block's 640 threads (two a thread), against `frame_rows_ref` on the card
    (`run.time_frames.compare_rows`: status equal, flow 1e-3 px, the fields
    as the plain version's): new rows near each edge of the texture pair
    and rows that only take their budget."""
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.kernels import frame_rows as fr
    from evo_tpu_torch.run import time_frames
    from evo_tpu_torch.tracker import detector
    from evo_tpu_torch.tracker import patch_state as ps

    img0, img1 = _frame_pair(cuda_device)
    maps0, maps1 = fm.frame_maps(img0), fm.frame_maps(img1)
    pyr0, pyr1 = fm.pyramid(img0, maps0, 3), fm.pyramid(img1, maps1, 3)
    rng = np.random.default_rng(6)
    fields = ps.table_to_numpy(ps.empty_table(24, device="cpu"))
    fields["center"][:8] = [(14.0, 90.0), (225.5, 88.25), (120.0, 14.0), (119.5, 160.5),
                            (14.5, 14.5), (225.0, 165.0), (60.5, 60.5), (150.25, 80.75)]
    fields["center"][8:16] = rng.uniform(20, 160, (8, 2)).astype(np.float32)
    fields["alive"][:16] = True
    fields["initialized"][8:16] = True
    fields["num_of_events"][:] = 75
    table = ps.table_from_numpy(fields, device=cuda_device)
    kw = dict(with_lk=True, radius=15, diagnostics=True)
    fr.reset_counts()
    row = time_frames.compare_rows(fr.frame_rows(table, pyr0, pyr1, maps1[0], **kw),
                                   detector.frame_rows_ref(table, pyr0, pyr1, maps1[0], **kw))
    assert row["ok"] and not row["rows_apart"] and row["lk_rows"] == 8, row
    assert fr.launches_frame_rows == 1


@pytest.mark.gpu
def test_corner_select_above_256_corners_on_card(cuda_device):
    """`corner_select` with max_corners 300 and 1,000 (above the former
    limit of 256) on the Harris response of a 360 x 480 noise frame with a
    4 px min_distance: the plain version's corners, order and scores."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.kernels import harris

    resp = harris.harris_response(
        torch.rand(360, 480, generator=torch.Generator().manual_seed(12)).to(cuda_device))
    cs.reset_counts()
    for m in (300, 1000):
        kw = dict(max_corners=m, quality_level=0.01, min_distance=4.0, border=13)
        same = cs.same_corners(cs.corner_select(resp, **kw), cs.corner_select_ref(resp, **kw))
        assert same["equal"] and same["accepted"] > 256, same
    assert cs.launches_corner_select == 2


@pytest.mark.gpu
def test_tracker_refuses_on_card_what_the_frame_kernels_refuse(cuda_device):
    """`EventTracker` on the card refuses at construction, before any frame,
    a Harris block other than 3, more than 3 LK levels, max_patches outside
    1 to `corner_select.MAX_CORNERS` and lk_radius outside 0 to
    `frame_rows.MAX_RADIUS`; it takes 300 patches and radius 15."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.kernels import frame_rows as fr
    from evo_tpu_torch.tracker import detector

    for bad in (dict(block_size=5), dict(lk_levels=4), dict(max_patches=cs.MAX_CORNERS + 1),
                dict(lk_radius=fr.MAX_RADIUS + 1)):
        with pytest.raises(ValueError):
            detector.EventTracker(detector.TrackerParams(**bad), device=cuda_device)
    tr = detector.EventTracker(detector.TrackerParams(capacity=512, max_patches=300,
                                                      lk_radius=15), device=cuda_device)
    assert tr.params.max_patches == 300


@pytest.mark.gpu
def test_frame_step_reads_nothing_back_on_card(cuda_device):
    """The frame part of the fused window (`detector.fused_window_core`
    without events: the maps, the corners, the device policy, the table's
    update with LK from the previous frame's pyramid and the re-budget)
    under `torch.cuda.set_sync_debug_mode("error")`: nothing synchronizes
    with the host. Each frame kernel launches once a frame."""
    from evo_tpu_torch.kernels import corner_select as cs
    from evo_tpu_torch.kernels import frame_maps as fm
    from evo_tpu_torch.kernels import frame_rows as fr
    from evo_tpu_torch.tracker import detector, policy
    from evo_tpu_torch.tracker import patch_state as ps

    img0, img1 = _frame_pair(cuda_device)
    p = detector.TrackerParams()
    table = ps.empty_table(p.capacity, device=cuda_device)
    grads = torch.zeros(p.capacity, 2, 180, 240, device=cuda_device)
    pstate = policy.empty_state(p.capacity, device=cuda_device)
    kw = dict(view_fn=lambda t: t, slice_fn=lambda a: a, lk_levels=p.lk_levels,
              lk_radius=p.lk_radius, max_corners=p.max_patches, quality_level=p.quality_level,
              min_distance=p.min_distance, block_size=p.block_size,
              border=ps.PATCH_EXTENT + 1, max_patches=p.max_patches,
              association_distance=p.association_distance)
    torch.cuda.synchronize()
    for m in (fm, cs, fr):
        m.reset_counts()
    prev = None
    torch.cuda.set_sync_debug_mode("error")
    try:
        for img in (img0, img1):
            table, pstate, _, framelog, prev = detector.fused_window_core(
                table, grads, pstate, None, img, prev, with_lk=prev is not None, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (fm.launches_frame_maps, cs.launches_corner_select, fr.launches_frame_rows) == \
        (2, 2, 2)
    alive = framelog["alive"].cpu()
    assert int(alive.sum()) >= 10 and bool(table.initialized.cpu()[alive].any())


# -- the frame policy's and the event routing's kernels ------------------------

def _same_bits(a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and a.shape == b.shape and a.numpy().tobytes() == b.numpy().tobytes()


def _policy_inputs(case, dev):
    from evo_tpu_torch.tracker import policy

    view = policy.TableView(**{k: torch.as_tensor(np.asarray(v)).to(dev)
                               for k, v in case["view"].items()})
    state = policy.PolicyState(
        slot_birth=torch.as_tensor(np.asarray(case["slot_birth"], np.int32)).to(dev),
        next_tid=torch.tensor(1000, dtype=torch.int32, device=dev),
        frame_no=torch.tensor(50, dtype=torch.int32, device=dev))
    return view, state, torch.from_numpy(case["corners"]).to(dev), \
        torch.from_numpy(case["ok"]).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(policy_cases.POLICY_CASES))
def test_frame_policy_kernel_matches_plain_on_card(cuda_device, name):
    """`policy.frame_policy` on the card (one launch of `csrc/frame_policy.cu`)
    against `frame_policy_ref` on the same card tensors and on the CPU:
    every decision and the new state bit for bit."""
    from evo_tpu_torch.kernels import frame_policy as kfp
    from evo_tpu_torch.tracker import policy

    make, kw = policy_cases.POLICY_CASES[name]
    kw = dict(dict(max_patches=100, association_distance=5.0), **kw)
    case = make()
    args = _policy_inputs(case, cuda_device)
    n = kfp.launches_frame_policy
    dec, state = policy.frame_policy(*args, **kw)
    torch.cuda.synchronize()
    assert kfp.launches_frame_policy == n + 1
    for ref_dec, ref_state in (policy.frame_policy_ref(*args, **kw),
                               policy.frame_policy_ref(*_policy_inputs(case, "cpu"), **kw)):
        for k in ref_dec:
            assert _same_bits(dec[k], ref_dec[k]), (name, k)
        for k in ("slot_birth", "next_tid", "frame_no"):
            assert _same_bits(getattr(state, k), getattr(ref_state, k)), (name, k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(policy_cases.ROUTE_CASES) + ["table_of_128"])
def test_route_events_kernel_matches_plain_on_card(cuda_device, name):
    """`patch_state.route_events` on the card (one launch of
    `csrc/route_events.cu`) against `route_events_ref` on the same card
    tensors and on the CPU: rings, ev_count and counter bit for bit; the
    input table is not written. `table_of_128`: a full table of 128 rows and
    a sub-batch of 5,000 events. `n_70000` is longer than the kernel's
    chunk of 65,536 events, so it takes the counting pass and two chunks.
    An empty sub-batch (`n_0`), which the plain version refuses, must leave
    the table as it is."""
    from evo_tpu_torch.kernels import route_events as kre
    from evo_tpu_torch.tracker import patch_state as ps

    rng = np.random.default_rng(3)
    if name == "table_of_128":
        p, n = 128, 5000
        fields = dict(alive=rng.random(p) < 0.8,
                      center=rng.uniform(10, 230, (p, 2)).astype(np.float32),
                      ev_count=rng.integers(0, 2000, p).astype(np.int32),
                      counter=rng.integers(0, 40, p).astype(np.int32),
                      **{k: rng.random((p, ps.MAX_EVENTS)).astype(np.float32)
                         for k in kre.RING})
        events = (rng.integers(0, 240, n).astype(np.float32),
                  rng.integers(0, 180, n).astype(np.float32),
                  np.sort(rng.random(n)).astype(np.float32),
                  np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32),
                  rng.random(n) < 0.95)
    else:
        fields, events = policy_cases.route_case(name, rng)

    def table_on(dev):
        t = ps.empty_table(len(fields["alive"]), device=dev)
        return t.replace(**{k: torch.from_numpy(v).to(dev) for k, v in fields.items()})

    table = table_on(cuda_device)
    ev = [torch.from_numpy(a).to(cuda_device) for a in events]
    n0 = kre.launches_route_events
    got = ps.route_events(table, *ev)
    torch.cuda.synchronize()
    assert kre.launches_route_events == n0 + 1
    refs = (ps.route_events_ref(table, *ev),
            ps.route_events_ref(table_on("cpu"), *[torch.from_numpy(a) for a in events])) \
        if len(events[0]) else (table,)
    for ref in refs:
        for k in kre.RING + ("ev_count", "counter"):
            assert _same_bits(getattr(got, k), getattr(ref, k)), (name, k)
    assert _same_bits(table.ev_t, torch.from_numpy(fields["ev_t"]))


@pytest.mark.gpu
def test_tracker_refuses_on_card_a_capacity_beyond_the_frame_policy(cuda_device):
    """`EventTracker` on the card refuses at construction a table of more
    rows than the policy kernel's block holds (`frame_policy.MAX_ROWS`), and
    takes that many."""
    from evo_tpu_torch.kernels import frame_policy as kfp
    from evo_tpu_torch.tracker import detector

    with pytest.raises(ValueError, match="the CPU takes any"):
        detector.EventTracker(detector.TrackerParams(capacity=kfp.MAX_ROWS + 1), height=8,
                              width=8, device=cuda_device)
    tr = detector.EventTracker(detector.TrackerParams(capacity=kfp.MAX_ROWS), height=8,
                               width=8, device=cuda_device)
    assert tr.table.capacity == kfp.MAX_ROWS


@pytest.mark.gpu
def test_frame_window_with_events_reads_nothing_back_on_card(cuda_device):
    """A whole fused frame window on the card (`detector.fused_window_core`
    with two sub-batches of events already on the card: routing, the
    alignment step, the frame's maps and corners, the policy and the table's
    update) under `torch.cuda.set_sync_debug_mode("error")`: nothing
    synchronizes with the host. One `route_events` launch a sub-batch, one
    `frame_policy` launch a frame."""
    from evo_tpu_torch.kernels import frame_policy as kfp
    from evo_tpu_torch.kernels import route_events as kre
    from evo_tpu_torch.tracker import detector, policy
    from evo_tpu_torch.tracker import patch_state as ps

    img0, img1 = _frame_pair(cuda_device)
    p = detector.TrackerParams()
    table = ps.empty_table(p.capacity, device=cuda_device)
    grads = torch.zeros(p.capacity, 2, 180, 240, device=cuda_device)
    pstate = policy.empty_state(p.capacity, device=cuda_device)
    kw = dict(view_fn=lambda t: t, slice_fn=lambda a: a, lk_levels=p.lk_levels,
              lk_radius=p.lk_radius, max_corners=p.max_patches, quality_level=p.quality_level,
              min_distance=p.min_distance, block_size=p.block_size,
              border=ps.PATCH_EXTENT + 1, max_patches=p.max_patches,
              association_distance=p.association_distance)
    gen = torch.Generator().manual_seed(5)
    k, c = 2, 5000
    events = (torch.randint(0, 240, (k, c), generator=gen).float().to(cuda_device),
              torch.randint(0, 180, (k, c), generator=gen).float().to(cuda_device),
              torch.sort(torch.rand(k, c, generator=gen).flatten())[0].view(k, c)
              .to(cuda_device),
              (torch.rand(k, c, generator=gen) < 0.5).float().mul(2).sub(1).to(cuda_device),
              (torch.rand(k, c, generator=gen) < 0.9).to(cuda_device))
    table, pstate, _, _, prev = detector.fused_window_core(
        table, grads, pstate, None, img0, None, with_lk=False, **kw)
    torch.cuda.synchronize()
    n_route, n_policy = kre.launches_route_events, kfp.launches_frame_policy
    torch.cuda.set_sync_debug_mode("error")
    try:
        table, pstate, stacked, framelog, prev = detector.fused_window_core(
            table, grads, pstate, events, img1, prev, with_lk=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (kre.launches_route_events - n_route, kfp.launches_frame_policy - n_policy) == (k, 1)
    assert stacked["ran"].shape[0] == k and int(framelog["alive"].sum()) >= 10
    assert int((table.ev_count > 0).sum()) >= 10


@pytest.mark.gpu
def test_frame_window_from_carried_state_on_card_matches_cpu(cuda_device):
    """`tests/test_torch_pipeline.py::test_frame_window_from_carried_state_matches_jax`'s
    decisions on the card: a tracker's state after two fused frame windows on
    the CPU is carried to a tracker on the card and to one on the CPU, and
    both process the third window (on the card its policy and routing are
    the kernels): alive, track ids, gradient slots, budgets and the policy's
    state equal, live centres within 1e-3 px."""
    from evo_tpu_torch.io import sim
    from evo_tpu_torch.io.replay import FrameWindowIterator
    from evo_tpu_torch.kernels import frame_policy as kfp
    from evo_tpu_torch.kernels import route_events as kre
    from evo_tpu_torch.tracker import detector
    from evo_tpu_torch.tracker import patch_state as ps

    ds = sim.to_dataset(sim.EventCameraSimulator(
        sim.SimParams(duration_s=0.2, fps=20.0, seed=2), device="cpu").generate())
    wins = list(FrameWindowIterator(ds))[:3]
    params = detector.TrackerParams(capacity=32)
    src = detector.EventTracker(params, device="cpu")

    def step(tr, w):
        ev = w.events
        t, h = tr.process_frame_window(
            ev.t_us, ev.x.astype(np.float64), ev.y.astype(np.float64),
            ev.p.astype(np.float64), w.image_t_us, w.image)
        return tr.consume_frame(t, h)

    for w in wins[:2]:
        step(src, w)
    runs = {}
    for dev in ("cpu", cuda_device):
        tr = detector.EventTracker(params, device=dev)
        tr.table = ps.table_from_numpy(ps.table_to_numpy(src.table), device=dev)
        tr.load_numpy_state(src.grads.numpy(), src.slot_refcount, src.slot_birth,
                            src.next_track_id, src.epoch_us,
                            pstate={k: getattr(src.pstate, k).numpy()
                                    for k in ("slot_birth", "next_tid", "frame_no")})
        tr.num_images = src.num_images
        tr.prev_image = src.prev_image.to(dev)
        tr.trajectories = {k: list(v) for k, v in src.trajectories.items()}
        tr.archived_tracks = set(src.archived_tracks)
        n = (kre.launches_route_events, kfp.launches_frame_policy)
        runs[str(dev)] = (step(tr, wins[2]), tr,
                          (kre.launches_route_events - n[0], kfp.launches_frame_policy - n[1]))
    (cm, ctr, c_launches), (gm, gtr, g_launches) = runs["cpu"], runs[str(cuda_device)]
    assert c_launches == (0, 0) and g_launches[0] >= 1 and g_launches[1] == 1
    for name in ("alive", "track_id", "grad_slot", "num_of_events"):
        np.testing.assert_array_equal(gm[name], cm[name], err_msg=name)
    for k in ("slot_birth", "next_tid", "frame_no"):
        assert _same_bits(getattr(gtr.pstate, k), getattr(ctr.pstate, k)), k
    live = cm["alive"]
    assert live.sum() >= 10
    np.testing.assert_allclose(gm["center"][live], cm["center"][live], atol=1e-3)
    assert gtr.next_track_id == ctr.next_track_id
