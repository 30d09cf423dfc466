"""VO's two kernels' sources, `evo_tpu_torch/csrc/localize.cu` (the 2D-3D
localization) and `ba_solve.cu` (the windowed BA), run on the CPU:
compiled by g++ against the stand-in CUDA headers under
`tests/cuda_emulator/` (as `tests/test_torch_comp_emulated.py` does), called
through the wrappers' own argument packing (`kernels.localize.run`,
`kernels.ba_solve.run`) with a block of 64 threads, and held to the plain
versions (`solve.ransac.localize_camera_fused_ref`, `vo.ba.ba_solve_ref`) on
the same CPU tensors; then the front end with both kernels emulated against
`evo_tpu`'s front end over 12 keyframes.

Bars. Localization (`run.time_vo.localize_agreement`, which the card's
check uses too): every P3P candidate's `valid` flag equal, and where both
are valid the candidate within 1e-4 relative (the quaternion up to its
sign), except on ill-conditioned candidates: those the plain float32 P3P
itself does not give to 1e-4 of its float64 evaluation (near-double roots
of the quartic, 1 to 4 % of them; 1 in 230 parts here); each candidate's
inlier count and the chosen index equal, except there or where a residual
lies at the threshold, within its float32 resolution (4 ulp of 1: 2e-3 of
the threshold; counted and printed); the best candidate within 1e-4; the
refined pose no farther from its float64 witness (the plain refinement in
float64 from the same start and inliers) than twice the plain version's
float32 spread about it (its refinement from the start and from 8 starts
nudged by one rounding), never less than 1e-4 (`run.time_vo.witness_bar`):
the translation is weakly held, so float32 rounding steers each trip there
and kernel and plain version part by up to 8.5e-3 here; the reselected
inliers equal the plain reselection at the kernel's pose. The closed-form Jacobian of
the kernel's refinement against forward-mode autodiff: 1e-5. BA at F 6, L
64, O 256, both `compensated` values: cost and initial cost within 1e-5
relative, poses and landmarks within 1e-4, the same trips; trips that part
need one of the plain solve's accept or stop tests within 2 % of `tol` of
its threshold (`run.time_vo.decision_ties`, printed) and hold the results
to 1e-3, the front end's bar against `evo_tpu`; the kernel no farther from
the float64 witness than twice the plain version; a NaN observation and a reduced system
that is not positive definite (a negative Huber scale) give the plain
version's rejected steps: nothing moves, the same trips. Both kernels give
the same bits when a call is repeated, when another problem ran between,
and at another block size (the BA, launched as a thread-block cluster of
`CLUSTER` blocks, in clusters of other sizes too), and the bits of their
first versions (`DIGESTS`, SHA-256s of those versions' outputs on these
problems, taken before the redesigns).

Both kernels' sources are also built in double precision (`_in_float64`)
and held to the plain versions in float64 at 1e-9: there the two compute
the same function to 1e-13, so that whatever parts them in float32 is
rounding, not a step of the algorithm.

The emulation checks the kernels' logic and arithmetic, not their speed:
g++ rounds each operation as `nvcc -fmad=false` does, but `sinf`, `cosf`
and `sqrtf` are glibc's, not CUDA's."""

import ctypes
import hashlib
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from evo_tpu_torch.core import camera, lie
from evo_tpu_torch.kernels import ba_solve as kba
from evo_tpu_torch.kernels import localize as kloc
from evo_tpu_torch.solve import p3p, ransac
from evo_tpu_torch.run.time_vo import decision_ties, localize_agreement, witness_bar
from evo_tpu_torch.solve.lm import autodiff_linearize
from evo_tpu_torch.vo import ba, frontend
from tests import test_torch_vo as tvo
from tests.torch_vo_problems import THRESHOLD as THR
from tests.torch_vo_problems import ba_problem, localize_problem

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(ba.__file__), "..", "csrc")
THREADS = 64
CLUSTER = 2  # the emulated BA's blocks: more than one, so that the cluster's paths run


def _emulated_source(src: str) -> str:
    """The source with each launch made a call of the stand-in's
    `evo_emu::launch` (a `<<<...>>>` launch) or `evo_emu::launch_ex` (a
    `cudaLaunchKernelEx`, with its cluster attribute), and its dynamic shared
    memory the block's buffer."""
    out, n = re.subn(r"(\w+)<<<(.*?)>>>\((.*?)\);",
                     r"evo_emu::launch(\2, [&] { \1(\3); });", src, flags=re.S)
    out, n_ex = re.subn(r"cudaLaunchKernelEx\(&(\w+), (\w+), (.*?)\);",
                        r"evo_emu::launch_ex(&\1, [&] { \2(\3); });", out, flags=re.S)
    assert n + n_ex == 1, "one kernel launch expected"
    out, m = re.subn(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                     r"float* \1 = reinterpret_cast<float*>(evo_emu::dynamic_smem());", out)
    assert m == 1, "one dynamic shared array expected"
    return out


def _in_float64(src: str) -> str:
    """The source with every float a double: its types, its literals and the
    float forms of the math functions."""
    src = re.sub(r"\bfloat\b", "double", src)
    src = re.sub(r"\b(sqrt|fabs|sin|cos)f\(", r"\1(", src)
    return re.sub(r"\b(\d+\.\d*(?:e[-+]?\d+)?|\d+e[-+]?\d+)f\b", r"\1", src)


def _compile(tmp, name: str, signatures: dict, float64: bool = False):
    """The kernel `name` built by g++ against the stand-in headers; with
    `float64`, its source and the shared header in double precision. The BA
    takes blocks of up to 512 threads here (EVO_BA_MAX_THREADS; the card's
    build 256, for its registers)."""
    convert = _in_float64 if float64 else (lambda text: text)
    with open(os.path.join(CSRC, name + ".cu")) as f:
        src = tmp / (name + ".cc")
        src.write_text(convert(_emulated_source(f.read())))
    with open(os.path.join(CSRC, "vo_geometry.cuh")) as f:
        (tmp / "vo_geometry.cuh").write_text(convert(f.read()))
    lib = tmp / f"lib{name}_emulated.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           "-DEVO_BA_MAX_THREADS=512", "-I", os.path.join(HERE, "cuda_emulator"), "-I", str(tmp),
           str(src), "-o", str(lib)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    handle = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in signatures.items():
        if float64:
            argtypes = [ctypes.c_double if a is ctypes.c_float else a for a in argtypes]
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = restype
    return handle


@pytest.fixture(scope="module")
def loc_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("localize"), "localize", kloc._SIGNATURES)


@pytest.fixture(scope="module")
def ba_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("ba_solve"), "ba_solve", kba._SIGNATURES)


@pytest.fixture(scope="module")
def loc64_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("localize64"), "localize", kloc._SIGNATURES, True)


@pytest.fixture(scope="module")
def ba64_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("ba_solve64"), "ba_solve", kba._SIGNATURES, True)


def ok(fn):
    """The emulated entry `fn` as a wrapper's launch: it must return 0."""
    def launch(*args):
        assert fn(*args, None) == 0

    return launch


def T(a):
    return torch.as_tensor(np.asarray(a))


def run_localize(lib, intr, pix, pts, valid, idx, threads=THREADS):
    return kloc.run(ok(lib.evo_localize), intr, pix, pts, valid, THR, idx, threads=threads)


@pytest.mark.parametrize("seed", range(8))
def test_localize_matches_plain(loc_lib, seed):
    """`run.time_vo.localize_agreement`'s bars (the module docstring's), on
    eight scenes; the degenerate sample of one point thrice has no pose."""
    intr, pix, pts, n, valid, idx = localize_problem(seed)
    got = run_localize(loc_lib, intr, pix, pts, valid, idx)
    row = localize_agreement(got, intr, pix, pts, n, valid, THR, idx)
    print(f"seed {seed}: {row}")
    assert not got.candidate_valid[4 * 9:4 * 10].any()
    assert not got.inliers[n:].any() and int(got.inliers.sum()) >= 55
    assert row["candidates_apart"] <= row["ill_conditioned"]


def test_localize_jacobian_matches_forward_mode():
    """The kernel's closed-form linearization (in plain PyTorch,
    `kernels.localize.angle_residual_jacobian`) against `jacfwd` through
    `se3_retract`: 1e-5 (entries up to ~0.3)."""
    intr, pix, pts, n, valid, idx = localize_problem(3)
    bear = camera.unproject(intr, pix)[:n]
    pose = ransac.absolute_pose_ransac(bear, pts[:n], n, threshold=THR, indices=idx)[0]
    pose = lie.se3_retract(pose, T(np.array([0.01, -0.02, 0.015, 0.003, -0.002, 0.004],
                                            np.float32)))
    lin = autodiff_linearize(lambda x: p3p.reprojection_angle_residual(x, bear, pts[:n]),
                             lie.se3_retract, 6)
    r_auto, J_auto = lin(pose[None])
    r, J = kloc.angle_residual_jacobian(lie.se3_retract(pose, torch.zeros(6)), bear, pts[:n])
    np.testing.assert_allclose(r.numpy(), r_auto[0].numpy(), atol=1e-7)
    np.testing.assert_allclose(J.numpy(), J_auto[0].numpy(), atol=1e-5)
    assert float(J_auto.abs().max()) > 0.05


def test_localize_repeats_its_bits(loc_lib):
    """The same call twice, with another problem between, and at 96 and 128
    threads: the same bits."""
    a = localize_problem(0)
    first = run_localize(loc_lib, *a[:3], a[4], a[5])
    other = localize_problem(1)
    run_localize(loc_lib, *other[:3], other[4], other[5])
    for threads in (THREADS, 96, 128):
        again = run_localize(loc_lib, *a[:3], a[4], a[5], threads=threads)
        for field in ("pose", "inliers", "best_idx", "candidates", "counts"):
            assert torch.equal(getattr(again, field), getattr(first, field)), (threads, field)


def test_localize_in_float64_is_the_plain_version_in_float64(loc64_lib):
    """The kernel's source built in double precision (`_in_float64`) against
    `localize_camera_fused_ref` in float64 on the same eight scenes: the
    refined pose within 1e-9 (6e-13 when this was written), the same best
    candidate, inliers and 10 trips. Every stage, the refinement's closed-form
    Jacobian and its LM decisions included, is the plain version's
    arithmetic, so whatever parts the float32 builds is rounding."""
    for seed in range(8):
        intr, pix, pts, n, valid, idx = localize_problem(seed)
        h = idx.shape[0]
        fout = torch.zeros(14 + 28 * h, dtype=torch.float64)
        iout = torch.zeros(3 + 8 * h, dtype=torch.int32)
        inl = torch.zeros(pix.shape[0], dtype=torch.uint8)
        args = [a.contiguous() for a in (intr.double(), pix.double(), pts.double(), valid, idx,
                                         p3p.quartic_grid(torch.float64, "cpu"))]
        assert loc64_lib.evo_localize(*[a.data_ptr() for a in args], THR, pix.shape[0], h,
                                      THREADS, fout.data_ptr(), iout.data_ptr(), inl.data_ptr(),
                                      None, None) == 0
        want, want_inl = ransac.localize_camera_fused_ref(*args[:3], n, valid, THR, indices=idx)
        bear = camera.unproject(args[0], args[1])
        best = ransac.absolute_pose_ransac(bear, args[2], n, threshold=THR, valid_mask=valid,
                                           indices=idx)[1].best_idx
        pose = fout[:7] * torch.sign((fout[:4] * want[:4]).sum())
        print(f"seed {seed}: pose {float((pose - want).abs().max()):.2e} from the plain float64")
        assert float((pose - want).abs().max()) <= 1e-9, seed
        assert torch.equal(inl.bool(), want_inl) and int(iout[0]) == int(best), seed
        assert int(iout[2 + 8 * h]) == 10, seed


# -- the BA -------------------------------------------------------------------
def emulated_ba(lib, poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed, *,
                num_iters, huber, compensated, tol, threads=THREADS, cluster=CLUSTER):
    """`vo.ba.ba_solve`'s launch of the kernel, on the emulated library."""
    orders = ba.observation_orders(obs_frame, obs_lm, poses.shape[0], landmarks.shape[0],
                                   compensated, obs_mask)
    return kba.run(lib, ok(lib.evo_ba_solve), poses, landmarks, intr, obs_frame, obs_lm, obs_p2d,
                   obs_mask, pose_fixed, orders, num_iters=num_iters, huber=huber,
                   compensated=compensated, tol=tol, threads=threads, cluster=cluster)


def run_ba(lib, args, threads=THREADS, cluster=CLUSTER, **kw):
    kw = dict(dict(num_iters=50, huber=0.8, compensated=False, tol=1e-5), **kw)
    return emulated_ba(lib, *args, threads=threads, cluster=cluster, **kw)


@pytest.mark.parametrize("compensated", [False, True])
def test_ba_matches_plain(ba_lib, compensated):
    """Where the trips agree: cost 1e-5 relative, poses and landmarks 1e-4.
    Where they part, a decision of the plain solve must lie within rounding
    (`decision_ties`, printed), and the results are held to the front end's
    bar against `evo_tpu`, 1e-3 (tests/test_torch_vo.py)."""
    args = ba_problem()
    p, x, cost, cost0, it = run_ba(ba_lib, args, compensated=compensated)
    trace = []
    wp, wx, wcost, wcost0, wit = ba.ba_solve_ref(*args, num_iters=50, compensated=compensated,
                                                 tol=1e-5, trace=trace)
    ties = decision_ties(trace, 1e-5)
    print(f"compensated {compensated}: trips {int(it)} against {wit}; costs {float(cost)!r} "
          f"against {float(wcost)!r}; the plain solve's decisions within rounding: {ties}")
    assert float(cost0) == pytest.approx(float(wcost0), rel=1e-5)
    assert float(cost) == pytest.approx(float(wcost), rel=1e-5)
    assert float(cost) < 0.2 * float(cost0)
    if int(it) != wit:
        assert ties, "the trips differ with no decision near its threshold"
    bar = 1e-3 if int(it) != wit else 1e-4
    np.testing.assert_allclose(p.numpy(), wp.numpy(), atol=bar)
    np.testing.assert_allclose(x.numpy(), wx.numpy(), atol=bar)
    assert torch.equal(p[:2], args[0][:2]) and (x[40:] == 0).all()
    # both against the float64 witness (`run.time_vo.witness_bar`)
    ep, ex, *_ = ba.ba_solve_ref(*[a.double() if a.is_floating_point() else a for a in args],
                                 num_iters=50, compensated=compensated, tol=1e-5)
    plain_w = max(float((wp - ep).abs().max()), float((wx - ex).abs().max()))
    got_w = max(float((p - ep).abs().max()), float((x - ex).abs().max()))
    assert got_w <= witness_bar(plain_w), (got_w, plain_w)


@pytest.mark.parametrize("compensated", [False, True])
def test_ba_in_float64_is_the_plain_version_in_float64(ba64_lib, compensated):
    """The kernel's source built in double precision against `ba_solve_ref`
    in float64: poses and landmarks within 1e-9 (1e-14 when this was
    written), the cost within 1e-12 relative, the same trips."""
    args = [a.double() if a.is_floating_point() else a for a in ba_problem()]
    poses, lms, intr, of, ol, op, om, fixed = args
    F, L, O = poses.shape[0], lms.shape[0], of.shape[0]
    orders = ba.observation_orders(of, ol, F, L, compensated, om)
    n_float, n_int = ctypes.c_int(), ctypes.c_int()
    ba64_lib.evo_ba_scratch(F, L, O, ctypes.byref(n_float), ctypes.byref(n_int))
    fs = torch.zeros(n_float.value, dtype=torch.float64)
    ints = torch.zeros(n_int.value, dtype=torch.int32)
    p, x = torch.zeros(F, 7, dtype=torch.float64), torch.zeros(L, 3, dtype=torch.float64)
    costs, it = torch.zeros(2, dtype=torch.float64), torch.zeros(1, dtype=torch.int32)
    ptrs = [a.data_ptr() for a in args] + [t.data_ptr() for seg in orders
                                           for t in (seg.order, seg.starts)]
    assert ba64_lib.evo_ba_solve(*ptrs, F, L, O, 50, int(compensated), 0.8, 1.6, 0.64, 1e-5,
                                 fs.data_ptr(), ints.data_ptr(), p.data_ptr(), x.data_ptr(),
                                 costs.data_ptr(), it.data_ptr(), None, THREADS, CLUSTER,
                                 None) == 0
    wp, wx, wcost, wcost0, wit = ba.ba_solve_ref(*args, num_iters=50, compensated=compensated,
                                                 tol=1e-5)
    err = max(float((p - wp).abs().max()), float((x - wx).abs().max()))
    print(f"compensated {compensated}: trips {int(it)} and {wit}, poses and landmarks {err:.2e}")
    assert int(it) == wit >= 2 and err <= 1e-9
    assert float(costs[0]) == pytest.approx(float(wcost), rel=1e-12)
    assert float(costs[1]) == pytest.approx(float(wcost0), rel=1e-12)


def test_ba_rejects_what_it_cannot_factor(ba_lib):
    """A NaN observation (the reduced system is NaN) and a negative Huber
    scale (negative weights: S has a negative pivot, all finite): every step
    is rejected, in the kernel as in the plain version, until the damping
    passes 1e6 or the trips run out; nothing moves."""
    args = ba_problem()
    nan = [a.clone() for a in args]
    nan[5][3] = float("nan")
    for a, kw in ((nan, dict(num_iters=12)), (args, dict(huber=-0.8))):
        p, x, cost, _, it = run_ba(ba_lib, a, **kw)
        wp, wx, wcost, _, wit = ba.ba_solve_ref(*a, **dict(dict(num_iters=50, tol=1e-5), **kw))
        assert int(it) == wit
        assert torch.equal(p, a[0]) and torch.equal(x, a[1])
        assert torch.equal(wp, a[0]) and torch.equal(wx, a[1])
        assert (torch.isnan(cost) and torch.isnan(wcost)) or float(cost) == pytest.approx(
            float(wcost), rel=1e-5)


@pytest.mark.parametrize("compensated", [False, True])
def test_ba_repeats_its_bits(ba_lib, compensated):
    """The same call twice, with another problem between, at 96 and 128
    threads, and in clusters of 1 and 3 blocks: the same bits."""
    args = ba_problem()
    first = run_ba(ba_lib, args, compensated=compensated)
    run_ba(ba_lib, ba_problem(seed=1), compensated=compensated)
    for threads, cluster in ((THREADS, CLUSTER), (96, CLUSTER), (128, CLUSTER), (THREADS, 1),
                             (96, 3)):
        again = run_ba(ba_lib, args, threads=threads, cluster=cluster, compensated=compensated)
        for a, b in zip(first, again):
            assert torch.equal(a, b), (threads, cluster)


# -- the bits of the kernels as first written ---------------------------------
# SHA-256 of the emulated kernels' outputs on `tests/torch_vo_problems.py`'s
# problems, taken from the first versions of both kernels (one block a
# solve). A redesign keeps every float operation and its order, so it gives
# these bits: the localization on eight scenes (every output field); the BA
# on two problems with both `compensated` values, a NaN observation and a
# negative Huber scale (poses, landmarks, costs, trips).
DIGESTS = {
    "localize": "eab41407eaf12319819c91a2d414df57bfb73ea8b33529ca23161d8cee5cbd26",
    "ba": "ac455e61acb091cfa17320e4305ab523cdc56efc5d5c5e7721f84c2ea3ca94ca",
}
LOCALIZE_FIELDS = ("pose", "inliers", "best_idx", "num_inliers", "ransac_pose", "candidates",
                   "candidate_valid", "counts", "trips")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()


def localize_digest(lib, threads=THREADS) -> str:
    outs = []
    for seed in range(8):
        intr, pix, pts, n, valid, idx = localize_problem(seed)
        got = run_localize(lib, intr, pix, pts, valid, idx, threads=threads)
        outs += [getattr(got, f) for f in LOCALIZE_FIELDS]
    return _digest(outs)


def ba_digest(lib, threads=THREADS, cluster=CLUSTER) -> str:
    launch = dict(cluster=cluster)
    outs = []
    for seed in (0, 1):
        for compensated in (False, True):
            outs += run_ba(lib, ba_problem(seed=seed), threads=threads, compensated=compensated,
                           **launch)
    nan = ba_problem()
    nan[5][3] = float("nan")
    outs += run_ba(lib, nan, threads=threads, num_iters=12, **launch)
    outs += run_ba(lib, ba_problem(), threads=threads, huber=-0.8, **launch)
    return _digest(outs)


def test_localize_keeps_its_bits(loc_lib):
    """The localization gives the bits of its first version (`DIGESTS`)."""
    assert localize_digest(loc_lib) == DIGESTS["localize"]


@pytest.mark.parametrize("threads, cluster", [(64, 1), (64, 4), (512, 1)])
def test_ba_keeps_its_bits(ba_lib, threads, cluster):
    """The BA gives the bits of its first version (`DIGESTS`), in clusters
    of 1 and 4 blocks of 64 threads and in one block of 512."""
    assert ba_digest(ba_lib, threads, cluster) == DIGESTS["ba"]


# -- the front end with both kernels ------------------------------------------
def test_frontend_with_emulated_kernels_matches_jax(loc_lib, ba_lib, monkeypatch, rng):
    """tests/test_torch_vo.py::test_frontend_matches_jax_over_12_keyframes with
    the front end's localization and BA on the emulated kernels (CPU tensors,
    the kernels' launches emulated), its bars, and one launch a solve."""
    calls = {"localize": 0, "ba": 0}

    def localize(intr, pix, points, n_valid, valid_mask, threshold, *, num_hypotheses, indices):
        calls["localize"] += 1
        out = kloc.run(ok(loc_lib.evo_localize), intr, pix, points, valid_mask, threshold,
                       indices.long(), threads=THREADS)
        return out.pose, out.inliers

    def ba_solve(*args, num_iters, huber, compensated, tol):
        calls["ba"] += 1
        return emulated_ba(ba_lib, *args, num_iters=num_iters, huber=huber,
                           compensated=compensated, tol=tol)

    monkeypatch.setattr(frontend.ransac, "localize_camera_fused", localize)
    monkeypatch.setattr(frontend.ba, "ba_solve", ba_solve)
    world = tvo._make_world(rng)
    vo, jvo = tvo._front_ends()
    gt_t = np.arange(12, dtype=np.int64) * 50_000
    gt = np.stack([tvo._camera_pose(i) for i in range(12)])
    vo.set_ground_truth(gt_t, gt)
    jvo.set_ground_truth(gt_t, gt)
    decisions = tvo._feed(vo, jvo, world, rng, range(12))
    assert all(a == b for a, b in decisions), decisions
    assert sorted(vo.active_frames) == sorted(jvo.active_frames)
    assert len(vo.active_frames) >= 11
    tvo.close(np.stack(vo.poses()), np.stack(tvo._jposes(jvo)), 1e-3)
    assert set(vo.map.landmarks) == set(jvo.map.landmarks) and len(vo.map.landmarks) > 50
    assert vo.map.observations == jvo.map.observations
    assert vo.last_ate.rmse < 0.05
    assert vo.last_ate.rmse == pytest.approx(jvo.last_ate.rmse, rel=0.05, abs=1e-3)
    assert vo.last_ate.count == jvo.last_ate.count >= 11
    tvo.close(np.stack(vo.gt_aligned), np.stack(jvo.gt_aligned), 1e-3)
    assert vo.solve_devices == {"cpu"} and len(vo.ba_log) >= 9
    assert all(1 <= it <= 50 and c <= c0 for it, c0, c, _ in vo.ba_log)
    assert calls["localize"] >= 9 and calls["ba"] == len(vo.ba_log)
