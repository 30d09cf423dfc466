"""The port's `dist/` functions (`evo_tpu_torch.dist`) in one spawned world of
4 gloo ranks on the CPU, against the JAX package's single-device functions
and, where tests/test_dist.py builds one, its sharded function on the
8-device virtual mesh (tests/conftest.py), on the same numpy inputs.

The world is started once for the whole module by the port's launcher
(`dist.multihost.launch`, a 240 s limit): its ranks run
tests/torch_dist_ranks.py, which imports no JAX, with the meshes (1, 4)
for the batch cases and (4, 1) or (2, 2) for the space cases. The results
are kept in the run's shared temporary directory, so that the test workers
that share this module's tests start one world between them.

The same world runs the integration half of `dist/`: the meshed tracker
(`EventTracker(mesh=)`, the table's 128 rows in blocks of 32 on the (2, 2)
mesh) on three frame windows of a moving square, with the policy on the
device (the sharded fused step) and on the host (the sharded window scan);
and the meshed evaluator (`EvaluatorParams(mesh=)`) on the square dataset's
first 5 frames: the synchronous drive (checkpointed at frame 3, then resumed
into a new meshed evaluator) and the default pipelined drive on (2, 2),
where the tile solve's halo exchange runs on the evo-comp thread while the
tracker gathers on the main thread, and the default drive with
`temporal_batch=2` on (1, 4). Each evaluator run is held against one
unmeshed synchronous run of the port in this process (the pipelined drive
writes the synchronous drive's artifacts, tests/test_torch_pipeline.py),
and every rank's trajectory.txt against rank 0's, byte for byte.

Tolerances are those of tests/test_dist.py: splats atol 2e-3; the tile
solve cost0 rtol 1e-5, velocities atol 5e-3, count images atol 1e-3; the
normal equations rtol 1e-4 with atol 1e-3 (Hpp, Hll) and 1e-2 (bp, bl);
patch centres atol 1e-4. The halo strips are moved, not computed: exact.
The meshed tracker (TestShardedFusedWindow): alive and track ids exact,
centres and trajectories atol 1e-3, next_track_id equal. The meshed
evaluator (TestDistributedPipeline): track ids and timestamps exact,
positions atol 0.1, the last motion field atol 5e-3, vo_trajectory atol
5e-2; with temporal batching (TestTemporalBatch) trajectory.txt identical.
The checkpoint's table: bool and integer fields exact, float fields atol
1e-3 (the centres' bar)."""

import multiprocessing
import operator
import queue
import time
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from evo_tpu.dist import halo as jhalo
from evo_tpu.dist import mesh as jmesh
from evo_tpu.dist import reduce as jreduce
from evo_tpu.dist import temporal as jtemporal
from evo_tpu.dist import tiling as jtiling
from evo_tpu.kernels.splat import splat_image as jsplat_image
from evo_tpu.tracker import align as jalign
from evo_tpu.tracker import compensate as jcomp
from evo_tpu_torch.dist import mesh as tmesh
from evo_tpu_torch.dist import multihost
from evo_tpu_torch.run import evaluator
from tests import torch_dist_ranks
from tests.torch_run_cache import once_per_run
from tests.test_run import square_dataset  # noqa: F401 (fixture)

WORLD = 4
WORLD_TIMEOUT_S = 480.0
COMP = dict(tile=20, min_events=10, max_iters=6, events_per_tile_cap=512)
# tests/test_dist.py::TestDistributedPipeline's evaluator: 5 frames of the
# square dataset, the checkpoint at frame 3
PIPELINE = dict(compensation_events=4000,
                compensate=dict(max_iters=6, events_per_tile_cap=512))
FRAMES, SPLIT = 5, 3


def _moving_lines(rng, n, t0_us, span_us, h, w, vx, vy):
    """Events of vertical lines every 6 px drifting at (vx, vy) px/ms: the
    windows of tests/test_dist.py."""
    t = np.sort(rng.uniform(t0_us, t0_us + span_us, n)).astype(np.int64)
    base_x = np.round(rng.uniform(2, w - 3, n) / 6) * 6 + rng.normal(0, 0.2, n)
    base_y = rng.uniform(2, h - 3, n)
    x = np.clip(base_x + vx * ((t - t0_us) * 1e-3), 0, w - 1)
    y = np.clip(base_y + vy * ((t - t0_us) * 1e-3), 0, h - 1)
    return x, y, t


def _ready_table():
    """The patch table of TestShardedPatchSolve (8 live patches on a row,
    120 events routed) as numpy."""
    import dataclasses

    import tests.test_tracker as tt

    table = tt.route_uniform(
        tt.empty_with_patches(centers=[(40.0 + 16 * i, 60.0) for i in range(8)]), 120)
    return {f.name: np.asarray(getattr(table, f.name)) for f in dataclasses.fields(table)}


def _grads():
    """A smooth two-slot gradient store [2, 2, 180, 240]."""
    yy, xx = np.mgrid[0:180, 0:240].astype(np.float32)
    g = np.stack([np.sin(xx / 7.0) * np.cos(yy / 9.0), np.cos(xx / 11.0) * np.sin(yy / 5.0)])
    return np.stack([g, 0.5 * g]).astype(np.float32)


def square_windows():
    """TestShardedFusedWindow's three frame windows of a moving bright square
    with events on its vertical edges: [(t_us, x, y, pol, image_t_us,
    image)]."""
    rng = np.random.default_rng(2)
    h, w = 180, 240
    out = []
    for f in range(3):
        t0 = f * 50_000
        xl = 60.0 + 0.0006 * t0
        img = np.full((h, w), 0.2, np.float32)
        img[60:121, int(xl):int(xl) + 40] = 0.85
        n = 600
        t_us = np.sort(rng.integers(t0, t0 + 49_000, n)).astype(np.int64)
        side = rng.integers(0, 2, n)
        x = np.round(np.where(side == 1, xl + 40.0, xl) + 0.0006 * (t_us - t0)
                     + rng.normal(0, 0.3, n))
        y = rng.integers(60, 121, n).astype(np.float64)
        pol = np.where(side == 1, 1.0, -1.0)
        out.append((t_us, np.clip(x, 0, w - 1), y, pol, t0 + 49_500, img))
    return out


def _cases(dataset: str) -> dict:
    cases = {}
    rng = np.random.default_rng(0)
    n = 8 * 1024
    cases["sharded_splat"] = dict(
        x=rng.uniform(0, 239, n).astype(np.float32), y=rng.uniform(0, 179, n).astype(np.float32),
        w=rng.choice([-1.0, 1.0], n).astype(np.float32))
    cases["halo_strips"] = dict(field=np.arange(32, dtype=np.float32).reshape(4, 8))
    rng = np.random.default_rng(0)
    h, wd, m = 32, 64, 512
    cases["halo_splat"] = dict(
        x=rng.uniform(3, wd - 3, m).astype(np.float32), y=rng.uniform(3, h - 3, m).astype(np.float32),
        w=rng.choice([-1.0, 1.0], m).astype(np.float32), h=h, wd=wd, halo_w=3)
    rng = np.random.default_rng(0)
    x, y, t = _moving_lines(rng, 4000, 0, 30_000, 60, 80, 0.08, -0.05)
    cases["tile_solve"] = dict(x=x, y=y, t=t, h=60, wd=80, params=COMP)
    cases["compensate_window_mesh"] = cases["tile_solve"]
    import tests.test_vo as tv

    intr, poses, pts, (of, ol, op) = tv._synthetic_ba_problem(np.random.default_rng(0))
    o = len(of)
    pad = (-o) % 8
    fixed = np.zeros(len(poses), bool)
    fixed[:2] = True
    cases["normal_equations"] = dict(
        intr=np.asarray(intr), poses=np.asarray(poses), pts=np.asarray(pts),
        of=np.concatenate([of, np.zeros(pad, np.int32)]),
        ol=np.concatenate([ol, np.zeros(pad, np.int32)]),
        op=np.concatenate([op, np.zeros((pad, 2), np.float32)]),
        om=np.concatenate([np.ones(o, bool), np.zeros(pad, bool)]), fixed=fixed)
    cases["patch_solve"] = dict(table=_ready_table(), grads=_grads())
    rng = np.random.default_rng(0)
    cases["windows_batched"] = dict(
        windows=[_moving_lines(rng, 3000, i * 40_000, 30_000, 60, 80, 0.06, -0.04)
                 for i in range(3)], h=60, wd=80, params=COMP)
    cases["placements"] = dict(x=np.arange(64, dtype=np.float32).reshape(16, 4))
    cases["fused_window"] = dict(windows=square_windows())
    cases["fused_window_host_policy"] = cases["fused_window"]
    run = dict(dataset=dataset, params=PIPELINE, frames=FRAMES)
    cases["evaluator_sync"] = dict(run, split=SPLIT)
    cases["evaluator_default"] = run
    cases["evaluator_temporal_batch"] = dict(run, extra=dict(temporal_batch=2))
    return cases


@pytest.fixture(scope="module")
def cases(square_dataset):  # noqa: F811
    return _cases(square_dataset)


@pytest.fixture(scope="module")
def world(cases, tmp_path_factory):
    """{case: [rank 0's result, ..., rank 3's]} of one world for the whole
    run (`once_per_run`)."""
    def compute():
        per_rank = multihost.launch(torch_dist_ranks.run_cases, WORLD, (cases,),
                                    device="cpu", timeout_s=WORLD_TIMEOUT_S)
        return {k: [r[k] for r in per_rank] for k in cases}

    return once_per_run(tmp_path_factory, "torch_dist_world", compute)


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.make_mesh(n_space=1, n_batch=8)


@pytest.fixture(scope="module")
def mesh_space4():
    return jmesh.make_mesh(n_space=4, n_batch=2)


def _jparams():
    return jcomp.CompensateParams(**COMP)


def test_sharded_splat_matches_jax(world, cases, mesh8):
    c = cases["sharded_splat"]
    x, y, w = (jnp.asarray(c[k]) for k in ("x", "y", "w"))
    ref = np.asarray(jsplat_image(x, y, w, 180, 240, chunk=1024))
    sharded = np.asarray(jtiling.sharded_splat(mesh8, x, y, w, 180, 240, chunk=1024))
    for got in world["sharded_splat"]:
        np.testing.assert_allclose(got, ref, atol=2e-3)
        np.testing.assert_allclose(got, sharded, atol=2e-3)


def test_exchange_halo_strips_match_jax(world, cases, mesh_space4):
    field = jnp.asarray(cases["halo_strips"]["field"])

    @partial(jax.shard_map, mesh=mesh_space4, in_specs=P(None, jmesh.SPACE_AXIS),
             out_specs=(P(None, jmesh.SPACE_AXIS), P(None, jmesh.SPACE_AXIS)))
    def run(local):
        return jhalo.exchange_halo(local, width=1, axis=1)

    ref_left, ref_right = (np.asarray(a) for a in run(field))
    got = world["halo_strips"]  # per rank: [from_left, from_right], each [4, 1]
    np.testing.assert_array_equal(np.concatenate([g[0] for g in got], 1), ref_left)
    np.testing.assert_array_equal(np.concatenate([g[1] for g in got], 1), ref_right)
    np.testing.assert_array_equal(got[0][0], 0.0)
    np.testing.assert_array_equal(got[-1][1], 0.0)


def test_halo_reduction_matches_unsharded_splat(world, cases):
    c = cases["halo_splat"]
    ref = np.asarray(jsplat_image(jnp.asarray(c["x"]), jnp.asarray(c["y"]), jnp.asarray(c["w"]),
                                  c["h"], c["wd"], mode="gaussian", chunk=128))
    got = np.concatenate(world["halo_splat"], axis=1)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=2e-3)


def _jax_window(c, mesh=None):
    return jcomp.compensate_window(c["x"], c["y"], c["t"], _jparams(), height=c["h"],
                                   width=c["wd"], mesh=mesh)


def test_sharded_tile_solve_matches_jax(world, cases):
    c = cases["tile_solve"]
    v_ref, _, _, c0_ref = _jax_window(c)
    for got in world["tile_solve"]:
        assert np.isfinite(got["cost"]) and got["cost"] <= got["cost0"] + 1e-3
        np.testing.assert_allclose(got["cost0"], c0_ref, rtol=1e-5)
        np.testing.assert_allclose(got["vel"].reshape(v_ref.shape), v_ref, atol=5e-3)
        np.testing.assert_array_equal(got["vel"], world["tile_solve"][0]["vel"])


def test_compensate_window_on_a_mesh_matches_jax(world, cases, mesh_space4):
    c = cases["compensate_window_mesh"]
    single = _jax_window(c)
    sharded = _jax_window(c, mesh_space4)
    for ref in (single, sharded):
        v_ref, img_ref, _, c0_ref = ref
        for got in world["compensate_window_mesh"]:
            np.testing.assert_allclose(got["cost0"], c0_ref, rtol=1e-5)
            np.testing.assert_allclose(got["vel"], v_ref, atol=5e-3)
            np.testing.assert_allclose(got["img"], img_ref, atol=1e-3)


def test_sharded_normal_equations_match_jax(world, cases, mesh8):
    c = cases["normal_equations"]
    args = (jnp.asarray(c["poses"]), jnp.asarray(c["pts"]), jnp.asarray(c["intr"]),
            *(jnp.asarray(c[k]) for k in ("of", "ol", "op", "om", "fixed")))
    mesh1 = jmesh.make_mesh(n_space=1, n_batch=1, devices=jax.devices()[:1])
    for m in (mesh8, mesh1):
        ref = [np.asarray(a) for a in jreduce.sharded_normal_equations(m, *args)]
        for got in world["normal_equations"]:
            for name, g, r, atol in zip(("Hpp", "Hll", "A", "bp", "bl"), got, ref,
                                        (1e-3, 1e-3, 1e-3, 1e-2, 1e-2)):
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=atol, err_msg=name)


def test_sharded_patch_solve_matches_jax(world, cases, mesh8):
    from evo_tpu.tracker.patch_state import PatchTable

    c = cases["patch_solve"]
    table = PatchTable(**{k: jnp.asarray(v) for k, v in c["table"].items()})
    grads = jnp.asarray(c["grads"])
    ref_table, _ = jalign.optimize_ready_patches(table, grads)
    ref = np.asarray(ref_table.center)
    assert np.abs(ref[:8] - c["table"]["center"][:8]).max() > 1e-3  # the solves moved them
    for got in world["patch_solve"]:
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_compensate_windows_batched_on_a_mesh_matches_jax(world, cases, mesh8):
    c = cases["windows_batched"]
    p = _jparams()
    sharded = jtemporal.compensate_windows_batched(c["windows"], p, height=c["h"],
                                                   width=c["wd"], mesh=mesh8)
    for i, (x, y, t) in enumerate(c["windows"]):
        for v_ref, img_ref, _, c0_ref in (
                jcomp.compensate_window(x, y, t, p, height=c["h"], width=c["wd"]), sharded[i]):
            for got in world["windows_batched"]:
                np.testing.assert_allclose(got[i]["cost0"], c0_ref, rtol=1e-5)
                np.testing.assert_allclose(got[i]["vel"], v_ref, atol=5e-3)
                np.testing.assert_allclose(got[i]["img"], img_ref, atol=1e-3)


def test_placements_split_as_the_blocks_do(world, cases):
    """On the (2, 2) mesh (rank = 2·space + batch, row-major as JAX's
    `devices.reshape`), `batch_sharded` gives each rank the rows of its
    `block` over ``batch``, `space_sharded(axis=1)` its columns over
    ``space``, and `replicated` the whole tensor: exact."""
    x = cases["placements"]["x"]
    for rank, (full, rows, cols) in enumerate(world["placements"]):
        space, batch = divmod(rank, 2)
        np.testing.assert_array_equal(full, x)
        np.testing.assert_array_equal(rows, x[8 * batch: 8 * batch + 8])
        np.testing.assert_array_equal(cols, x[:, 2 * space: 2 * space + 2])


def test_mesh_without_a_process_group_raises():
    """No silent unsharded run: without an initialised group the mesh, and so
    every sharded function, refuses."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(1, 1)


@pytest.mark.parametrize("params", [{}, {"pipelined": False, "temporal_batch": 2}],
                         ids=["pipelined", "temporal_batch"])
def test_evaluator_refuses_the_comp_thread_over_nccl_ranks(monkeypatch, params):
    """Over more than one NCCL rank the evaluator refuses compensation on the
    evo-comp thread, whose collectives would run beside the tracker's on
    another communicator (NCCL documents that this can deadlock); it raises
    before it creates a process group."""
    monkeypatch.setattr(evaluator.dist, "get_backend", lambda group=None: "nccl")
    mesh = types.SimpleNamespace(get_group=lambda dim: None, mesh=torch.zeros(1, 2))
    with pytest.raises(ValueError, match="2 NCCL ranks runs compensation on the main thread"):
        evaluator.Evaluator(types.SimpleNamespace(calib=None),
                            evaluator.EvaluatorParams(mesh=mesh, **params), device="cpu")


@pytest.mark.parametrize("backend, n_ranks, comp_on_worker",
                         [("gloo", 4, True), ("nccl", 1, True), ("nccl", 4, False)])
def test_comp_thread_runs_on_gloo_or_one_nccl_rank(backend, n_ranks, comp_on_worker):
    evaluator._check_collective_threads(backend, n_ranks, comp_on_worker)


def test_launcher_defaults_to_the_card(monkeypatch):
    """Without `device` the launcher asks for the card when there is one, and
    under NCCL (its backend there) refuses more ranks than cards instead of
    falling back to the CPU; nothing is spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need a card each, and 1 are visible"):
        multihost.launch(torch_dist_ranks.fail_on_rank_one, 2, timeout_s=10.0)


def test_launcher_raises_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        multihost.launch(torch_dist_ranks.fail_on_rank_one, 2, device="cpu",
                         timeout_s=120.0)


class _LateReports:
    """The launcher's result queue, whose first `get` holds back every report
    up to a failed rank's, waits until that rank has exited, and then times
    out: the order in which a loaded host can deliver a failure. Later
    `get`s hand the held reports over first. The ranks get the queue itself."""

    def __init__(self, q):
        self._q, self._held, self._first = q, [], True

    def get(self, timeout=None):
        if self._first:
            self._first = False
            while not self._held or self._held[-1][1]:
                self._held.append(self._q.get(timeout=60.0))
            name = f"evo-rank-{self._held[-1][0]}"
            while any(p.name == name for p in multiprocessing.active_children()):
                time.sleep(0.05)
            raise queue.Empty
        if self._held:
            return self._held.pop(0)
        return self._q.get(timeout=timeout)

    def __reduce__(self):  # a rank unpickles the queue itself
        return operator.itemgetter(0), ([self._q],)

    def __getattr__(self, name):
        return getattr(self._q, name)


def test_launcher_reads_a_failed_ranks_report_after_its_exit(monkeypatch):
    """A rank reports its traceback and exits before the launcher's wait on
    the queue ends empty: the launcher still raises with the traceback, not
    with "exited ... and no result"."""
    spawn = multihost.mp.get_context("spawn")
    ctx = types.SimpleNamespace(Process=spawn.Process,
                                Queue=lambda: _LateReports(spawn.Queue()))
    monkeypatch.setattr(multihost.mp, "get_context", lambda method: ctx)
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank 1 fails"):
        multihost.launch(torch_dist_ranks.fail_on_rank_one, 2, device="cpu",
                         timeout_s=120.0)


def test_launcher_kills_a_hung_world_at_its_limit():
    with pytest.raises(TimeoutError, match="did not finish"):
        multihost.launch(torch_dist_ranks.sleep_forever, 2, device="cpu", timeout_s=4.0)


# -- the integration half: the meshed tracker and evaluator ---------------
def _assert_same_tracking(got_mirrors, got_traj, got_next, ref_mirrors, ref_traj, ref_next):
    """TestShardedFusedWindow's bars."""
    assert len(got_mirrors) == len(ref_mirrors)
    for a, b in zip(ref_mirrors, got_mirrors):
        np.testing.assert_array_equal(np.asarray(a["alive"]), b["alive"])
        np.testing.assert_array_equal(np.asarray(a["track_id"]), b["track_id"])
        np.testing.assert_allclose(b["center"], np.asarray(a["center"]), atol=1e-3)
    assert set(got_traj) == set(ref_traj)
    assert got_next == ref_next
    for tid, traj in ref_traj.items():
        np.testing.assert_allclose(np.asarray(got_traj[tid], np.float64),
                                   np.asarray(traj, np.float64), atol=1e-3)


def _assert_same_tracking_up_to_ties(got_mirrors, got_traj, got_next, ref_mirrors, ref_traj,
                                     ref_next):
    """The same bars against `evo_tpu`, up to the order of tied corners: the
    square's four corners have Harris responses equal to 4e-7 relative, and
    the two packages' float32 sums rank them differently, so a new track
    takes another corner of the square (and, once tracks die, another row)
    in each package. Per frame the live rows' count and centres (as a set,
    atol 1e-3); the tracks one-to-one, each trajectory within 1e-3 of its
    partner's; next_track_id equal."""
    assert len(got_mirrors) == len(ref_mirrors)
    for a, b in zip(ref_mirrors, got_mirrors):
        ca = np.asarray(a["center"])[np.asarray(a["alive"])]
        cb = b["center"][b["alive"]]
        assert len(ca) == len(cb)
        np.testing.assert_allclose(cb[np.lexsort(cb.T[::-1])], ca[np.lexsort(ca.T[::-1])],
                                   atol=1e-3)
    assert got_next == ref_next and len(got_traj) == len(ref_traj)
    left = [np.asarray(t, np.float64) for t in ref_traj.values()]
    for traj in got_traj.values():
        t = np.asarray(traj, np.float64)
        match = [i for i, r in enumerate(left)
                 if r.shape == t.shape and np.allclose(t, r, rtol=0, atol=1e-3)]
        assert match, f"no evo_tpu track matches {t[:2]}"
        left.pop(match[0])


def _port_tracker(windows, device_policy):
    from evo_tpu_torch.tracker.detector import EventTracker, TrackerParams

    tr = EventTracker(TrackerParams(device_policy=device_policy, sub_batch_events=256),
                      180, 240, device="cpu")
    mirrors, traj = torch_dist_ranks.run_tracker(tr, windows)
    return mirrors, traj, tr.next_track_id


def jax_trackers(windows) -> list:
    """`evo_tpu`'s unmeshed and (4, 2)-meshed trackers with the device policy
    on `windows`: [(mirrors, trajectories, next_track_id)], as numpy."""
    import tests.conftest  # noqa: F401 (the suite's JAX settings, in a new process)
    from evo_tpu.tracker.detector import EventTracker as JTracker
    from evo_tpu.tracker.detector import TrackerParams as JParams

    refs = []
    for m in (None, jmesh.make_mesh(n_space=4, n_batch=2)):
        jt = JTracker(JParams(device_policy=True, sub_batch_events=256), 180, 240, mesh=m)
        mirrors, traj = torch_dist_ranks.run_tracker(jt, windows)
        refs.append(([{k: np.asarray(v) for k, v in mr.items()} for mr in mirrors], traj,
                     jt.next_track_id))
    return refs


def test_sharded_fused_window_matches_jax(world, cases):
    """The port's sharded fused step (device policy on the gathered view,
    each rank applying its block of the decisions) against the port's
    unmeshed tracker, and against `evo_tpu`'s unmeshed and (4, 2)-meshed
    tracker up to the order of tied corners."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    windows = cases["fused_window"]["windows"]
    port = _port_tracker(windows, True)
    # XLA keeps every executable it loads mapped, and a test worker that has
    # run many JAX tests is near the kernel's 65,530 memory maps; these two
    # trackers add ~6,400, so they run in a process of their own
    with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
        jax_refs = pool.submit(jax_trackers, windows).result(timeout=600)
    assert len(port[1]) >= 4
    for got in world["fused_window"]:
        assert got["table_rows"] == 32
        _assert_same_tracking(got["mirrors"], got["trajectories"], got["next_track_id"], *port)
        for ref in jax_refs:
            _assert_same_tracking_up_to_ties(got["mirrors"], got["trajectories"],
                                             got["next_track_id"], *ref)


def test_sharded_window_scan_host_policy_matches_unmeshed(world, cases):
    """The host-policy frame window on the mesh (the sharded window scan,
    the host policy on the gathered mirror, each rank updating its rows)
    against the port's unmeshed host-policy tracker and against the meshed
    device policy; `evo_tpu` has no test of this case."""
    windows = cases["fused_window_host_policy"]["windows"]
    ref = _port_tracker(windows, False)
    for got, fused in zip(world["fused_window_host_policy"], world["fused_window"]):
        assert got["table_rows"] == 32
        _assert_same_tracking(got["mirrors"], got["trajectories"], got["next_track_id"], *ref)
        _assert_same_tracking(got["mirrors"], got["trajectories"], got["next_track_id"],
                              fused["mirrors"], fused["trajectories"], fused["next_track_id"])


@pytest.fixture(scope="module")
def unmeshed(square_dataset, tmp_path_factory):  # noqa: F811
    """The port's unmeshed synchronous run of the meshed cases, once for the
    run (`once_per_run`): its table at frame SPLIT (`state_dict`) and its
    artifacts at frame FRAMES."""
    from evo_tpu_torch.io.davis import Davis240cDataset
    from evo_tpu_torch.run import checkpoint
    from evo_tpu_torch.run.evaluator import Evaluator

    def compute():
        torch.set_num_threads(1)
        case = dict(dataset=square_dataset, params=PIPELINE)
        ev = Evaluator(Davis240cDataset(square_dataset),
                       torch_dist_ranks.evaluator_params(case, pipelined=False), device="cpu")
        ev.run(max_frames=SPLIT)
        table = {k[6:]: v for k, v in checkpoint.state_dict(ev).items()
                 if k.startswith("table.")}
        ev.run(max_frames=FRAMES, start_frame=SPLIT)
        return dict(torch_dist_ranks.finish_run(ev), state_table=table)

    return once_per_run(tmp_path_factory, "torch_dist_unmeshed", compute)


def _parse(traj: bytes) -> np.ndarray:
    return np.loadtxt(traj.decode().splitlines(), ndmin=2)


def _assert_same_artifacts(got, ref):
    """TestDistributedPipeline's bars: track ids and timestamps exact,
    positions atol 0.1, the last motion field atol 5e-3, VO atol 5e-2."""
    a, b = _parse(ref["trajectory"]), _parse(got["trajectory"])
    assert a.shape == b.shape and len(a) > 50
    np.testing.assert_array_equal(b[:, :2], a[:, :2])
    np.testing.assert_allclose(b[:, 2:], a[:, 2:], atol=0.1)
    np.testing.assert_allclose(got["motion_field"], ref["motion_field"], atol=5e-3)
    assert got["compensation_windows"] == ref["compensation_windows"] > 0
    assert ref["vo"] is not None and got["vo"].shape == ref["vo"].shape
    np.testing.assert_allclose(got["vo"], ref["vo"], atol=5e-2)


@pytest.mark.parametrize("case", ["evaluator_sync", "evaluator_default"])
def test_meshed_evaluator_matches_unmeshed(world, unmeshed, case):
    """`EvaluatorParams(mesh=)` on (2, 2) on the synchronous and the default
    pipelined drive: the unmeshed run's artifacts, every rank's
    trajectory.txt byte-identical to rank 0's, each rank holding 32 rows."""
    ranks = world[case]
    for got in ranks:
        assert got["table_rows"] == 32 and got["device"] == "cpu"
        assert got["trajectory"] == ranks[0]["trajectory"]
        _assert_same_artifacts(got, unmeshed)


def test_meshed_temporal_batch_writes_the_same_trajectory(world, unmeshed):
    """The default drive with `temporal_batch=2` on (1, 4), the windows of a
    batch split over ``batch``: trajectory.txt identical to the unmeshed
    per-window run's, on every rank (tests/test_dist.py::TestTemporalBatch's
    bar); as many windows solved."""
    for got in world["evaluator_temporal_batch"]:
        assert got["table_rows"] == 32
        assert got["trajectory"] == unmeshed["trajectory"]
        assert got["compensation_windows"] == unmeshed["compensation_windows"]
        assert np.isfinite(got["motion_field"]).all()


def test_meshed_checkpoint_holds_the_global_table(world, unmeshed):
    """A meshed run's `state_dict` holds the whole table (every rank's block
    in block order), the unmeshed run's at the same frame; restored into a
    new meshed evaluator it resumes to the uninterrupted run's
    trajectory.txt."""
    ref = unmeshed["state_table"]
    assert ref["alive"].sum() >= 4
    for got in world["evaluator_sync"]:
        table = got["state_table"]
        assert table.keys() == ref.keys()
        for k, v in ref.items():
            assert table[k].shape == v.shape and table[k].dtype == v.dtype, k
            if v.dtype.kind == "f":
                np.testing.assert_allclose(table[k], v, atol=1e-3, err_msg=k)
            else:
                np.testing.assert_array_equal(table[k], v, err_msg=k)
        assert got["resumed"]["trajectory"] == got["trajectory"]
        assert got["resumed"]["table_rows"] == 32
