"""The rank side of tests/test_torch_dist.py: `run_cases` runs in each rank
of a spawned gloo world (`evo_tpu_torch.dist.multihost.launch`) and returns
its results as numpy arrays (and, for the evaluator runs, the bytes of
trajectory.txt). It imports the port only, never JAX, and nothing of tests/
besides itself (a rank imports it anew)."""

import shutil
import tempfile

import numpy as np
import torch

from evo_tpu_torch.dist import halo, mesh, reduce, temporal, tiling
from evo_tpu_torch.kernels.splat import splat_image
from evo_tpu_torch.tracker import align, compensate
from evo_tpu_torch.tracker import patch_state as ps

CPU = "cpu"


def _splat(m, case):
    return tiling.sharded_splat(m, case["x"], case["y"], case["w"], 180, 240,
                                device=CPU).numpy()


def _halo_strips(m, case):
    field = torch.from_numpy(case["field"])
    local = tiling.space_shard_tiles(m, field)
    from_left, from_right = halo.exchange_halo(m, local, width=1, axis=1)
    return np.stack([from_left.numpy(), from_right.numpy()])


def _halo_splat(m, case):
    """Each rank splats the events it owns into its column block padded by
    the halo, then folds the margins into its neighbours."""
    x, y, w, h, wd, halo_w = (case[k] for k in ("x", "y", "w", "h", "wd", "halo_w"))
    n = mesh.axis_size(m, mesh.SPACE_AXIS)
    k = mesh.axis_index(m, mesh.SPACE_AXIS)
    wloc = wd // n
    owner = np.clip((x // wloc).astype(np.int64), 0, n - 1)
    local = splat_image(torch.from_numpy(x - k * wloc + halo_w), torch.from_numpy(y),
                        torch.from_numpy(w * (owner == k).astype(np.float32)),
                        int(h), wloc + 2 * int(halo_w), mode="gaussian")
    return halo.splat_with_halo_reduction(m, local, halo_width=int(halo_w), axis=1).numpy()


def _params(case):
    return compensate.CompensateParams(**case["params"])


def _tile_solve(m, case):
    p, h, wd = _params(case), int(case["h"]), int(case["wd"])
    data, _, ty, tx, _, _ = compensate.build_tile_data(
        case["x"], case["y"], case["t"], p, h, wd, device=CPU)
    vel, cost, cost0 = tiling.sharded_tile_solve_data(
        m, data, ty=ty, tx=tx, tile=p.tile, scale=p.scale, tv_weight=p.tv_weight,
        tv_huber=p.tv_huber, max_iters=p.max_iters, loss=p.loss)
    return dict(vel=vel.numpy(), cost=float(cost), cost0=float(cost0))


def _compensate_window(m, case):
    vel, img, cost, cost0 = compensate.compensate_window(
        case["x"], case["y"], case["t"], _params(case), int(case["h"]), int(case["wd"]),
        device=CPU, mesh=m)
    return dict(vel=vel, img=img, cost=cost, cost0=cost0)


def _normal_equations(m, case):
    out = reduce.sharded_normal_equations(
        m, case["poses"], case["pts"], case["intr"], case["of"], case["ol"], case["op"],
        case["om"], case["fixed"], device=CPU)
    return [a.numpy() for a in out]


def _patch_solve(m, case):
    table = ps.table_from_numpy(case["table"], device=CPU)

    def solve_fn(tbl, g):
        return align.optimize_ready_patches(tbl, g)[0].center

    return tiling.sharded_patch_solve(m, solve_fn, table, torch.from_numpy(case["grads"])).numpy()


def _windows_batched(m, case):
    out = temporal.compensate_windows_batched(
        case["windows"], _params(case), int(case["h"]), int(case["wd"]), mesh=m, device=CPU)
    return [dict(vel=v, img=i, cost=c, cost0=c0) for v, i, c, c0 in out]


def _placements(m, case):
    """Each rank's part of a tensor distributed with the mesh's placements."""
    from torch.distributed.tensor import distribute_tensor

    x = torch.from_numpy(case["x"])
    return [distribute_tensor(x, m, place).to_local().numpy()
            for place in (mesh.replicated(m), mesh.batch_sharded(m, 0),
                          mesh.space_sharded(m, 1))]


def run_tracker(tr, windows) -> tuple[list, dict]:
    """Feed `windows` [(t_us, x, y, pol, image_t_us, image)] through
    `process_frame_window`, consuming each handle one window later, as the
    pipelined drive does. Returns the post-frame mirrors and the
    trajectories."""
    mirrors, pending = [], None
    for t_us, x, y, pol, img_t, img in windows:
        if pending is not None:
            mirrors.append(tr.consume_frame(*pending))
        pending = tr.process_frame_window(t_us, x, y, pol, img_t, img)
    mirrors.append(tr.consume_frame(*pending))
    return mirrors, tr.trajectories


def _fused_window(m, case, device_policy=True):
    from evo_tpu_torch.tracker.detector import EventTracker, TrackerParams

    tr = EventTracker(TrackerParams(device_policy=device_policy, sub_batch_events=256),
                      180, 240, device=CPU, mesh=m)
    mirrors, trajectories = run_tracker(tr, case["windows"])
    return dict(mirrors=[{k: mr[k] for k in ("alive", "track_id", "center")}
                         for mr in mirrors],
                trajectories=trajectories, next_track_id=tr.next_track_id,
                table_rows=tr.table.capacity)


def evaluator_params(case, **kw):
    """The evaluator parameters of tests/test_dist.py::TestDistributedPipeline
    (case["params"]: compensation_events and CompensateParams' fields)."""
    from evo_tpu_torch.run.evaluator import EvaluatorParams
    from evo_tpu_torch.tracker.compensate import CompensateParams

    p = dict(case["params"])
    comp = CompensateParams(**p.pop("compensate"))
    return EvaluatorParams(output_dir=tempfile.mkdtemp(prefix="evo_rank_"), compensate=comp,
                           **p, **kw)


def finish_run(ev) -> dict:
    """Write the artifacts: trajectory.txt's bytes, the VO poses, the last
    motion field, and what ran where."""
    paths = ev.finish()
    with open(paths["trajectory"], "rb") as f:
        traj = f.read()
    vo = np.loadtxt(paths["vo_trajectory"], ndmin=2) if "vo_trajectory" in paths else None
    shutil.rmtree(ev.output_dir)
    return dict(trajectory=traj, vo=vo, motion_field=ev.motion_field,
                compensation_windows=int(ev.counters.counts["compensation_windows"]),
                table_rows=ev.tracker.table.capacity, device=str(ev.device))


def _evaluator_sync(m, case):
    """The synchronous drive on the mesh, checkpointed at frame `split`:
    the state there, the uninterrupted run's artifacts, and a new meshed
    evaluator resumed from the checkpoint."""
    from evo_tpu_torch.io.davis import Davis240cDataset
    from evo_tpu_torch.run import checkpoint
    from evo_tpu_torch.run.evaluator import Evaluator

    ds = Davis240cDataset(case["dataset"])
    ev = Evaluator(ds, evaluator_params(case, pipelined=False, mesh=m), device=CPU)
    ev.run(max_frames=case["split"])
    state = checkpoint.state_dict(ev)
    ev.run(max_frames=case["frames"], start_frame=case["split"])
    out = finish_run(ev)
    resumed = checkpoint.restore_into(
        Evaluator(ds, evaluator_params(case, pipelined=False, mesh=m), device=CPU), state)
    resumed.run(max_frames=case["frames"], start_frame=resumed.image_num)
    out["resumed"] = finish_run(resumed)
    out["state_table"] = {k[6:]: v for k, v in state.items() if k.startswith("table.")}
    return out


def _evaluator_default(m, case):
    """The default (pipelined) drive on the mesh: compensation on the
    evo-comp thread on its own process groups, the tracker's collectives on
    the main thread."""
    from evo_tpu_torch.io.davis import Davis240cDataset
    from evo_tpu_torch.run.evaluator import Evaluator

    ev = Evaluator(Davis240cDataset(case["dataset"]),
                   evaluator_params(case, mesh=m, **case.get("extra", {})), device=CPU)
    ev.run(max_frames=case["frames"])
    return finish_run(ev)


CASES = {
    # name: (mesh (n_space, n_batch), function)
    "sharded_splat": ((1, 4), _splat),
    "halo_strips": ((4, 1), _halo_strips),
    "halo_splat": ((4, 1), _halo_splat),
    "tile_solve": ((4, 1), _tile_solve),
    "compensate_window_mesh": ((2, 2), _compensate_window),
    "normal_equations": ((1, 4), _normal_equations),
    "patch_solve": ((1, 4), _patch_solve),
    "windows_batched": ((1, 4), _windows_batched),
    "placements": ((2, 2), _placements),
    "fused_window": ((2, 2), _fused_window),
    "fused_window_host_policy": ((2, 2), lambda m, c: _fused_window(m, c, False)),
    "evaluator_sync": ((2, 2), _evaluator_sync),
    "evaluator_default": ((2, 2), _evaluator_default),
    "evaluator_temporal_batch": ((1, 4), _evaluator_default),
}


def run_cases(cases: dict) -> dict:
    """Every case of `cases` ({name: inputs}) on its mesh; {name: result}."""
    torch.set_num_threads(1)
    meshes = {}
    out = {}
    for name, inputs in cases.items():
        shape, fn = CASES[name]
        if shape not in meshes:
            meshes[shape] = mesh.make_mesh(*shape)
        out[name] = fn(meshes[shape], inputs)
    return out


def sleep_forever():
    import time

    while True:
        time.sleep(1.0)


def fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    return dist.get_rank()
