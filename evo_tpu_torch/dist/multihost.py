"""Process-group set-up, a launcher of local ranks, the cross-process parity
check and the scaling measurements — counterpart of
`evo_tpu/dist/multihost.py`.

Each process of a multi-process run calls `initialize()`, which reads its
place in the world from its arguments or from EVO_COORD / EVO_NUM_PROCS /
EVO_PROC_ID and initialises the default `torch.distributed` process group:
NCCL when the ranks compute on cards, gloo on the CPU. Then it builds the
(space, batch) mesh (`dist.mesh.make_mesh`) and hands it to the evaluator
(`EvaluatorParams(mesh=...)`):

    EVO_COORD=host0:8476 EVO_NUM_PROCS=2 EVO_PROC_ID=$i python prog.py

`launch` starts `n_procs` such ranks on this host (spawned processes, a
`file://` rendezvous in a new temporary directory, so no port is probed
and none can be taken in between), runs a module-level worker function in
each and returns what each returned, or raises when one fails or the
wall-clock limit passes (every rank is then killed).

`parity_worker` (the JAX package's `_mp_worker`) runs the sharded decode and
the sharded window scan across the ranks of a world against the one-rank
computation. `measure_scaling` and `measure_scaling_pipeline` time the
sharded decode, window scan and tile solve over several rank counts in one
launched world (the JAX package loops over device counts in one process);
`write_scaling_artifact` runs all three in one world and writes them where
its caller says, never to SCALING.json, which holds `evo_tpu`'s numbers:

    python -m evo_tpu_torch.dist.multihost OUT.json [--counts 1 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from evo_tpu_torch.core.device import resolve
from evo_tpu_torch.dist import mesh as dmesh


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None, *,
               backend: str | None = None, timeout_s: float = 300.0) -> bool:
    """Initialise the default process group from the arguments or the
    EVO_COORD / EVO_NUM_PROCS / EVO_PROC_ID environment variables. No
    coordinator: a single-process run, nothing is done (returns False).

    coordinator: "host:port" (TCP) or a URL (`tcp://...`, `file://...`).
    device: where the ranks compute (None: the card when there is one); on a
    card each rank takes card `process_id % count`. backend None: "nccl" on
    the card, "gloo" on the CPU. Collectives that wait longer than
    `timeout_s` fail."""
    coordinator = coordinator or os.environ.get("EVO_COORD")
    if coordinator is None:
        return False
    num_processes = num_processes or int(os.environ.get("EVO_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("EVO_PROC_ID", "0"))
    dev = resolve(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=coordinator if "://" in coordinator else f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _rank_main(worker, args_path, init_method, n_procs, rank, device, backend,
               timeout_s, results) -> None:
    """One spawned rank: initialise, run `worker(*args)` with the arguments
    the launcher pickled to `args_path`, report (rank, ok, result or
    traceback) on `results`."""
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        initialize(init_method, n_procs, rank, device, backend=backend, timeout_s=timeout_s)
        try:
            out = worker(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch(worker, n_procs: int = 2, args: tuple = (), *, device=None,
           backend: str | None = None, timeout_s: float = 300.0) -> list:
    """Run `worker(*args)` in `n_procs` spawned ranks of one process group and
    return their results in rank order.

    worker: a module-level function (pickled by its import path), run after
    `initialize` in each rank; its result must pickle. device, backend: as
    `initialize` takes them, for every rank (device None: the card when
    there is one, rank r on card r % count). Under NCCL each rank needs a
    card of its own, so more ranks than cards raise. Raises RuntimeError
    with the traceback when a rank fails, and TimeoutError when not every
    rank has reported within `timeout_s` seconds; either way every rank is
    killed."""
    dev = resolve(device)
    if dev.type == "cuda" and (backend or "nccl") == "nccl" \
            and n_procs > torch.cuda.device_count():
        raise ValueError(f"{n_procs} NCCL ranks need a card each, and "
                         f"{torch.cuda.device_count()} are visible")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="evo_dist_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    # the arguments go through a file: `Process.start` writes what it pickles
    # into a pipe and blocks on a large write if the rank dies before reading
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"evo-rank-{r}", daemon=True,
                         args=(worker, args_path, init_method, n_procs, r, dev.type, backend,
                               timeout_s, results))
             for r in range(n_procs)]
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while len(out) < n_procs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(n_procs)) - set(out))} did "
                                   f"not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                # a rank puts its report on the queue before it exits, so a
                # dead rank's report may have arrived since the wait ended
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            if p.pid is not None:
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n_procs)]


# -- the parity check and the scaling measurements ----------------------------
def _ready_table(rng, cap: int, height: int, width: int) -> dict:
    """A patch table (numpy, by field) with every row alive, initialised and
    ready (a full event ring, the counter past READY_COUNTER): the heaviest
    solve load for the window scan."""
    from evo_tpu_torch.tracker import patch_state as ps

    t = ps.table_to_numpy(ps.empty_table(cap, device="cpu"))
    e = t["ev_t"].shape[1]
    cx = rng.uniform(40, width - 40, cap).astype(np.float32)
    cy = rng.uniform(40, height - 40, cap).astype(np.float32)
    center = np.stack([cx, cy], axis=-1)
    t.update(
        alive=np.ones(cap, bool), initialized=np.ones(cap, bool),
        track_id=np.arange(cap, dtype=np.int32), center=center, init_pt=center.copy(),
        num_of_events=np.full(cap, ps.MIN_NUM_EVENTS, np.int32),
        counter=np.full(cap, ps.READY_COUNTER + 5, np.int32),
        ev_t=np.sort(rng.uniform(0, 0.05, (cap, e)), axis=1).astype(np.float32),
        ev_x=np.round(cx[:, None] + rng.uniform(-10, 10, (cap, e))).astype(np.float32),
        ev_y=np.round(cy[:, None] + rng.uniform(-10, 10, (cap, e))).astype(np.float32),
        ev_p=rng.choice([-1.0, 1.0], (cap, e)).astype(np.float32),
        ev_count=np.full(cap, e, np.int32),
        grad_slot=(np.arange(cap) % 4).astype(np.int32),
    )
    return t


def _scan_inputs(rng, k: int, c: int, height: int, width: int):
    """One window of k sub-batches of c events and a 4-slot gradient store."""
    ex = rng.uniform(0, width - 1, (k, c)).astype(np.float32)
    ey = rng.uniform(0, height - 1, (k, c)).astype(np.float32)
    et = np.sort(rng.uniform(0, 0.05, (k, c)), axis=1).astype(np.float32)
    ep = rng.choice([-1.0, 1.0], (k, c)).astype(np.float32)
    grads = rng.normal(0, 0.1, (4, 2, height, width)).astype(np.float32)
    return ex, ey, et, ep, np.ones((k, c), bool), grads


def _on(dev, *arrays):
    return [torch.as_tensor(a).to(dev) for a in arrays]


def parity_worker(device=None, n_per_rank: int = 1 << 12, patches_per_rank: int = 4) -> dict:
    """One rank of the cross-process parity check, run by `launch` after
    `initialize` (the JAX package's `_mp_worker`): on a (1, n) mesh over
    every rank of the world, the sharded decode (`tiling.sharded_splat`) and
    the sharded window scan (`detector.sharded_window_scan`) against the
    one-rank computation of the same inputs on this rank's device (None: the
    card when there is one). Every rank draws the same inputs from the same
    seeds. Returns the verdict; `ok` holds the JAX package's bars (2e-4 on
    the decode, 2e-3 on the scan's costs and centres)."""
    from evo_tpu_torch.dist import tiling
    from evo_tpu_torch.kernels.splat import splat_image
    from evo_tpu_torch.tracker import align
    from evo_tpu_torch.tracker import patch_state as ps
    from evo_tpu_torch.tracker.detector import sharded_window_scan

    t_start = time.perf_counter()
    dev = resolve(device)
    n = dist.get_world_size()
    h, w = 180, 240
    m = dmesh.make_mesh(n_space=1, n_batch=n)

    rng = np.random.default_rng(0)
    x = rng.uniform(0, w - 1, n_per_rank * n).astype(np.float32)
    y = rng.uniform(0, h - 1, n_per_rank * n).astype(np.float32)
    wt = rng.choice([-1.0, 1.0], n_per_rank * n).astype(np.float32)
    t0 = time.perf_counter()
    img = tiling.sharded_splat(m, x, y, wt, h, w, device=dev)
    decode_s = time.perf_counter() - t0
    ref = splat_image(*_on(dev, x, y, wt), h, w)
    decode_err = (img - ref).abs().max().item()

    cap = patches_per_rank * n
    table = _ready_table(np.random.default_rng(1), cap, h, w)
    ex, ey, et, ep, mask, grads = _scan_inputs(np.random.default_rng(2), 2, 2048, h, w)
    events = _on(dev, ex, ey, et, ep, mask)
    g = torch.as_tensor(grads).to(dev)
    rows = slice(dmesh.block_index(m) * patches_per_rank,
                 (dmesh.block_index(m) + 1) * patches_per_rank)
    _, stacked, mirror = sharded_window_scan(
        dmesh.table_group(m), ps.table_from_numpy({k: v[rows] for k, v in table.items()}, dev),
        g, *events, g[0], mirror=("center",))
    ref_table, ref_stacked = align.process_window_scan(
        ps.table_from_numpy(table, dev), g, *events, g[0])
    scan_err = max((stacked["cost"] - ref_stacked["cost"]).abs().max().item(),
                   (mirror["center"] - ref_table.center).abs().max().item())
    return {
        "process_id": dist.get_rank(), "num_processes": n, "global_devices": n,
        "local_devices": 1, "device": str(img.device), "backend": dist.get_backend(),
        "decode_max_abs_err": decode_err, "decode_s": decode_s,
        "scan_max_abs_err": scan_err, "wall_s": time.perf_counter() - t_start,
        "ok": bool(decode_err < 2e-4 and scan_err < 2e-3),
    }


def _sub_meshes(shapes, device_type: str) -> list:
    """A (space, batch) mesh over the first n_space·n_batch ranks of the
    world for each shape, on process groups of its own; None on the ranks
    outside it. Every rank must call this (every rank creates every group)."""
    out = []
    for n_space, n_batch in shapes:
        ranks = torch.arange(n_space * n_batch).reshape(n_space, n_batch)
        out.append(dmesh.mesh_on_new_groups(ranks, device_type))
    return out


def _sync(group, dev) -> None:
    """Every rank of `group` has reached this point with its work done."""
    dist.all_reduce(torch.zeros(1, device=dev), group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_s(fn, repeats: int, dev, group=None):
    """(the least wall seconds of `repeats` calls of `fn` after one warm-up,
    each started together on the ranks of `group` and ended when the card
    is done; the last call's result)."""
    out = fn()
    best = float("inf")
    for _ in range(repeats):
        if group is not None:
            _sync(group, dev)
        elif dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def _decode_scaling(counts, dev, events_per_rank: int = 1 << 18, height: int = 180,
                    width: int = 240, repeats: int = 5) -> dict | None:
    """In a world: the sharded decode of events_per_rank·n events on (1, n)
    against one rank's splat of them all. Rank 0 returns {n: row}."""
    from evo_tpu_torch.dist import tiling
    from evo_tpu_torch.kernels.splat import splat_image

    meshes = _sub_meshes([(1, n) for n in counts], "cuda" if dev.type == "cuda" else "cpu")
    rng = np.random.default_rng(0)
    out, base = {}, None
    for n, m in zip(counts, meshes):
        n_ev = events_per_rank * n
        # the events on the device for both, as the JAX package's arrays are
        xs, ys, ws = _on(dev, rng.uniform(0, width - 1, n_ev).astype(np.float32),
                         rng.uniform(0, height - 1, n_ev).astype(np.float32),
                         rng.choice([-1.0, 1.0], n_ev).astype(np.float32))
        if m is None:
            continue
        t_shard, got = _best_s(
            lambda: tiling.sharded_splat(m, xs, ys, ws, height, width, device=dev),
            repeats, dev, m.get_group(dmesh.BATCH_AXIS))
        if dist.get_rank() != 0:
            continue
        t_single, want = _best_s(lambda: splat_image(xs, ys, ws, height, width), repeats, dev)
        err = (got - want).abs().max().item()
        thr = n_ev / t_shard / 1e6
        base = base or thr
        out[n] = {"mev_per_s": thr, "efficiency": thr / (n * base),
                  "comm_efficiency": t_single / t_shard, "ms_sharded": t_shard * 1e3,
                  "ms_single": t_single * 1e3, "max_abs_err": err}
    return out if dist.get_rank() == 0 else None


def _pipeline_scaling(counts, dev, height: int = 180, width: int = 240, repeats: int = 3,
                      patches_per_rank: int = 16, events_per_window: int = 20_000,
                      tile_events: int = 40_000, tile_iters: int = 10) -> dict | None:
    """In a world: the sharded window scan (patch rows over (1, n), events
    and gradients replicated) and the space-sharded tile solve (15 px tiles,
    a 12x16 grid, columns over (n, 1)), each against one rank doing all of
    the work. Rank 0 returns {"window_scan": {n: row}, "tile_solve": {n: row}}."""
    from evo_tpu_torch.dist import tiling
    from evo_tpu_torch.tracker import align, compensate
    from evo_tpu_torch.tracker import patch_state as ps
    from evo_tpu_torch.tracker.detector import sharded_window_scan

    kind = "cuda" if dev.type == "cuda" else "cpu"
    batch_meshes = _sub_meshes([(1, n) for n in counts], kind)
    space_meshes = _sub_meshes([(n, 1) for n in counts], kind)
    rank0 = dist.get_rank() == 0
    rng = np.random.default_rng(0)
    ex, ey, et, ep, mask, grads = _scan_inputs(rng, 4, events_per_window // 4, height, width)
    events = _on(dev, ex, ey, et, ep, mask)
    g = torch.as_tensor(grads).to(dev)
    scan = {}
    for n, m in zip(counts, batch_meshes):
        cap = patches_per_rank * n
        table = _ready_table(rng, cap, height, width)
        if m is None:
            continue
        group = m.get_group(dmesh.BATCH_AXIS)  # (1, n): all axes, in block order
        k = dmesh.block_index(m)
        local = ps.table_from_numpy(
            {f: v[k * patches_per_rank: (k + 1) * patches_per_rank] for f, v in table.items()},
            dev)

        def sharded():
            return sharded_window_scan(group, local, g, *events, g[0])[1]["cost"]

        t_shard, cost = _best_s(sharded, repeats, dev, group)
        if not rank0:
            continue
        full = ps.table_from_numpy(table, dev)

        def single():
            return align.process_window_scan(full, g, *events, g[0])[1]["cost"]

        t_single, want = _best_s(single, repeats, dev)
        scan[n] = {"patches": cap, "ms_sharded": t_shard * 1e3, "ms_single": t_single * 1e3,
                   "comm_efficiency": t_single / t_shard,
                   "cost_max_abs_err": (cost - want).abs().max().item()}

    p = compensate.CompensateParams(tile=15, max_iters=tile_iters)
    x = rng.uniform(0, width - 1, tile_events)
    y = rng.uniform(0, height - 1, tile_events)
    t_us = np.sort(rng.uniform(0, 50_000, tile_events)).astype(np.int64)
    data, edge_idx, ty, tx, _, _ = compensate.build_tile_data(x, y, t_us, p, height, width, dev)
    kw = dict(tile=p.tile, scale=p.scale, tv_weight=p.tv_weight, tv_huber=p.tv_huber,
              max_iters=p.max_iters, loss=p.loss)
    tiles = {}
    for n, m in zip(counts, space_meshes):
        if m is None:
            continue
        t_shard, (v_sh, c_sh, c0_sh) = _best_s(
            lambda: tiling.sharded_tile_solve_data(m, data, ty=ty, tx=tx, **kw),
            repeats, dev, m.get_group(dmesh.SPACE_AXIS))
        if not rank0:
            continue
        t_single, (v_1, c_1, c0_1) = _best_s(
            lambda: compensate.solve_motion_field(data, edge_idx, **kw), repeats, dev)
        tiles[n] = {"tiles": ty * tx, "ms_sharded": t_shard * 1e3, "ms_single": t_single * 1e3,
                    "comm_efficiency": t_single / t_shard,
                    "cost": [float(c_sh), float(c_1)], "cost0": [float(c0_sh), float(c0_1)],
                    "vel_max_abs_err": (v_sh - v_1).abs().max().item()}
    return {"window_scan": scan, "tile_solve": tiles} if rank0 else None


def _world_rank(tasks: dict, device, threads: int | None = None) -> dict:
    """One rank of a measuring world: runs each of `tasks` ({"parity": kw,
    "scaling": (counts, kw), "pipeline": (counts, kw)}) in that order, with
    `threads` CPU threads (None: torch's default)."""
    if threads:
        torch.set_num_threads(threads)
    dev = resolve(device)
    out = {}
    if "parity" in tasks:
        out["parity"] = parity_worker(dev, **tasks["parity"])
    if "scaling" in tasks:
        out["scaling"] = _decode_scaling(tasks["scaling"][0], dev, **tasks["scaling"][1])
    if "pipeline" in tasks:
        out["pipeline"] = _pipeline_scaling(tasks["pipeline"][0], dev, **tasks["pipeline"][1])
    return out


def measure_scaling(counts=(1, 2, 4, 8), *, device=None, backend: str | None = None,
                    timeout_s: float = 600.0, threads: int | None = None, **sizes) -> dict:
    """Weak scaling of the sharded decode over the rank counts `counts`, in
    one launched world of max(counts) ranks (device None: the card when
    there is one, one NCCL rank per card). `sizes`: events_per_rank, height,
    width, repeats; `threads`: CPU threads per rank. Returns {n: {mev_per_s,
    efficiency (throughput over n times the one-rank throughput),
    comm_efficiency (one rank's time on all the events over the sharded
    time: the collective's cost at equal work), ms_sharded, ms_single,
    max_abs_err (sharded image against the one-rank image)}}."""
    return launch(_world_rank, max(counts),
                  ({"scaling": (tuple(counts), sizes)}, device, threads),
                  device=device, backend=backend, timeout_s=timeout_s)[0]["scaling"]


def measure_scaling_pipeline(counts=(1, 2, 4, 8), *, device=None, backend: str | None = None,
                             timeout_s: float = 600.0, threads: int | None = None,
                             **sizes) -> dict:
    """comm_efficiency of the two collectives of the tracker's path beyond
    the decode, over the rank counts `counts` in one launched world:
    ``window_scan`` (patches_per_rank ready patches per rank, the table's
    rows over the ranks) and ``tile_solve`` (the contrast tile columns over
    the ranks), each against one rank doing all the work. `sizes`: height,
    width, repeats, patches_per_rank, events_per_window, tile_events,
    tile_iters; `threads`: CPU threads per rank. Rows carry the JAX
    package's keys (patches or tiles, ms_sharded, ms_single,
    comm_efficiency) and the agreement of the sharded result with the
    one-rank one."""
    return launch(_world_rank, max(counts),
                  ({"pipeline": (tuple(counts), sizes)}, device, threads),
                  device=device, backend=backend, timeout_s=timeout_s)[0]["pipeline"]


def write_scaling_artifact(path: str, *, counts=(1, 2), device=None,
                           backend: str | None = None, timeout_s: float = 900.0,
                           threads: int | None = None, scaling: dict | None = None,
                           pipeline: dict | None = None) -> dict:
    """Run `parity_worker`, `measure_scaling` and `measure_scaling_pipeline`
    in one launched world of max(counts) ranks and write them, with the
    host and card they ran on, as JSON to `path` (required: SCALING.json
    holds `evo_tpu`'s numbers and is never written here). `scaling`,
    `pipeline`: their sizes; `threads`: CPU threads per rank. Returns the
    artifact."""
    n = max(counts)
    res = launch(_world_rank, n, ({"parity": {}, "scaling": (tuple(counts), scaling or {}),
                                   "pipeline": (tuple(counts), pipeline or {})}, device, threads),
                 device=device, backend=backend, timeout_s=timeout_s)
    ranks = [r["parity"] for r in res]
    dev = resolve(device)
    artifact = {
        "backend": ranks[0]["backend"], "device": ranks[0]["device"],
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_ranks": n, "physical_cpus": os.cpu_count(),
        "note": "efficiency is weak scaling over the ranks; ranks that share a card or "
                "the host's cores bound it by that sharing, not by the collectives. "
                "comm_efficiency compares one rank doing all the work with the sharded "
                "run at equal total work.",
        "multiprocess": {"n_processes": n, "ok": all(r["ok"] for r in ranks),
                         "decode_max_abs_err": max(r["decode_max_abs_err"] for r in ranks),
                         "scan_max_abs_err": max(r["scan_max_abs_err"] for r in ranks),
                         "ranks": ranks},
        "scaling": {str(k): v for k, v in res[0]["scaling"].items()},
        "pipeline_collectives": {kind: {str(k): v for k, v in rows.items()}
                                 for kind, rows in res[0]["pipeline"].items()},
    }
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1)
    return artifact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=write_scaling_artifact.__doc__.split("\n\n")[0])
    ap.add_argument("out", help="where to write the JSON (SCALING.json is evo_tpu's)")
    ap.add_argument("--counts", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    # the workers are pickled by their import path, never as __main__'s
    mod = importlib.import_module("evo_tpu_torch.dist.multihost")
    print(json.dumps(mod.write_scaling_artifact(
        args.out, counts=tuple(args.counts), device=args.device),
        indent=1))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
