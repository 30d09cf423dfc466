"""VO's windowed bundle adjustment as one CUDA kernel, one launch a call.

Counterpart of `evo_tpu/vo/ba.py::ba_solve` (one jitted XLA program in the
JAX package, its LM a `lax.while_loop`; no Pallas kernel):
`csrc/ba_solve.cu`, built at first use by `kernels.nvcc` with
`-fmad=false`, runs every LM trip of the solve in one thread-block cluster
(`CLUSTER` blocks of `THREADS` threads; rank 0 factors the reduced system
in its shared memory) on the card and writes the result; the host reads
nothing until then. The result's bits do not depend on the block's or the
cluster's size. The plain
version is `vo.ba.ba_solve_ref`; `vo.ba.ba_solve` picks between the two by
the tensors' device. Tensors on the card only: a CPU tensor raises here, as
does a failed build or launch. `ba_solve(..., clocks=True)` launches the
clock build (-DEVO_BA_CLOCKS, a library of its own), which writes the
launch's clock64() cycles by stage (`STAGES`, summed over the trips); the
main path never launches it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from evo_tpu_torch.kernels import nvcc

# 256 threads a block leave a thread 255 registers (512: 128, and the
# kernel spills); the cluster's 16 blocks (beyond the portable 8) keep its
# 4,096 threads
THREADS = 256
# blocks of the launch's one cluster (up to 16)
CLUSTER = 16
# the reduced system [6 F, 6 F] lies in shared memory: 227 KB take F = 39
MAX_FRAMES = 39

# launches since the last reset, under a lock (VO may run on its own thread)
launches_ba = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_ba
    with _count_lock:
        launches_ba = 0


def _count() -> None:
    global launches_ba
    with _count_lock:
        launches_ba += 1


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # the largest block the build takes
    "evo_ba_max_threads": ([], _I),
    # F, L, O -> the scratch's floats and ints
    "evo_ba_scratch": ([_I] * 3 + [_P] * 2, None),
    # poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask,
    # pose_fixed, the three orders and their starts, F, L, O, num_iters,
    # compensated, huber, 2 huber, huber², tol, float scratch, int scratch,
    # poses', landmarks', costs, iters, clocks, threads, cluster, stream
    "evo_ba_solve": ([_P] * 14 + [_I] * 5 + [_D] * 4 + [_P] * 7 + [_I, _I, _P], _I),
}
# the clock build's stages, in csrc/ba_solve.cu's `Stage` order (each
# trip's stages summed over the trips)
STAGES = ("setup", "linearize", "slot_sums", "inverses_t", "schur", "factor", "solves", "step",
          "cost", "decide", "total")


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/ba_solve.cu at first use); with
    `clocks`, its clock build (-DEVO_BA_CLOCKS)."""
    name, flags = "evo_ba_solve", ("-fmad=false",)
    if clocks:
        name, flags = name + "_clock", flags + ("-DEVO_BA_CLOCKS",)
    return nvcc.load(name, ["ba_solve.cu"], _SIGNATURES, extra_flags=flags,
                     headers=("vo_geometry.cuh",))


_top: dict = {}


def _max_threads(lib) -> int:
    """The largest block `lib` takes (`evo_ba_max_threads`), read once a
    library."""
    if lib not in _top:
        _top[lib] = lib.evo_ba_max_threads()
    return _top[lib]


class BaResult(tuple):
    """(poses', landmarks', cost, cost0, iterations), views of one arena on
    the card; `packed` is the one block that holds them all, in that order
    (the iterations an int32 in the last float's place), for one read."""

    packed: torch.Tensor


def run(lib, launch, poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed,
        orders, *, num_iters: int, huber: float, compensated: bool, tol: float,
        threads: int = THREADS, cluster: int = CLUSTER, clocks: bool = False):
    """Check the inputs, allocate the outputs and the scratch in one arena on
    the poses' device (sized by `lib.evo_ba_scratch`) and call
    `launch(*the entry's arguments but the stream)`. `orders` are the three
    `SegmentSum`s of `vo.ba.observation_orders` for these observations and
    `compensated`: the kernel sums each slot in their order. Returns (poses',
    landmarks', cost, cost0, iterations), the last three 0-dim tensors, and
    with `clocks` an int64 [len(STAGES)] for the clock build's cycles."""
    dev = poses.device
    f, l, o = poses.shape[0], landmarks.shape[0], obs_frame.shape[0]
    want = dict(poses=(poses, (f, 7), torch.float32), landmarks=(landmarks, (l, 3), torch.float32),
                intr=(intr, (9,), torch.float32), obs_frame=(obs_frame, (o,), torch.int64),
                obs_lm=(obs_lm, (o,), torch.int64), obs_p2d=(obs_p2d, (o, 2), torch.float32),
                obs_mask=(obs_mask, (o,), torch.bool), pose_fixed=(pose_fixed, (f,), torch.bool))
    for k, (seg, n) in enumerate(zip(orders, (f, l, l * f))):
        want[f"order {k}"] = (seg.order, (o,), torch.int64)
        want[f"starts {k}"] = (seg.starts, (n + 2,), torch.int64)
    for name, (a, shape, dtype) in want.items():
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, not {shape}")
        if not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name} must be contiguous on {dev}")
    if not 1 <= f <= MAX_FRAMES or l < 1 or o < 1:
        raise ValueError(f"{f} frames (1 to {MAX_FRAMES}), {l} landmarks, {o} observations")
    top = _max_threads(lib)
    if not 64 <= threads <= top or threads % 32:
        raise ValueError(f"{threads} threads: a multiple of 32 from 64 to {top}")
    if not 1 <= cluster <= 16:
        raise ValueError(f"a cluster of {cluster} blocks: 1 to 16")
    n_float, n_int = ctypes.c_int(), ctypes.c_int()
    lib.evo_ba_scratch(f, l, o, ctypes.byref(n_float), ctypes.byref(n_int))
    n_out = f * 7 + l * 3 + 2
    # the float scratch first: its float64 part wants the arena's alignment
    arena = torch.empty(n_float.value + n_out + 1 + n_int.value, dtype=torch.float32, device=dev)
    fs, out, ints = arena.split_with_sizes([n_float.value, n_out, 1 + n_int.value])
    ints = ints.view(torch.int32)
    h = float(huber)
    clk = torch.zeros(len(STAGES), dtype=torch.int64, device=dev) if clocks else None
    launch(poses.data_ptr(), landmarks.data_ptr(), intr.data_ptr(), obs_frame.data_ptr(),
           obs_lm.data_ptr(), obs_p2d.data_ptr(), obs_mask.data_ptr(), pose_fixed.data_ptr(),
           *[x.data_ptr() for seg in orders for x in (seg.order, seg.starts)],
           f, l, o, int(num_iters), int(bool(compensated)), h, 2.0 * h, h * h, float(tol),
           fs.data_ptr(), ints[1:].data_ptr(), out.data_ptr(), out[f * 7:].data_ptr(),
           out[n_out - 2:].data_ptr(), ints.data_ptr(), 0 if clk is None else clk.data_ptr(),
           threads, cluster)
    costs = out[n_out - 2:]
    res = BaResult((out[:f * 7].view(f, 7), out[f * 7:n_out - 2].view(l, 3), costs[0], costs[1],
                    ints[0]))
    # out and the int scratch lie side by side: the iterations right after the costs
    res.packed = arena[n_float.value:n_float.value + n_out + 1]
    return (*res, clk) if clocks else res


def ba_solve(poses, landmarks, intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed, orders, *,
             num_iters: int, huber: float, compensated: bool, tol: float,
             clocks: bool = False):
    """`vo.ba.ba_solve` on the card, one launch: poses [F, 7], landmarks
    [L, 3], intr [9], obs_p2d [O, 2] float32, obs_frame / obs_lm [O] int64,
    obs_mask [O] and pose_fixed [F] bool, `orders` from
    `vo.ba.observation_orders`. Returns (poses', landmarks', cost, cost0,
    iterations), the last three 0-dim tensors on the card; with `clocks`,
    the clock build's launch, and its cycles by stage after them. One
    cluster of `CLUSTER` blocks."""
    dev = poses.device
    if dev.type != "cuda":
        raise RuntimeError(f"ba_solve has no kernel for device {dev}: the plain version is "
                           "vo.ba.ba_solve_ref")
    lib = _lib(clocks)
    out = run(lib, lambda *args: nvcc.launch(lib.evo_ba_solve, poses, *args), poses, landmarks,
              intr, obs_frame, obs_lm, obs_p2d, obs_mask, pose_fixed, orders,
              num_iters=num_iters, huber=huber, compensated=compensated, tol=tol, clocks=clocks,
              cluster=CLUSTER)
    _count()
    return out
