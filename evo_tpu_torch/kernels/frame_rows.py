"""The frame's update of the patch table's rows as one CUDA kernel, a block
a row: pyramidal LK of the rows just inserted, their flow initialisation,
then the border-lost check and the event budget of every live row.

Counterpart of `evo_tpu/tracker/detector.py::_lk_init_cond` over
`evo_tpu/kernels/lk.py::pyramidal_lk`, `_apply_flow_init` and
`evo_tpu/tracker/align.py::update_num_of_events` (XLA device code: the JAX
package has no Pallas kernel here). The kernel is `csrc/frame_rows.cu`
(the budget's device code shared with `csrc/align_step.cu` through
`csrc/row_budget.cuh`), built at first use by `kernels.nvcc` with
`-fmad=false`. Its entries take tensors on the card only (a CPU tensor, a
failed build or a failed launch raises); the plain version is
`tracker.detector.frame_rows_ref`, and `tracker.detector.frame_rows` picks
between the two by the table's device. `track` is LK alone, for
`kernels.lk.pyramidal_lk` on the card: the points as the new rows of a
table. A row's result depends on that row's inputs alone.
"""

from __future__ import annotations

import array
import ctypes
import threading

import torch

from evo_tpu_torch.kernels import nvcc

MAX_LEVELS = 3
# csrc/frame_rows.cu's kMaxRadius: the widest LK window whose travel slack at
# a full 64 px window (`kernels.lk`: half - radius - 1) is not negative; the
# samples of a wider one than the block's 640 threads go a few a thread
MAX_RADIUS = 31

# Launches of the kernel since the last reset
launches_frame_rows = 0
_count_lock = threading.Lock()


def reset_counts() -> None:
    global launches_frame_rows
    with _count_lock:
        launches_frame_rows = 0


def _count() -> None:
    global launches_frame_rows
    with _count_lock:
        launches_frame_rows += 1


# the table's fields the kernel reads and writes, in csrc/frame_rows.cu's
# `Args` order, with dtypes
IN_FIELDS = (("alive", torch.bool), ("initialized", torch.bool), ("center", torch.float32),
             ("warp", torch.float32), ("flow", torch.float32),
             ("time_without_update", torch.float32), ("num_of_events", torch.int32))
OUT_FIELDS = ("alive", "initialized", "warp", "flow", "time_without_update", "num_of_events")
DIAGNOSTICS = ("lk_flow", "lk_status", "lk_trips", "lk_d2")
# the entry's pointer array, in the order of `Args`
POINTERS = ([n for n, _ in IN_FIELDS] + [f"prev{k}" for k in range(MAX_LEVELS)]
            + [f"cur{k}" for k in range(MAX_LEVELS)] + ["grad"]
            + [f + "_out" for f in OUT_FIELDS] + list(DIAGNOSTICS) + ["clocks"])
# the clock build's stages, in csrc/frame_rows.cu's `Stage` order
STAGES = ("windows", "template", "sampling", "sums", "budget", "write", "total")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # the address of the pointer array, P, H, W, levels, radius, iters, with_lk, stream
    "evo_frame_rows": ([_P] + [_I] * 7 + [_P], _I),
}
_libs: dict[bool, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _lib(clocks: bool = False):
    """The compiled kernel (built from csrc/frame_rows.cu at first use); with
    `clocks`, its clock build (-DEVO_FR_CLOCKS), a library of its own."""
    with _lib_lock:
        if clocks not in _libs:
            name, flags = "evo_frame_rows", ("-fmad=false",)
            if clocks:
                name, flags = name + "_clock", flags + ("-DEVO_FR_CLOCKS",)
            _libs[clocks] = nvcc.load(name, ["frame_rows.cu"], _SIGNATURES, extra_flags=flags,
                                      headers=("row_budget.cuh",))
        return _libs[clocks]


def _check_levels(pyr, what: str, dev) -> None:
    if not 1 <= len(pyr) <= MAX_LEVELS:
        raise ValueError(f"{what} has {len(pyr)} levels: the kernel tracks 1 to {MAX_LEVELS}")
    h, w = pyr[0].shape
    for k, t in enumerate(pyr):
        if t.shape != (h, w) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"{what}[{k}] must be a contiguous float32 [{h}, {w}] on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        h, w = (h + 1) // 2, (w + 1) // 2


def run(fn, launch, p: int, ptrs: dict, h: int, w: int, levels: int, radius: int,
        num_iters: int, with_lk: bool) -> None:
    """Pack `ptrs` (name -> address, absent = null) in `POINTERS` order and
    `launch(fn, its address, P, H, W, levels, radius, iters, with_lk)`."""
    packed = array.array("Q", [ptrs.get(n, 0) for n in POINTERS])
    launch(fn, packed.buffer_info()[0], p, h, w, levels, radius, num_iters, int(with_lk))


def _outputs(p: int, dev, diagnostics: bool) -> dict:
    """The table's new fields and, if asked for, LK's diagnostics, in one
    allocation: float32 (warp, flow, time_without_update, lk_flow, lk_d2),
    then int32 (num_of_events, lk_trips), then bytes (alive, initialized,
    lk_status)."""
    floats = [("warp", (p, 4)), ("flow", (p,)), ("time_without_update", (p,))]
    ints = [("num_of_events", (p,))]
    bools = ["alive", "initialized"]
    if diagnostics:
        floats += [("lk_flow", (p, 2)), ("lk_d2", (p, MAX_LEVELS))]
        ints += [("lk_trips", (p, MAX_LEVELS))]
        bools += ["lk_status"]
    n_f = sum(int(torch.Size(s).numel()) for _, s in floats)
    n_i = sum(int(torch.Size(s).numel()) for _, s in ints)
    words = n_f + n_i + (len(bools) * p + 3) // 4
    arena = torch.empty(words, dtype=torch.float32, device=dev)
    out, at = {}, 0
    for name, shape in floats:
        n = int(torch.Size(shape).numel())
        out[name] = arena[at:at + n].view(shape)
        at += n
    ints_view = arena[at:at + n_i].view(torch.int32)
    k = 0
    for name, shape in ints:
        n = int(torch.Size(shape).numel())
        out[name] = ints_view[k:k + n].view(shape)
        k += n
    at += n_i
    byte_view = arena[at:].view(torch.uint8)
    for j, name in enumerate(bools):
        out[name] = byte_view[j * p:(j + 1) * p].view(torch.bool)
    return out


def frame_rows(table, prev_pyr, cur_pyr, grad, *, with_lk: bool, radius: int = 10,
               num_iters: int = 30, diagnostics: bool = False, clocks=None):
    """One launch over the rows of `table` (a `tracker.patch_state.PatchTable`
    on the card): with `with_lk`, LK of the rows alive and not initialized
    from the previous frame's pyramid `prev_pyr` to this frame's `cur_pyr`
    (level 0 first) and their flow initialisation; then the border-lost
    check and the budget of every live row against the gradient pair grad
    [2, H, W]. Returns the table with its new fields (the input is not
    written) and, with `diagnostics`, a dict of LK's flow [P, 2] (0 where
    not tracked), status [P], trips and last |dv|^2 by level [P, 3] (level
    0 first). `clocks`, an int64 [P, len(STAGES)] tensor on the card,
    launches the clock build instead, which writes each row's cycles by stage
    there (the main path never passes it)."""
    dev = table.center.device
    if dev.type != "cuda":
        raise RuntimeError(
            f"frame_rows has no kernel for device {dev}: the plain version is "
            "tracker.detector.frame_rows_ref (tracker.detector.frame_rows picks it for a "
            "table on the CPU)")
    out = run_rows(_lib(clocks is not None).evo_frame_rows,
                   lambda fn, *args: nvcc.launch(fn, table.center, *args), table, prev_pyr,
                   cur_pyr, grad, with_lk=with_lk, radius=radius, num_iters=num_iters,
                   diagnostics=diagnostics, clocks=clocks)
    _count()
    return out


def run_rows(fn, launch, table, prev_pyr, cur_pyr, grad, *, with_lk: bool, radius: int,
             num_iters: int, diagnostics: bool, clocks=None):
    """`frame_rows` through the C entry `fn` and `launch(fn, *args)`, after
    the checks: the tensors on one device, of the kernel's types and
    shapes; `clocks` an int64 [P, len(STAGES)] tensor for the clock build,
    or None."""
    dev = table.center.device
    p = table.capacity
    ins = {}
    for name, dtype in IN_FIELDS:
        t = getattr(table, name)
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev or t.shape[0] != p:
            raise ValueError(f"table.{name} must be contiguous {dtype} [{p}, ...] on {dev}")
        ins[name] = t.data_ptr()
    h, w = grad.shape[1:]
    if grad.shape[0] != 2 or grad.dtype != torch.float32 or not grad.is_contiguous() \
            or grad.device != dev:
        raise ValueError(f"grad must be a contiguous float32 [2, H, W] on {dev}")
    if h < 64 or w < 64:
        raise ValueError(f"the image {(h, w)} is smaller than the 64 x 64 gradient window")
    levels = 1
    if with_lk:
        _check_levels(prev_pyr, "prev_pyr", dev)
        _check_levels(cur_pyr, "cur_pyr", dev)
        levels = len(cur_pyr)
        if len(prev_pyr) != levels or cur_pyr[0].shape != (h, w) \
                or prev_pyr[0].shape != (h, w):
            raise ValueError("the two pyramids must have the gradient pair's size and depth")
        if not 0 <= radius <= MAX_RADIUS:
            raise ValueError(f"the kernel tracks with a radius of 0 to {MAX_RADIUS}, not {radius}")
        for k in range(levels):
            ins[f"prev{k}"] = prev_pyr[k].data_ptr()
            ins[f"cur{k}"] = cur_pyr[k].data_ptr()
    ins["grad"] = grad.data_ptr()
    outs = _outputs(p, dev, diagnostics)
    ins.update({f"{n}_out": outs[n].data_ptr() for n in OUT_FIELDS})
    if diagnostics:
        ins.update({n: outs[n].data_ptr() for n in DIAGNOSTICS})
    if clocks is not None:
        if clocks.dtype != torch.int64 or clocks.shape != (p, len(STAGES)) \
                or not clocks.is_contiguous() or clocks.device != dev:
            raise ValueError(f"clocks must be a contiguous int64 [{p}, {len(STAGES)}] on {dev}")
        ins["clocks"] = clocks.data_ptr()
    run(fn, launch, p, ins, h, w, levels, radius, num_iters, with_lk)
    new = table.replace(**{n: outs[n] for n in OUT_FIELDS})
    if diagnostics:
        return new, {n: outs[n] for n in DIAGNOSTICS}
    return new


def points_table(pts, valid, shape):
    """LK alone as `frame_rows`' table: a table whose rows are the points pts
    [N, 2] (x, y), alive where `valid` and none initialized, and a zero
    gradient pair [2, *shape] for its budget, on the points' device."""
    from evo_tpu_torch.tracker import patch_state as ps

    table = ps.empty_table(pts.shape[0], 1, device=pts.device)
    table = table.replace(alive=valid.to(torch.bool).contiguous(),
                          center=pts.to(torch.float32).contiguous())
    return table, torch.zeros((2, *shape), dtype=torch.float32, device=pts.device)


def track(pyr0, pyr1, pts, valid, *, radius: int = 10, num_iters: int = 30,
          diagnostics: bool = False):
    """LK alone, one `frame_rows` launch: points pts [N, 2] (x, y) with
    `valid` [N] tracked from pyramid pyr0 to pyr1 (level 0 first) on the
    card (`points_table`). Returns (flow [N, 2], status [N] bool): flow 0
    and status False where not valid (and the diagnostics dict with
    `diagnostics`)."""
    table, grad = points_table(pts, valid, pyr0[0].shape)
    _, diag = frame_rows(table, pyr0, pyr1, grad, with_lk=True, radius=radius,
                         num_iters=num_iters, diagnostics=True)
    out = (diag["lk_flow"], diag["lk_status"])
    return (*out, diag) if diagnostics else out
